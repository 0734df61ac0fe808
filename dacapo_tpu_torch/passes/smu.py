"""Scale Management Unit (SMU) analysis (copy of dacapo_tpu/passes/smu.py).

Port of lib/Dialect/Earth/Analysis/ScaleManagementUnit.cpp: partitions SSA
values into groups that must share (scale, level) under any legal scale
management, via fixed-point forward/backward congruence splitting with
consume (mul) separation and the sub-key-expansion merge for chained
non-consume ops. Also computes SMU-crossing edges (the bootstrap candidate
edges DaCapo optimizes over) and noisy-group marking (rotate ⇒ noisy,
driving the SNR +4-bit waterline, Common.cpp:170-185).

Like the reference, the analysis only runs on pre-management IR: upscale /
rescale / modswitch / bootstrap ops are asserted absent
(ScaleManagementUnit.cpp:59-66).
"""

from ..ir.earth import Function

_MGMT = ("upscale", "rescale", "modswitch", "bootstrap")


class _Builder:
    def __init__(self, fn: Function):
        self.fn = fn
        # valueSet: (value, isConsume) in program order
        self.values = []
        for a in fn.args:
            self.values.append((a, False))
        for op in fn.ops:
            assert op.opcode not in _MGMT, "SMU on managed IR is unsupported"
            self.values.append((op.result, op.is_consume()))
        self.ids = {v: 0 for v, _ in self.values}
        # users: value -> list of user ops (None stands for func return)
        self.users = {v: [] for v, _ in self.values}
        for op in fn.ops:
            for o in op.operands:
                self.users[o].append(op)
        for r in fn.returns:
            self.users[r].append(None)
        self.id_max = 1
        self.build()

    def get_id(self, v):
        return self.ids.get(v, -1)

    def _op_id(self, op):
        if op is None:
            return -1
        return self.ids.get(op.result, -1)

    def _def_key(self, v, forward):
        if forward:
            if v.is_arg:
                return frozenset()
            return frozenset(self.get_id(o) for o in v.def_op.operands)
        return frozenset(self._op_id(u) for u in self.users[v])

    def build(self):
        id_count = -1
        id_set = {0}
        while id_count != len(id_set):
            id_count = len(id_set)
            for forward in (True, False):
                self.origin = {}
                self.definition = {}
                self.consume_def = {}
                self.maps = {}  # (isConsume, forward) -> {(nid, key): id}
                seq = self.values if forward else list(reversed(self.values))
                for v, isc in seq:
                    self._define(v, isc, forward)
                for v, isc in seq:
                    self._look(v, isc, forward)
            id_set = set(self.ids.values())

    def _define(self, v, isc, forward):
        nid = self.get_id(v)
        cmap = self.maps.setdefault((isc, forward), {})
        if nid not in self.definition:
            d = self._def_key(v, forward)
            self.consume_def[nid] = isc
            self.definition[nid] = d
            cmap[(nid, d)] = nid

    def _look(self, v, isc, forward):
        nid = self.get_id(v)
        d = self._def_key(v, forward)
        cmap = self.maps.setdefault((isc, forward), {})
        # sub-key expansion (associativity merge for non-consume chains)
        for defi in d:
            if (defi == nid or self.origin.get(defi) == nid) and not self.consume_def.get(defi, False):
                subkey = d - {defi}
                dd = self.definition.get(defi, frozenset())
                if subkey <= dd:
                    d = dd
                    break
        key = (nid, d)
        if key in cmap:
            self.ids[v] = cmap[key]
        else:
            cmap[key] = self.id_max
            self.definition[self.id_max] = d
            self.consume_def[self.id_max] = isc
            self.origin[self.id_max] = nid
            self.ids[v] = self.id_max
            self.id_max += 1


class ScaleManagementUnit:
    def __init__(self, fn: Function):
        self.fn = fn
        values = list(fn.args) + [
            op.result for op in fn.ops if op.opcode not in _MGMT
        ]
        if fn.attrs.get("smu_attached"):
            self.ids = {}
            id_num = 0
            from .scale import get_value_attr
            for v in values:
                i = get_value_attr(fn, v, "smu", -1)
                self.ids[v] = i
                id_num = max(i + 1, id_num)
        else:
            b = _Builder(fn)
            remap = {}
            for v in values:
                remap.setdefault(b.get_id(v), len(remap))
            self.ids = {v: remap[b.get_id(v)] for v in values}
            id_num = len(remap)
        self.id_num = id_num

        self.noisy = [False] * id_num
        for v, i in self.ids.items():
            if i >= 0 and not v.is_arg and v.def_op.opcode == "rotate":
                self.noisy[i] = True

        self.id_to_values = [[] for _ in range(id_num)]
        for v, i in self.ids.items():
            if i >= 0:     # -1 = management-inserted value (attached mode)
                self.id_to_values[i].append(v)

        # edges: (operand_id, user_id) over SMU-crossing uses;
        # edge_to_oper[e] = list of (user_op, operand_index)
        self._users = {v: [] for v in self.ids}
        for op in fn.ops:
            for k, o in enumerate(op.operands):
                if o in self._users:
                    self._users[o].append((op, k))
        edge_map = {}
        self.edges = {}     # (op, operand_index) -> edge id
        for v in values:
            for (uop, k) in self._users[v]:
                to_id = self.get_id(uop.result)
                if self.get_id(v) == to_id:
                    continue
                key = (self.get_id(v), to_id)
                e = edge_map.setdefault(key, len(edge_map))
                self.edges[(id(uop), k)] = e
        self.edge_to_oper = [[] for _ in range(len(edge_map))]
        for op in fn.ops:
            for k in range(len(op.operands)):
                e = self.edges.get((id(op), k))
                if e is not None:
                    self.edge_to_oper[e].append((op, k))
        self.edge_num = len(edge_map)

    def get_id(self, v):
        return self.ids.get(v, -1)

    def get_edge(self, op, operand_index):
        return self.edges.get((id(op), operand_index), -1)

    def in_noisy_group(self, v):
        i = self.get_id(v)
        return bool(self.noisy[i]) if i >= 0 else False

    def first_user(self, v):
        """For calcWaterline's backward chase over mgmt-op results."""
        for op in self.fn.ops:
            if v in op.operands:
                return op.result
        return None

    def attach(self):
        """Embed smu ids as value attrs so clones preserve the analysis
        (ScaleManagementUnit attach/detach)."""
        from .scale import set_value_attr
        for v, i in self.ids.items():
            set_value_attr(self.fn, v, "smu", i)
        self.fn.attrs["smu_attached"] = True

    def detach(self):
        from .scale import set_value_attr
        for v in self.ids:
            set_value_attr(self.fn, v, "smu", -1)
        self.fn.attrs["smu_attached"] = False

    def verify(self):
        """SMUChecker post-management invariant (SMUChecker.cpp:44-96):
        every group shares (scale, level). Management-inserted values
        (id -1) are skipped like the reference's `if (ID == -1) return`."""
        for vals in self.id_to_values:
            tys = {(v.ty.scale, v.ty.level) for v in vals}
            if len(tys) > 1:
                return False
        return True

    def verify_definitions(self):
        """Full pre-management verify (ScaleManagementUnit.cpp:372-507):

        1. the (scale, level) invariant of verify();
        2. consumeness is constant within a group;
        3. every value of a group has the SAME forward definition (set of
           operand group-ids, self-edges expanded through the group's
           canonical definition; consuming groups may not have self-edges)
           and the same backward definition (over users, -1 = func return);
        4. (fwd, bwd, consumeness) definitions are UNIQUE across groups —
           two groups with identical definitions should have been merged.
        """
        if not self.verify():
            return False
        fn = self.fn
        for op in fn.ops:
            if op.opcode in _MGMT:
                return False          # managed IR unsupported (reference parity)
        values = list(fn.args) + [op.result for op in fn.ops]

        consume = {}
        for v in values:
            isc = (not v.is_arg) and v.def_op.is_consume()
            if consume.setdefault(self.get_id(v), isc) != isc:
                return False
        fwd = {}
        for v in values:
            vid = self.get_id(v)
            d = set()
            if not v.is_arg:
                for o in v.def_op.operands:
                    oid = self.get_id(o)
                    if oid == vid:
                        if consume[vid] or oid not in fwd:
                            return False   # consuming self-edge / use-before-def
                        d |= fwd[oid]      # self-edge replaced by canonical def
                    else:
                        d.add(oid)
            if fwd.setdefault(vid, d) != d:
                return False               # definition mismatch within group
        vusers = {v: [] for v in values}
        for op in fn.ops:
            for o in op.operands:
                if o in vusers:
                    vusers[o].append(op)
        for r in fn.returns:
            vusers[r].append(None)         # func return = user id -1
        bwd = {}
        for v in reversed(values):
            vid = self.get_id(v)
            d = set()
            for uop in vusers[v]:
                uid = -1 if uop is None else self.get_id(uop.result)
                if uid == vid:
                    if consume[vid] or uid not in bwd:
                        return False
                    d |= bwd[uid]
                else:
                    d.add(uid)
            if bwd.setdefault(vid, d) != d:
                return False
        seen = set()
        for i in range(self.id_num):
            key = (frozenset(fwd.get(i, ())), frozenset(bwd.get(i, ())),
                   consume.get(i, False))
            if key in seen:
                return False               # duplicated definition
            seen.add(key)
        return True
