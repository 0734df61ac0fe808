"""DaCapo automatic bootstrap placement (copy of dacapo_tpu/passes/dacapo.py).

Ports, over the python Earth IR:
* CandidateAnalysis (lib/Dialect/Earth/Analysis/CandidateAnalysis.cpp):
  opid numbering, live-out sets at SMU-crossing edges, dead-value tracking,
  bypass-edge logic, the toFromMap coverage pruning for the DP.
* BypassDetection (Transforms/BypassDetection.cpp:37-136): per-edge PARS
  simulation with bootstraps placed at the edge's live-outs, recording the
  threshold opid where accumulated scale crosses `threshold`.
* CandidateSelection (CandidateSelection.cpp:33-62): smallest live-out set
  size whose placement compiles (PARS succeeds as a feasibility probe).
* DaCapoPlanner (DaCapoPlanner.cpp:39-219): shortest-path DP over candidate
  cut points; each (from, to) edge runs BootstrapPlacement ->
  CodeSegmentation -> PARS -> EarlyModswitch -> canonicalize/CSE ->
  LatencyEstimator on a clone; coverage via CoverageRecorder
  (CoverageRecorder.cpp:35-101).
* BootstrapPlacement / CodeSegmentation / RemoveBootstrap.
"""

import math
from dataclasses import dataclass, field

from ..ir.config import current_config
from ..ir.earth import Function, Op, ScaleType, infer_type
from .smu import ScaleManagementUnit
from .scale import (
    _Walk, _process_operands, _process_results, TypeInferenceError,
    proactive_rescaling,
)
from .hoist import early_modswitch
from .rewrite import canonicalize, cse, dce
from .estimator import latency_estimator

_MGMT = ("upscale", "rescale", "modswitch", "bootstrap")


# ----------------------------------------------------------- small helpers

def attach_opid(fn: Function):
    """Common.cpp:150-168: opids over non-management ops; index 0 unused."""
    values = [None]
    for op in fn.ops:
        if op.opcode in _MGMT:
            continue
        op.attrs["opid"] = len(values)
        values.append(op.result)
    return values


def remove_bootstrap(fn: Function):
    """RemoveBootstrap.cpp:24-31: strip user-written bootstraps."""
    subst = {}
    new_ops = []
    for op in fn.ops:
        op.operands = [subst.get(v, v) for v in op.operands]
        if op.opcode == "bootstrap":
            subst[op.result] = op.operands[0]
        else:
            new_ops.append(op)
    fn.ops = new_ops
    fn.returns = [subst.get(v, v) for v in fn.returns]
    return fn


def bootstrap_placement(fn: Function, cfg=None):
    """BootstrapPlacement.cpp:33-56: materialize earth.bootstrap after each
    opid in fn.attrs['btp_target'] (cipher values only)."""
    values = attach_opid(fn)
    targets = [t for t in fn.attrs.get("btp_target", []) if t < len(values)]
    if not targets:
        return fn
    tset = set(targets)
    subst = {}
    new_ops = []
    boots = {}
    for op in fn.ops:
        op.operands = [subst.get(v, v) for v in op.operands]
        new_ops.append(op)
        opid = op.attrs.get("opid", -1)
        if opid in tset and op.ty.is_cipher:
            btp = Op("bootstrap", [op.result],
                     {"targetLevel": 0, "opid": opid}, op.ty.switch_level(0), op.loc)
            new_ops.append(btp)
            subst[op.result] = btp.result
            boots[opid] = btp
    fn.ops = new_ops
    fn.returns = [subst.get(v, v) for v in fn.returns]
    return fn


def _mul_acc(op, cfg):
    t = op.ty
    return t.scale + t.level * cfg.rescaling_factor


def over_threshold(op, cfg, thr):
    if op.opcode != "mul":
        return False
    return _mul_acc(op, cfg) > cfg.bootstrap_level_upper * cfg.rescaling_factor * thr


def is_validated(op, cfg):
    if op.opcode != "mul":
        return True
    return _mul_acc(op, cfg) < cfg.bootstrap_level_upper * cfg.rescaling_factor


def is_bootstrappable(op, cfg):
    if op.opcode != "mul":
        return True
    rf = cfg.rescaling_factor
    return _mul_acc(op, cfg) < (
        cfg.bootstrap_level_upper - cfg.bootstrap_level_lower + 1) * rf


def _sim_pars_walk(fn: Function, waterline, from_opid, cfg, on_op):
    """PARS simulation from `from_opid` (BypassDetection/CoverageRecorder
    inner walk): ops before the cut (except bootstraps) are skipped; `on_op`
    may return "break" to stop."""
    w = _Walk(fn, cfg)
    for op in fn.ops:
        op.operands = [w.subst.get(v, v) for v in op.operands]
        opid = op.attrs.get("opid", -1)
        if op.opcode != "bootstrap" and opid < from_opid:
            w.new_ops.append(op)
            continue
        if op.opcode != "constant":
            _process_operands(w, op, "pars", waterline)
            ty = infer_type(op, cfg)
            if ty is None:
                raise TypeInferenceError(op.opcode)
            op.set_ty(ty)
        else:
            op.set_ty(ScaleType(False, 0, 0))
        w.new_ops.append(op)
        _process_results(w, op, "pars", waterline)
        if on_op(op, opid) == "break":
            break
    fn.ops = w.new_ops


# ----------------------------------------------------- segment extraction

def extract_segment(fn: Function, ca, frm, to, segment_input, input_tys,
                    btp_targets, segment_return, cfg):
    """Directly build the [frm, to] segment function.

    Equivalent to the reference's clone -> BootstrapPlacement ->
    CodeSegmentation chain (DaCapoPlanner.cpp:68-85) but O(segment) instead
    of O(|function|): the DP runs this per candidate edge, so whole-function
    clones dominated compile time (ResNet: 18.7k ops x thousands of edges).

    * args = original fn.args + one arg per `segment_input` opid, typed by
      `input_tys` (orig-arg types first, mirroring the DP's segment_inputType
      layout).
    * each cipher arg whose opid is in `btp_targets` gets an earth.bootstrap
      preamble op (BootstrapPlacement semantics at the cut).
    * ops with opid in (frm, to] are cloned; plain-producing defs before the
      cut (constants and folded plaintext chains) are pulled in recursively.
    * returns = segment_return opids (bootstrap results preferred); empty
      segment_return keeps the original returns (tail segment).
    """
    from ..ir.earth import Value

    n_ops = len(fn.ops)
    lo = max(0, frm)                      # opid i <-> fn.ops[i-1]
    hi = min(to, n_ops)
    tset = set(btp_targets)

    vmap = {}
    args = []
    for a in fn.args:
        na = Value(a.ty, arg_index=a.arg_index)
        vmap[a] = na
        args.append(na)
    new_ops = []
    boots = {}
    for opid, tyj in zip(segment_input, input_tys[len(fn.args):]):
        src = fn.ops[opid - 1].result
        arg = Value(ScaleType(bool(tyj[0]), tyj[1], tyj[2]),
                    arg_index=len(args))
        args.append(arg)
        vmap[src] = arg
        if opid in tset and src.ty.is_cipher:
            btp = Op("bootstrap", [arg], {"targetLevel": 0, "opid": opid},
                     arg.ty.switch_level(0), fn.ops[opid - 1].loc)
            new_ops.append(btp)
            vmap[src] = btp.result
            boots[opid] = btp.result

    def pull_plain(v):
        """Clone a pre-cut non-cipher def chain (constants, folded plains)."""
        if v in vmap:
            return vmap[v]
        dop = v.def_op
        nop = Op(dop.opcode, [pull_plain(x) for x in dop.operands],
                 dict(dop.attrs), dop.ty, dop.loc)
        new_ops.append(nop)
        vmap[v] = nop.result
        return nop.result

    pulled_at = len(new_ops)
    body = []
    for i in range(lo, hi):
        op = fn.ops[i]
        opers = []
        for v in op.operands:
            m = vmap.get(v)
            if m is None:
                assert not v.ty.is_cipher, (
                    f"cipher value (opid {v.def_op.attrs.get('opid')}) "
                    f"crosses cut {frm} outside live-outs")
                m = pull_plain(v)
            opers.append(m)
        nop = Op(op.opcode, opers, dict(op.attrs), op.ty, op.loc)
        vmap[op.result] = nop.result
        body.append(nop)
        opid = i + 1
        if opid in tset and op.ty.is_cipher:
            btp = Op("bootstrap", [nop.result],
                     {"targetLevel": 0, "opid": opid},
                     nop.ty.switch_level(0), op.loc)
            body.append(btp)
            vmap[op.result] = btp.result
            boots[opid] = btp.result

    # plain pulls must precede their users: they were appended to new_ops
    # during body construction but belong before it; splice stable.
    preamble, pulls = new_ops[:pulled_at], new_ops[pulled_at:]
    ops = preamble + pulls + body

    if segment_return:
        returns = [boots.get(r, vmap[fn.ops[r - 1].result])
                   for r in segment_return]
        mid = True
    else:
        # tail segment: returns defined inside the slice (or original args)
        returns = [vmap.get(v, v) for v in fn.returns]
        mid = False

    seg = Function(fn.name, args, ops, returns, {})
    seg.attrs["cutted_edge"] = [frm, to]
    seg.attrs["segment_input"] = list(segment_input)
    seg.attrs["segment_inputType"] = list(input_tys)
    seg.attrs["is_mid_segment"] = mid
    dce(seg)
    return seg


# ----------------------------------------------------------- value info

@dataclass
class ValueInfo:
    opid: int
    value: object = None
    live_outs: list = field(default_factory=list)
    live_ins: list = field(default_factory=list)
    dead_opid: int = -1
    boot_coverage: int = -1
    coverage: int = -1
    threshold_opid: int = 2 ** 62
    valid_live_outs: list = field(default_factory=list)


class CandidateAnalysis:
    """CandidateAnalysis.cpp:9-58 + helpers."""

    def __init__(self, fn: Function):
        self.fn = fn
        self.smu = ScaleManagementUnit(fn)
        self.smu.attach()
        self.values = [ValueInfo(0)]
        self.edges = [0]
        self.users = {}
        for op in fn.ops:
            for v in op.operands:
                self.users.setdefault(v, []).append(op)

        # liveness: last use index over the full op list
        last_use = {}
        for i, op in enumerate(fn.ops):
            for v in op.operands:
                last_use[v] = i
        for v in fn.returns:
            last_use[v] = len(fn.ops) + 1

        live_out = []
        live_in = []
        opid_of = {}
        for i, op in enumerate(fn.ops):
            assert op.opcode not in _MGMT, "CandidateAnalysis on managed IR"
            opid = len(self.values)
            self.values.append(ValueInfo(opid, op.result))
            op.attrs["opid"] = opid
            opid_of[op.result] = opid
            if not op.ty.is_cipher:
                continue
            for v in op.operands:
                if not v.ty.is_cipher or v not in opid_of:
                    continue
                if last_use.get(v, -1) <= i:
                    oid = opid_of[v]
                    if oid in live_out:
                        live_out.remove(oid)
                        self.values[oid].dead_opid = opid
            live_out.append(opid)
            for u in self.users.get(op.result, []):
                if self.smu.get_id(u.result) != self.smu.get_id(op.result) and opid > 10:
                    self.values[opid].live_outs = list(live_out)
                    self.values[opid].live_ins = list(live_in)
                    self.edges.append(opid)
                    break
            live_in = list(live_out)
        self.ret_opid = len(self.values)
        self.values.append(ValueInfo(self.ret_opid))
        self.to_from = {0: []}
        self.candidate_set = {}
        self.candidates = []

    # ---- bypass machinery (ValueInfo::isBypassEdge)
    def is_bypass_edge(self, opid, to):
        v = self.values[opid]
        if v.threshold_opid <= to:
            return True
        if opid == to:
            return False
        for u in self.users.get(v.value, []):
            use_opid = u.attrs.get("opid", -1)
            if use_opid <= v.threshold_opid and to < use_opid:
                return False
        return True

    def get_targets(self, opid, set_num=None):
        if opid == self.ret_opid:
            return []
        v = self.values[opid]
        if set_num is None:
            return v.live_outs if not v.valid_live_outs else v.valid_live_outs
        return v.live_outs if len(v.live_outs) == set_num else v.valid_live_outs

    def bypass_type_of_live_outs(self, opid):
        return [self.is_bypass_edge(t, opid) for t in self.values[opid].live_outs]

    def sort_valid_candidates(self, opid):
        v = self.values[opid]
        self.candidate_set.setdefault(len(v.valid_live_outs), []).append(opid)
        if len(v.live_outs) != len(v.valid_live_outs):
            self.candidate_set.setdefault(len(v.live_outs), []).append(opid)

    def max_num_outs(self):
        return max(self.candidate_set.keys(), default=0)

    def sort_targets(self, set_num, opids=None):
        out = []
        src = opids if opids is not None else self.candidate_set.get(set_num, [])
        for a in src:
            for b in self.get_targets(a, set_num):
                if b not in out:
                    out.append(b)
        return out

    def finalize_candidates(self, set_num):
        self.candidates = [0]
        for i in range(1, set_num + 1):
            self.candidates.extend(self.candidate_set.get(i, []))
        self.candidates.append(self.ret_opid)
        self.candidates.sort()

    def push_from_coverage(self, frm, coverages):
        c, bc = coverages
        self.values[frm].coverage = c
        self.values[frm].boot_coverage = bc
        if c < 0:
            c = self.ret_opid
        if bc < 0:
            bc = self.ret_opid
        for to in self.candidates:
            if frm < to < bc:
                self.to_from.setdefault(to, []).append(frm)
            elif to == self.ret_opid and c == self.ret_opid:
                self.to_from.setdefault(to, []).append(frm)


# ----------------------------------------------------------- passes

def bypass_detection(fn: Function, ca: CandidateAnalysis, waterline,
                     threshold=0.5, cfg=None):
    cfg = cfg or current_config()
    for frm in ca.edges:
        live = ca.values[frm].live_outs
        input_tys = [_ty_json(a.ty.switch_scale(waterline)) for a in fn.args]
        input_tys += [_ty_json(fn.ops[o - 1].ty) for o in live]
        dup = extract_segment(fn, ca, frm, ca.ret_opid, live, input_tys,
                              live, [], cfg)
        for a in dup.args[: len(fn.args)]:
            a.ty = a.ty.switch_scale(waterline)

        def on_op(op, opid, frm=frm):
            if over_threshold(op, cfg, threshold):
                ca.values[frm].threshold_opid = opid
                return "break"

        try:
            _sim_pars_walk(dup, waterline, frm, cfg, on_op)
        except TypeInferenceError:
            pass
    for a in ca.edges:
        v = ca.values[a]
        v.valid_live_outs = [
            bp for bp in v.live_outs if not ca.is_bypass_edge(bp, a)
        ]
        ca.sort_valid_candidates(a)


def candidate_selection(fn: Function, ca: CandidateAnalysis, waterline,
                        output_val=0, max_outs=10, cfg=None):
    cfg = cfg or current_config()
    # reference iterates i < maxNumOuts (CandidateSelection.cpp:47); inclusive
    # here so single-live-value programs (maxNumOuts == 1) still select a set
    limit = min(ca.max_num_outs(), max_outs) if ca.max_num_outs() else 0
    fn.attrs["selected_set"] = 0
    for i in range(1, max(1, limit) + 1):
        dup, _ = fn.clone()
        dup.attrs["btp_target"] = ca.sort_targets(i)
        try:
            bootstrap_placement(dup, cfg)
            proactive_rescaling(dup, waterline, output_val, config=cfg)
            fn.attrs["selected_set"] = i
            ca.finalize_candidates(i)
            return i
        except TypeInferenceError:
            continue
    ca.finalize_candidates(fn.attrs["selected_set"])
    return fn.attrs["selected_set"]


def code_segmentation(fn: Function, cfg=None):
    """CodeSegmentation.cpp:33-99 on the python IR."""
    values = attach_opid(fn)
    to = fn.attrs["cutted_edge"][1]
    ret = fn.attrs.get("segment_return", [])
    boots = {}
    for op in fn.ops:
        if op.opcode == "bootstrap" and "opid" in op.attrs:
            boots[op.attrs["opid"]] = op.result
    if not ret:
        fn.attrs["is_mid_segment"] = False
    else:
        fn.returns = [boots.get(r, values[r]) for r in ret]
        fn.attrs["is_mid_segment"] = True

    from ..ir.earth import Value
    subst = {}
    for opid in fn.attrs.get("segment_input", []):
        target = values[opid]
        arg = Value(target.ty, arg_index=len(fn.args))
        fn.args.append(arg)
        subst[target] = arg
    if subst:
        for op in fn.ops:
            op.operands = [subst.get(v, v) for v in op.operands]
        fn.returns = [subst.get(v, v) for v in fn.returns]
    dce(fn)
    return fn


def coverage_recorder(fn: Function, waterline, threshold=0.5, cfg=None):
    """CoverageRecorder.cpp:35-101: simulated PARS walk from the cut."""
    cfg = cfg or current_config()
    frm = fn.attrs["cutted_edge"][0]
    # segment arg types
    tys = fn.attrs.get("segment_inputType")
    if tys:
        for a, tj in zip(fn.args, tys):
            a.ty = ScaleType(bool(tj[0]), tj[1], tj[2])
    state = {"coverage": -1, "boot": -1}

    def on_op(op, opid):
        if state["boot"] < 0 and not is_bootstrappable(op, cfg):
            state["boot"] = opid
            return
        if not is_validated(op, cfg):
            state["coverage"] = opid
            return "break"

    try:
        _sim_pars_walk(fn, waterline, frm, cfg, on_op)
    except TypeInferenceError:
        if state["coverage"] < 0:
            state["coverage"] = frm + 1 if state["boot"] < 0 else state["boot"]
    return [state["coverage"], state["boot"]]


def _ty_json(ty):
    return [1 if ty.is_cipher else 0, ty.scale, ty.level]


def dacapo_plan(fn: Function, waterline, output_val=0, config=None,
                threshold=0.5, max_outs=10, verbose=False):
    """The --dacapo pipeline core (optimizer.cpp:380-436 ordering)."""
    cfg = config or current_config()
    remove_bootstrap(fn)
    ca = CandidateAnalysis(fn)
    bypass_detection(fn, ca, waterline, threshold, cfg)
    set_num = candidate_selection(fn, ca, waterline, output_val, max_outs, cfg)

    # ---------------- the DP (DaCapoPlanner.cpp:88-196)
    arg_tys = [ScaleType(True, waterline, 0) for _ in fn.args]
    best = {0: (0.0, [], [_ty_json(t) for t in arg_tys], [True] * len(fn.args))}

    for to in ca.candidates:
        opt_cost = float("inf")
        for frm in ca.to_from.get(to, []):
            if frm not in best:
                continue
            try:
                dup = extract_segment(
                    fn, ca, frm, to, list(ca.values[frm].live_outs),
                    list(best[frm][2]), ca.get_targets(frm, set_num),
                    list(ca.values[to].live_outs), cfg)
                dup.attrs["segment_returnBypasses"] = (
                    ca.bypass_type_of_live_outs(to))
                proactive_rescaling(dup, waterline, output_val, config=cfg)
                early_modswitch(dup)
                canonicalize(dup)
                cse(dup)
                lat = latency_estimator(dup, cfg)
            except TypeInferenceError:
                continue
            cost = lat + best[frm][0]
            if cost < opt_cost:
                plan = list(best[frm][1]) + [to]
                ret_tys = [_ty_json(t) for t in arg_tys] + [
                    _ty_json(v.ty) for v in dup.returns
                ]
                bypass_tys = [True] * len(fn.args) + list(
                    dup.attrs.get("segment_returnBypasses", []))
                best[to] = (cost, plan, ret_tys, bypass_tys)
                opt_cost = cost

        if to != ca.ret_opid and to in best:
            try:
                dup = extract_segment(
                    fn, ca, to, ca.ret_opid, list(ca.values[to].live_outs),
                    list(best[to][2]), ca.get_targets(to, set_num), [], cfg)
                cov = coverage_recorder(dup, waterline, threshold, cfg)
            except TypeInferenceError:
                cov = [to + 1, to + 1]
            ca.push_from_coverage(to, cov)

    assert ca.ret_opid in best, "DaCapo DP found no feasible plan"
    final_cost, plan, _, _ = best[ca.ret_opid]
    targets = ca.sort_targets(set_num, plan)
    print(f"Estimated Latency: {final_cost / 1e6:.6f} (sec) ")
    print(f"Number of Bootstrapping: {len(targets)}")
    fn.attrs["btp_target"] = targets

    # materialize on the real function + final scale management
    bootstrap_placement(fn, cfg)
    proactive_rescaling(fn, waterline, output_val, config=cfg)
    return fn
