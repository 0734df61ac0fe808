"""Superop fusion over the (SSA-expanded) HEVM instruction stream.

Copy of dacapo_tpu/vm/fuse.py.

The MPCB conv layers (reference python/poly/poly/MPCB.py MultParConvBN)
compile to the pattern

    r_k = rotatec(src, s_k); t_k = mulcp(r_k, pt_k); g = addcc-tree(t_k ...)

repeated 96-253 times per layer (measured on the ResNet dacapo/40 bytecode).
Dispatching these as single ops costs 4 launches per tap and a full
ModDown per rotation. This pass statically detects the pattern and rewrites
it into ONE fused instruction per accumulation group:

    g = rot_mac(src, [(s_k, pt_k)...]) + extras  =  sum_k pt_k*rot_{s_k}(src)

executed by Evaluator.rot_mac with Halevi-Shoup hoisting (one ModUp per
source) and LAZY ModDown: plaintext masks are multiplied in the extended
Q^{(nl)}P basis and the ModDown runs once per group instead of once per
rotation — the classic hoisted-convolution optimization of HE CNN runtimes
(HEaaN, Lattigo), re-derived for the TPU batch layout. A rescalec that
solely consumes the tree root is folded into the same launch.

Input MUST be the executor's SSA stream (every cipher register defined
exactly once: vm/executor.py ssa_expand), so "register" == "value" and the
single-use checks below are sound.
"""

from dataclasses import dataclass, field

from .hevm import (
    OP_ROTATE, OP_MULCP, OP_MULCC, OP_ADDCC, OP_ENCODE, OP_ALLOC, OP_RESCALE,
    OP_UPSCALE,
)

MIN_TAPS = 2        # a 2-tap fused group still replaces ~6 launches with 2
OP_ROTMAC = -2
OP_UPRESCALE = -3


@dataclass
class UpRescaleOp:
    """upscalec whose sole consumer is a rescalec, merged into one launch
    (the PARS scale-alignment idiom: upscale to the common scale, rescale
    down a level — hundreds of occurrences per CNN plan)."""
    lhs: int
    dst: int
    up_bits: int
    orig: int = -1      # on-disk index of the upscalec (steering K lookup)

    opcode = OP_UPRESCALE

    @property
    def rhs(self):            # debug-print parity with HEVMOp
        return self.up_bits


@dataclass
class RotMacOp:
    """Fused sum_k pt_k*rot_{steps_k}(src) + sum_j ptq_j*v_j (+ extras).

    Two tap kinds share one accumulation group:
    * rotation taps — mask times a rotation of ONE source ciphertext
      (hoisted keyswitch, lazy ModDown; QP-basis masks);
    * plain taps — mask times an arbitrary already-computed ciphertext
      (no keyswitch; Q-basis masks). Covers mulcp on rotate-by-0 copies,
      accumulated values, modswitched inputs etc.
    `steps` may be empty (pure plain-mac tree)."""
    src: int                    # source ciphertext register (-1 if no rot taps)
    steps: list                 # rotation offsets, aligned with pt_regs
    pt_regs: list               # plaintext register per rotation tap
    plain_vals: list = field(default_factory=list)  # ciphertext reg per plain tap
    plain_pts: list = field(default_factory=list)   # plaintext reg per plain tap
    extra: list = field(default_factory=list)   # registers of non-tap addends
    dst: int = -1               # destination register of the tree root
    fold_rescale: bool = False  # root feeds exactly one rescalec: folded
    rescale_dst: int = -1
    taps_rescaled: bool = False
    # PARS rescales EVERY product before accumulating (mulcp -> rescalec ->
    # addcc). sum-then-rescale is algebraically identical and replaces K
    # rescale rounding errors with one, so the fused op hoists the K
    # tap-level rescales into a single post-sum rescale; extras (already at
    # the post-rescale level) are then added after it.

    opcode = OP_ROTMAC          # marker (never serialized)


def cipher_reads(op, num_regs):
    """Cipher registers read by `op` (SSA stream)."""
    oc = op.opcode
    if oc in (OP_ENCODE, OP_ALLOC):
        return ()
    if oc == OP_ROTMAC:
        r = list(op.plain_vals) + list(op.extra)
        if op.src >= 0:
            r.insert(0, op.src)
        return r
    if oc == OP_UPRESCALE:
        return (op.lhs,)
    r = [op.lhs]
    if oc in (OP_ADDCC, OP_MULCC) and op.rhs < num_regs:
        r.append(op.rhs)
    return r


def build_fuse_plan(ops, num_regs, res_dst):
    """-> (new_ops, fused_pt_regs, num_regs'): instruction list with
    RotMacOp entries replacing fusable rotate/mulcp/addcc trees, the set of
    plaintext registers needing extended-basis (QP) encoding, and the
    register count (multi-source trees add synthetic partial registers)."""
    users = {}
    def_idx = {}
    for idx, op in enumerate(ops):
        for r in cipher_reads(op, num_regs):
            users.setdefault(r, []).append(idx)
        if op.opcode not in (OP_ENCODE, OP_ALLOC):
            def_idx[op.dst] = idx
    res_set = set(res_dst)

    def single_use(reg):
        return len(users.get(reg, ())) == 1 and reg not in res_set

    # taps: tap register -> (op idxs to consume, kind, src_reg, steps_or_-1,
    # pt_reg, rescaled, rot_idx_or_-1). kind "rot": mask times a rotation of
    # src (hoisted keyswitch); kind "plain": mask times ANY existing value
    # (incl. rotate-by-0 copies) — no keyswitch. The tap register is the
    # mulcp result, or — the PARS shape — the rescalec result directly
    # downstream. A ROTATION value may be shared by several taps (conv masks
    # of different output channels reuse the rotation fan): the rotatec op
    # itself is consumed only if every one of its users ends up fused; the
    # fused groups share the hoisted ModUp at runtime (executor digits
    # cache). A plain tap's source value is never consumed.
    taps = {}
    for idx, op in enumerate(ops):
        if op.opcode != OP_MULCP:
            continue
        didx = def_idx.get(op.lhs)
        dop = ops[didx] if didx is not None else None
        tap_reg = op.dst
        idxs = [idx]
        rescaled = False
        if single_use(op.dst):
            uidx = users[op.dst][0]
            if ops[uidx].opcode == OP_RESCALE:
                tap_reg = ops[uidx].dst
                idxs.append(uidx)
                rescaled = True
        if dop is not None and dop.opcode == OP_ROTATE and dop.rhs != 0:
            taps[tap_reg] = (idxs, "rot", dop.lhs, dop.rhs, op.rhs,
                             rescaled, didx)
        else:
            src = op.lhs
            if dop is not None and dop.opcode == OP_ROTATE and dop.rhs == 0:
                src = dop.lhs     # rotate-by-0 is a copy: tap its source
            taps[tap_reg] = (idxs, "plain", src, -1, op.rhs, rescaled, -1)

    def is_internal(reg):
        """reg is an addcc result consumed once by another addcc."""
        didx = def_idx.get(reg)
        if didx is None or ops[didx].opcode != OP_ADDCC or not single_use(reg):
            return False
        return ops[users[reg][0]].opcode == OP_ADDCC

    def collect(reg, tap_leaves, node_idxs, extras, root):
        didx = def_idx.get(reg)
        if reg == root or is_internal(reg):
            if reg != root:
                node_idxs.append(didx)
            for sub in cipher_reads(ops[didx], num_regs):
                collect(sub, tap_leaves, node_idxs, extras, root)
        elif reg in taps and single_use(reg):
            tap_leaves.append(reg)
        else:
            extras.append(reg)

    consumed = set()
    fused_at = {}
    fused_pt_regs = set()
    for idx, op in enumerate(ops):
        if op.opcode != OP_ADDCC or idx in consumed:
            continue
        if is_internal(op.dst):
            continue               # absorbed by its root's walk
        tap_leaves, node_idxs, extras = [], [], []
        collect(op.dst, tap_leaves, node_idxs, extras, op.dst)
        resc = {taps[t][5] for t in tap_leaves}
        if len(tap_leaves) < MIN_TAPS or len(resc) != 1:
            continue
        rescaled = resc.pop()
        # partition ROTATION taps by source ciphertext (multi-ct conv
        # inputs: one tree accumulates taps of several packed input
        # ciphertexts); each big-enough partition becomes a RotMacOp;
        # undersized ones keep their per-op form and join as extra addends.
        # PLAIN taps (keyswitch-free mask products) all ride the last op.
        # Sum-then-rescale per partition equals the original up to strictly
        # less rounding noise.
        by_src = {}
        plain = []
        for t in tap_leaves:
            if taps[t][1] == "rot":
                by_src.setdefault(taps[t][2], []).append(t)
            else:
                plain.append(t)
        big = {s: ts for s, ts in by_src.items() if len(ts) >= MIN_TAPS}
        if not big and len(plain) < MIN_TAPS:
            continue
        small_tap_regs = [t for s, ts in by_src.items()
                          if s not in big for t in ts]
        emitted = []
        order = list(big.items()) or [(-1, [])]
        for j, (s, ts) in enumerate(order):
            last = j == len(order) - 1
            if last:
                dst = op.dst
                ex = [r.dst for r in emitted] + small_tap_regs + extras
            else:
                dst = num_regs
                num_regs += 1
                ex = []
            rm = RotMacOp(
                src=s,
                steps=[taps[t][3] for t in ts],
                pt_regs=[taps[t][4] for t in ts],
                extra=ex, dst=dst, taps_rescaled=rescaled,
            )
            if last:
                rm.plain_vals = [taps[t][2] for t in plain]
                rm.plain_pts = [taps[t][4] for t in plain]
                for t in plain:
                    consumed.update(taps[t][0])
            emitted.append(rm)
            for t in ts:
                consumed.update(taps[t][0])
            fused_pt_regs.update(rm.pt_regs)
        root_rm = emitted[-1]
        # fold a rescalec that solely consumes the tree root
        if not rescaled and single_use(op.dst):
            uop = ops[users[op.dst][0]]
            if uop.opcode == OP_RESCALE:
                root_rm.fold_rescale = True
                root_rm.rescale_dst = uop.dst
                consumed.add(users[op.dst][0])
        consumed.update(node_idxs)
        consumed.add(idx)
        fused_at[idx] = emitted

    # a rotatec is dead once EVERY user was fused away — unless its dst is a
    # program result (it must still be defined for output materialization)
    for t, info in taps.items():
        if info[1] == "rot" and info[0][0] in consumed:
            rot_idx = info[6]
            rot_dst = ops[rot_idx].dst
            if rot_dst not in res_set and \
                    all(u in consumed for u in users.get(rot_dst, ())):
                consumed.add(rot_idx)

    new_ops = []
    for idx, op in enumerate(ops):
        if idx in fused_at:
            new_ops.extend(fused_at[idx])
        elif idx not in consumed:
            new_ops.append(op)
    new_ops = merge_upscale_rescale(new_ops, num_regs, res_set)
    return new_ops, fused_pt_regs, num_regs


def merge_upscale_rescale(ops, num_regs, res_set):
    """Peephole: upscalec single-used by a rescalec -> one UpRescaleOp."""
    users = {}
    for idx, op in enumerate(ops):
        for r in cipher_reads(op, num_regs):
            users.setdefault(r, []).append(idx)
    drop = set()
    replace = {}
    for idx, op in enumerate(ops):
        if op.opcode != OP_UPSCALE:
            continue
        u = users.get(op.dst, ())
        if len(u) != 1 or op.dst in res_set:
            continue
        uop = ops[u[0]]
        if uop.opcode != OP_RESCALE:
            continue
        replace[idx] = UpRescaleOp(lhs=op.lhs, dst=uop.dst, up_bits=op.rhs,
                                   orig=op.orig)
        drop.add(u[0])
    if not replace:
        return ops
    out = []
    for idx, op in enumerate(ops):
        if idx in replace:
            out.append(replace[idx])
        elif idx not in drop:
            out.append(op)
    return out


def ssa_expand(prog):
    """Rewrite the register-machine bytecode into SSA: every cipher dst gets
    a fresh register (ALLOC markers dropped). The on-disk format keeps the
    reference's ReuseBuffer-compacted registers (HEVMHeader.h layout); the
    executor's dict-based register file has no aliasing to exploit, and SSA
    is what makes superop fusion and window liveness sound.

    Returns (new_ops, num_regs, res_dst): plain/constant register spaces are
    untouched."""
    remap = {i: i for i in range(prog.arg_length)}
    nxt = prog.arg_length
    out = []
    for orig, op in enumerate(prog.ops):
        oc = op.opcode
        if oc == OP_ALLOC:
            continue
        if oc == OP_ENCODE:
            out.append(op)
            continue
        lhs = remap.get(op.lhs, op.lhs)
        rhs = op.rhs
        if oc in (OP_ADDCC, OP_MULCC):
            rhs = remap.get(op.rhs, op.rhs)
        dst = nxt
        nxt += 1
        remap[op.dst] = dst
        out.append(type(op)(opcode=oc, dst=dst, lhs=lhs, rhs=rhs, orig=orig))
    res_dst = [remap.get(r, r) for r in prog.res_dst]
    return out, nxt, res_dst
