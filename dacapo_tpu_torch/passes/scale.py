"""EVA waterline, PARS, SNR scale walks (copy of dacapo_tpu/passes/scale.py).

Faithful port of the per-op hooks in EarthOps.td (AddOp :357-426, MulOp
:455-531, RotateOp/NegateOp SNR :210-231, BootstrapOp EVA :242-266,
ApplyScheduleOp :312-343) and the pass drivers
(WaterlineRescaling/ProactiveRescaling/SNRRescaling .cpp) plus the shared
refine helpers (lib/Dialect/Earth/Transforms/Common.cpp:8-185).

The MLIR insert-before/insert-after builder pattern maps onto a single
rebuild walk with a running substitution (see ir/earth.py docstring).
"""

from ..ir.earth import Function, Op, ScaleType, Value, infer_type
from ..ir.config import current_config


class TypeInferenceError(Exception):
    """Raised when type inference fails — used as a feasibility probe by
    CandidateSelection, mirroring the reference's pass-failure probing
    (CandidateSelection.cpp:52-59, README.md:156-158)."""


def set_value_attr(fn, v, name, val):
    if v.is_arg:
        fn.attrs.setdefault("arg_attrs", {}).setdefault(v.arg_index, {})[name] = val
    else:
        v.def_op.attrs[name] = val


def get_value_attr(fn, v, name, default=0):
    if v.is_arg:
        return fn.attrs.get("arg_attrs", {}).get(v.arg_index, {}).get(name, default)
    return v.def_op.attrs.get(name, default)


# ---------------------------------------------------------------- helpers

class _Walk:
    """State for one rebuild walk."""

    def __init__(self, fn, cfg):
        self.fn = fn
        self.cfg = cfg
        self.new_ops = []
        self.subst = {}

    def emit(self, opcode, operands, attrs, loc=None):
        op = Op(opcode, operands, attrs, None, loc)
        ty = infer_type(op, self.cfg)
        if ty is None:
            raise TypeInferenceError(f"failed to infer {opcode}")
        op.set_ty(ty)
        self.new_ops.append(op)
        return op.result

    def upscale(self, v, up, loc=None):
        return self.emit("upscale", [v], {"upFactor": int(up)}, loc)

    def rescale(self, v, loc=None):
        return self.emit("rescale", [v], {}, loc)

    def modswitch(self, v, down, loc=None):
        return self.emit("modswitch", [v], {"downFactor": int(down)}, loc)


# ------------------------------------------------------- per-op hooks

def _plain_case_add_eva(w, op):
    lo = 0 if op.operands[1].ty.is_cipher else 1
    hi = 1 - lo
    op.operands[lo].ty = op.operands[hi].ty.to_plain()


def _process_operands(w: _Walk, op: Op, mode: str, param: int):
    cfg = w.cfg
    rf = cfg.rescaling_factor
    o = op.operands

    if op.opcode == "add":
        if mode in ("pars", "snr"):
            if mode == "snr":
                if not (o[0].ty.is_cipher and o[1].ty.is_cipher):
                    lo = 0 if o[1].ty.is_cipher else 1
                    hi = 1 - lo
                    if o[hi].ty.scale > param:
                        o[lo].ty = o[hi].ty.to_plain()
                    else:
                        o[lo].ty = o[hi].ty.to_plain().switch_scale(param)
                        op.operands[hi] = w.upscale(o[hi], param - o[hi].ty.scale, op.loc)
                    return
                for i in (0, 1):
                    if o[i].ty.scale < param:
                        op.operands[i] = w.upscale(o[i], param - o[i].ty.scale, op.loc)
                o = op.operands
            # PARS body
            if not (o[0].ty.is_cipher and o[1].ty.is_cipher):
                _plain_case_add_eva(w, op)
                return
            for i in (0, 1):
                if op.operands[i].ty.scale >= param + rf:
                    op.operands[i] = w.rescale(op.operands[i], op.loc)
            o = op.operands
            if o[0].ty.level != o[1].ty.level:
                lo = 0 if o[0].ty.level < o[1].ty.level else 1
                if o[lo].ty.scale != param:
                    op.operands[lo] = w.upscale(
                        o[lo], param + rf - o[lo].ty.scale, op.loc)
                    op.operands[lo] = w.rescale(op.operands[lo], op.loc)
        # EVA body (also the tail of PARS/SNR)
        o = op.operands
        if not (o[0].ty.is_cipher and o[1].ty.is_cipher):
            _plain_case_add_eva(w, op)
            return
        if o[0].ty.scale != o[1].ty.scale:
            lo = 0 if o[0].ty.scale < o[1].ty.scale else 1
            hi = 1 - lo
            op.operands[lo] = w.upscale(
                o[lo], o[hi].ty.scale - o[lo].ty.scale, op.loc)
        o = op.operands
        if o[0].ty.level != o[1].ty.level:
            lo = 0 if o[0].ty.level < o[1].ty.level else 1
            hi = 1 - lo
            op.operands[lo] = w.modswitch(
                o[lo], o[hi].ty.level - o[lo].ty.level, op.loc)
        return

    if op.opcode == "mul":
        if mode in ("pars", "snr"):
            if mode == "snr" and not (o[0].ty.is_cipher and o[1].ty.is_cipher):
                lo = 0 if o[1].ty.is_cipher else 1
                o[lo].ty = o[1 - lo].ty.to_plain().switch_scale(param)
                return
            # PARS body (EarthOps.td:470-502)
            if not (o[0].ty.is_cipher and o[1].ty.is_cipher):
                lo = 0 if o[1].ty.is_cipher else 1
                o[lo].ty = o[1 - lo].ty.to_plain().switch_scale(param)
            for i in (0, 1):
                if op.operands[i].ty.scale >= param + rf:
                    op.operands[i] = w.rescale(op.operands[i], op.loc)
            o = op.operands
            if o[0].ty.level != o[1].ty.level:
                lo = 0 if o[0].ty.level < o[1].ty.level else 1
                if o[lo].ty.scale != param:
                    op.operands[lo] = w.upscale(
                        o[lo], param + rf - o[lo].ty.scale, op.loc)
                    op.operands[lo] = w.rescale(op.operands[lo], op.loc)
            _mul_eva_operands(w, op, param)
            o = op.operands
            if o[0].ty.scale + o[1].ty.scale > 2 * param + rf:
                op.operands[0] = w.upscale(o[0], param + rf - o[0].ty.scale, op.loc)
                op.operands[0] = w.rescale(op.operands[0], op.loc)
                o = op.operands
                if o[0].ty.level != o[1].ty.level:
                    op.operands[1] = w.upscale(o[1], param + rf - o[1].ty.scale, op.loc)
                    op.operands[1] = w.rescale(op.operands[1], op.loc)
            return
        _mul_eva_operands(w, op, param)
        return

    if op.opcode in ("rotate", "negate") and mode == "snr":
        if o[0].ty.scale < param:
            op.operands[0] = w.upscale(o[0], param - o[0].ty.scale, op.loc)
        return

    if op.opcode == "bootstrap":
        # BootstrapOp overrides only EVA; PARS/SNR default-chain to it.
        t = o[0].ty
        if t.scale + rf * t.level < (w.cfg.bootstrap_level_upper + 1) * rf:
            if t.scale < rf:
                op.operands[0] = w.upscale(o[0], rf - t.scale, op.loc)
            elif t.scale > rf:
                over = (t.scale - 1) // rf
                op.operands[0] = w.upscale(
                    o[0], rf * (over + 1) - t.scale, op.loc)
                for _ in range(over):
                    op.operands[0] = w.rescale(op.operands[0], op.loc)
        return

    if op.opcode == "apply_schedule":
        if mode == "snr" and o[0].ty.scale < param:
            op.operands[0] = w.upscale(o[0], param - o[0].ty.scale, op.loc)
        # EVA materialization (EarthOps.td:313-329)
        sf = op.attrs.get("scaleFactor", 0)
        lf = op.attrs.get("levelFactor", 0)
        if lf > 0:
            op.operands[0] = w.upscale(
                op.operands[0], param + rf - op.operands[0].ty.scale, op.loc)
            op.operands[0] = w.rescale(op.operands[0], op.loc)
            lf -= 1
        if lf > 0:
            op.operands[0] = w.modswitch(op.operands[0], lf, op.loc)
        if sf > 0:
            op.operands[0] = w.upscale(op.operands[0], sf, op.loc)
        return


def _mul_eva_operands(w: _Walk, op: Op, param: int):
    o = op.operands
    if not (o[0].ty.is_cipher and o[1].ty.is_cipher):
        lo = 0 if o[1].ty.is_cipher else 1
        o[lo].ty = o[1 - lo].ty.to_plain().switch_scale(param)
        return
    if o[0].ty.level != o[1].ty.level:
        lo = 0 if o[0].ty.level < o[1].ty.level else 1
        hi = 1 - lo
        op.operands[lo] = w.modswitch(
            o[lo], o[hi].ty.level - o[lo].ty.level, op.loc)


def _process_results(w: _Walk, op: Op, mode: str, param: int):
    rf = w.cfg.rescaling_factor
    if op.opcode == "mul":
        target = op.result
        while target.ty.scale >= param + rf:
            target = w.rescale(target, op.loc)
        if target is not op.result:
            w.subst[op.result] = target
    elif op.opcode == "bootstrap":
        op.attrs["targetLevel"] = op.ty.level
    elif op.opcode == "apply_schedule":
        # replace result with (possibly managed) operand: the op dissolves
        w.subst[op.result] = op.operands[0]


# ------------------------------------------------------------ refine fns

def refine_input_values(fn: Function, waterline: int):
    if "segment_inputType" not in fn.attrs:
        for a in fn.args:
            a.ty = a.ty.switch_scale(waterline)
    else:
        for a, tyj in zip(fn.args, fn.attrs["segment_inputType"]):
            a.ty = ScaleType(bool(tyj[0]), tyj[1], tyj[2])


def refine_level(fn, w: _Walk, operands, waterline, output_val, min_level, cfg):
    """Insert modswitches pushing operands to the minimum surviving level
    (Common.cpp:8-42). Returns the rewritten operand list."""
    rf = cfg.rescaling_factor
    max_required = cfg.bootstrap_level_upper - min_level
    if max_required < 0:
        max_required = cfg.level_upper - min_level
    out = []
    for v in operands:
        if get_value_attr(fn, v, "is_bypassed", 0) > 0:
            out.append(v)
            continue
        acc = v.ty.level * rf + v.ty.scale + output_val
        diff = (max_required * rf - acc) // rf
        out.append(w.modswitch(v, diff))
    return out


def refine_return_values(fn: Function, w: _Walk, waterline, output_val, cfg):
    max_required = cfg.bootstrap_level_upper
    if max_required < 0:
        max_required = cfg.level_upper

    if fn.attrs.get("is_mid_segment"):
        bypass = fn.attrs.get("segment_returnBypasses", [])
        for v, isb in zip(fn.returns, bypass):
            set_value_attr(fn, v, "is_bypassed", 1 if isb else 0)
        fn.returns = refine_level(
            fn, w, fn.returns, waterline, 0, cfg.bootstrap_level_lower - 1, cfg)
    else:
        fn.returns = refine_level(fn, w, fn.returns, waterline, output_val, 0, cfg)

    fn.attrs["init_level"] = max_required
    fn.attrs["arg_scale"] = [a.ty.scale for a in fn.args]
    fn.attrs["res_scale"] = [v.ty.scale for v in fn.returns]
    fn.attrs["res_level"] = [v.ty.level for v in fn.returns]
    fn.attrs["arg_level"] = [a.ty.level for a in fn.args]


# ------------------------------------------------------------- the passes

def _forward_pass(fn: Function, mode: str, waterline: int, output_val: int,
                  smu=None, config=None):
    cfg = config or current_config()
    refine_input_values(fn, waterline)
    w = _Walk(fn, cfg)

    # Bootstrap refineLevel happens at the end in the reference; we collect
    # bootstrap ops during the walk and post-process.
    bootstraps = []
    for op in fn.ops:
        op.operands = [w.subst.get(v, v) for v in op.operands]
        if mode == "snr" and smu is not None:
            param = calc_waterline(smu, op, waterline)
        else:
            param = waterline
        if op.opcode != "constant":
            _process_operands(w, op, mode, param)
        if op.opcode == "constant":
            op.set_ty(ScaleType(False, 0, 0))
        else:
            ty = infer_type(op, cfg)
            if ty is None:
                raise TypeInferenceError(
                    f"failed to infer returned types of {op.opcode} "
                    f"({', '.join(str(v.ty) for v in op.operands)})")
            op.set_ty(ty)
        w.new_ops.append(op)
        _process_results(w, op, mode, param)
        if op.opcode == "bootstrap":
            bootstraps.append(op)
    fn.ops = w.new_ops
    fn.returns = [w.subst.get(v, v) for v in fn.returns]

    # refineReturnValues (+ per-bootstrap refineLevel) appends modswitches.
    w2 = _Walk(fn, cfg)
    w2.new_ops = fn.ops
    for bop in bootstraps:
        bop.operands = refine_level(
            fn, w2, bop.operands, waterline, 0, cfg.bootstrap_level_lower - 1, cfg)
        # the modswitch was emitted after bop; move it before (rebuild order)
    refine_return_values(fn, w2, waterline, output_val, cfg)
    fn.ops = _retopo(fn)
    return fn


def _retopo(fn: Function):
    """Re-topologically-sort ops (late-inserted modswitches must precede
    their users). Stable for already-sorted programs."""
    pos = {}
    order = []
    visiting = set()

    def visit(op):
        if op in pos:
            return
        assert op not in visiting, "cycle in IR"
        visiting.add(op)
        for v in op.operands:
            if not v.is_arg:
                visit(v.def_op)
        visiting.discard(op)
        pos[op] = len(order)
        order.append(op)

    for op in fn.ops:
        visit(op)
    for v in fn.returns:
        if not v.is_arg:
            visit(v.def_op)
    return order


def waterline_rescaling(fn, waterline, output_val=0, config=None):
    """--eva (WaterlineRescaling.cpp)."""
    return _forward_pass(fn, "eva", waterline, output_val, config=config)


def proactive_rescaling(fn, waterline, output_val=0, config=None):
    """--pars (ProactiveRescaling.cpp)."""
    return _forward_pass(fn, "pars", waterline, output_val, config=config)


def snr_rescaling(fn, waterline, output_val=0, smu=None, config=None):
    """--snr (SNRRescaling.cpp) — per-SMU waterline for noisy groups."""
    if smu is None:
        from .smu import ScaleManagementUnit
        smu = ScaleManagementUnit(fn)
    return _forward_pass(fn, "snr", waterline, output_val, smu=smu, config=config)


def calc_waterline(smu, op, waterline):
    """Common.cpp:170-185: +4 bits for noisy (rotation-containing) SMUs."""
    v = op.result
    while smu.get_id(v) < 0:
        users = smu.first_user(v)
        if users is None:
            return waterline
        v = users
    return waterline + 4 if smu.in_noisy_group(v) else waterline
