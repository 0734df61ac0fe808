"""DCE, CSE, canonicalization, constant elision (copy of dacapo_tpu/passes/rewrite.py).

Pattern set mirrors include/hecate/Dialect/Earth/IR/EarthCanonicalizer.td:19-46
(zero upscale/modswitch folds, add-zero / mul-one / neg-mul, upscale-upscale &
modswitch-modswitch merges, constant scale/level folding, rescale(upscale x)
-> modswitch(upscale')), plus the trivial DCE MLIR's greedy pattern rewriter performs.
MulZeroPattern stays disabled exactly like the reference
(lib/Dialect/Earth/IR/EarthDialect.cpp:310).
"""

import hashlib

import numpy as np

from ..ir.earth import Function, Op, infer_type
from ..ir.config import current_config


def dce(fn: Function):
    live = set(fn.returns)
    new_ops = []
    for op in reversed(fn.ops):
        if op.result in live:
            live.update(op.operands)
            new_ops.append(op)
    n_removed = len(fn.ops) - len(new_ops)
    fn.ops = new_ops[::-1]
    return n_removed


def _attr_key(attrs):
    items = []
    for k in sorted(attrs):
        v = attrs[k]
        if isinstance(v, np.ndarray):
            items.append((k, hashlib.sha1(v.tobytes()).hexdigest(), v.shape))
        elif isinstance(v, (list, tuple)):
            items.append((k, tuple(v)))
        else:
            items.append((k, v))
    return tuple(items)


def cse(fn: Function):
    subst = {}
    seen = {}
    new_ops = []
    for op in fn.ops:
        op.operands = [subst.get(v, v) for v in op.operands]
        key = (op.opcode, tuple(id(v) for v in op.operands), _attr_key(op.attrs), op.ty)
        prev = seen.get(key)
        if prev is not None:
            subst[op.result] = prev.result
        else:
            seen[key] = op
            new_ops.append(op)
    fn.ops = new_ops
    fn.returns = [subst.get(v, v) for v in fn.returns]
    dce(fn)


def _const_payload(op):
    if op.opcode == "constant" and "value" in op.attrs:
        return op.attrs["value"]
    return None


def _is_all(arr, x):
    return arr is not None and arr.size > 0 and bool(np.all(arr == x))


def canonicalize(fn: Function, max_iters=10):
    cfg = current_config()
    rf = cfg.rescaling_factor

    def _new(opcode, operands, attrs, loc, new_ops, ty=None):
        op = Op(opcode, operands, attrs, ty, loc)
        if ty is None:
            op.set_ty(infer_type(op, cfg))
        new_ops.append(op)
        return op.result

    def rewrite(op, new_ops):
        """Return replacement Value, or None to keep op as-is."""
        o = op.operands
        oc = op.opcode
        defop = o[0].def_op if o and not o[0].is_arg else None

        if oc == "upscale" and op.attrs["upFactor"] == 0:
            return o[0]
        if oc == "modswitch" and op.attrs["downFactor"] == 0:
            return o[0]

        if oc == "add":
            for i in (0, 1):
                c = None if o[i].is_arg else _const_payload(o[i].def_op)
                if _is_all(c, 0.0) and o[1 - i].ty == op.ty:
                    return o[1 - i]
        if oc == "mul":
            for i in (0, 1):
                c = None if o[i].is_arg else _const_payload(o[i].def_op)
                if _is_all(c, 1.0) and o[1 - i].ty == op.ty:
                    return o[1 - i]
                if _is_all(c, -1.0):
                    return _new("negate", [o[1 - i]], {}, op.loc, new_ops)

        if oc == "upscale" and defop is not None and defop.opcode == "upscale" \
                and not defop.attrs.get("sm_fixed"):
            return _new("upscale", list(defop.operands),
                        {"upFactor": op.attrs["upFactor"] + defop.attrs["upFactor"]},
                        op.loc, new_ops)
        if oc == "modswitch" and defop is not None and defop.opcode == "modswitch" \
                and not defop.attrs.get("sm_fixed"):
            return _new("modswitch", list(defop.operands),
                        {"downFactor": op.attrs["downFactor"] + defop.attrs["downFactor"]},
                        op.loc, new_ops)
        if oc == "upscale" and defop is not None and defop.opcode == "constant":
            return _new("constant", [], dict(defop.attrs), op.loc, new_ops,
                        ty=defop.ty.switch_scale(defop.ty.scale + op.attrs["upFactor"]))
        if oc == "modswitch" and defop is not None and defop.opcode == "constant":
            return _new("constant", [], dict(defop.attrs), op.loc, new_ops,
                        ty=defop.ty.switch_level(defop.ty.level + op.attrs["downFactor"]))
        if oc == "rescale" and defop is not None and defop.opcode == "upscale" \
                and defop.attrs["upFactor"] - rf >= 0:
            up = _new("upscale", list(defop.operands),
                      {"upFactor": defop.attrs["upFactor"] - rf}, op.loc, new_ops)
            return _new("modswitch", [up], {"downFactor": 1}, op.loc, new_ops)
        return None

    for _ in range(max_iters):
        changed = False
        subst = {}
        new_ops = []
        for op in fn.ops:
            op.operands = [subst.get(v, v) for v in op.operands]
            rep = rewrite(op, new_ops)
            if rep is not None:
                subst[op.result] = rep
                changed = True
            else:
                new_ops.append(op)
        fn.ops = new_ops
        fn.returns = [subst.get(v, v) for v in fn.returns]
        dce(fn)
        if not changed:
            break
    return fn


def elide_constants(fn: Function):
    """Dump payloads, replace with cst_index (ElideConstant.cpp:27-54)."""
    payloads = []
    index = {}
    for op in fn.ops:
        arr = _const_payload(op)
        if arr is None:
            continue
        key = hashlib.sha1(arr.tobytes()).hexdigest()
        if key not in index:
            index[key] = len(payloads)
            payloads.append(arr)
        op.attrs = {
            "cst_index": index[key],
            "rms_var": op.attrs.get("rms_var", 0.0),
            "len": int(arr.size),
        }
    return payloads


def privatize_constants(fn: Function):
    """Clone constants so each has a single use (PrivatizeConstant.cpp:22-35)."""
    uses = {}
    for op in fn.ops:
        for v in op.operands:
            uses[v] = uses.get(v, 0) + 1
    for v in fn.returns:
        uses[v] = uses.get(v, 0) + 1
    new_ops = []
    for op in fn.ops:
        if op.opcode == "constant" and uses.get(op.result, 0) > 1:
            continue  # re-created per use below
        new_operands = []
        for v in op.operands:
            d = v.def_op if not v.is_arg else None
            if d is not None and d.opcode == "constant" and uses.get(v, 0) > 1:
                c = Op("constant", [], dict(d.attrs), d.ty, d.loc)
                new_ops.append(c)
                new_operands.append(c.result)
            else:
                new_operands.append(v)
        op.operands = new_operands
        new_ops.append(op)
    fn.ops = new_ops
    return fn
