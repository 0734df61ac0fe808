"""EarlyModswitch and UpscaleBubbling hoisting passes (copy of dacapo_tpu/passes/hoist.py).

Port of lib/Dialect/Earth/Transforms/EarlyModswitch.cpp:36-104 and
UpscaleBubbling.cpp:26-105: reverse walk; when every user of a value is a
modswitch (resp. upscale), hoist the minimum factor through the producer —
absorbing into an existing modswitch/upscale, folding into constants (via the
result-type bump), or pushing onto the producer's operands. Bootstrap results
are never hoisted through; upscale bubbling skips ct×ct muls and only feeds
the cipher operand of ct×pt muls.

The cascade through chains (reference gets it from reverse block iteration
visiting newly inserted ops) is reproduced with an explicit worklist.
"""

from ..ir.earth import Function, Op

_RET = "return"


def _build_users(fn: Function):
    users = {}
    for op in fn.ops:
        for v in op.operands:
            users.setdefault(v, []).append(op)
    for v in fn.returns:
        users.setdefault(v, []).append(_RET)
    return users


def _hoist(fn: Function, kind: str):
    assert kind in ("modswitch", "upscale")
    factor_key = "downFactor" if kind == "modswitch" else "upFactor"
    users = _build_users(fn)
    inserted = {}  # op -> list of new ops to place immediately before it

    work = list(reversed(fn.ops))
    while work:
        op = work.pop(0)
        if op.opcode == "bootstrap":
            continue
        if kind == "upscale" and op.is_consume() and not op.is_single():
            continue
        uses = users.get(op.result, [])
        if not uses:
            continue
        minf = None
        for u in uses:
            if u is not _RET and u.opcode == kind:
                f = u.attrs[factor_key]
                minf = f if minf is None else min(minf, f)
            else:
                minf = 0
                break
        if not minf:
            continue

        if op.opcode == kind:
            op.attrs[factor_key] += minf
        elif kind == "upscale" and op.is_consume() and op.is_single():
            # push onto the cipher operand only
            for i, v in enumerate(op.operands):
                if v.ty.is_cipher:
                    nv = _insert_before(fn, op, kind, v, minf, users, inserted)
                    op.operands[i] = nv
                    work.insert(0, nv.def_op)
        elif op.opcode == "constant":
            pass  # type bump below folds it into the constant
        else:
            for i, v in enumerate(op.operands):
                nv = _insert_before(fn, op, kind, v, minf, users, inserted)
                op.operands[i] = nv
                work.insert(0, nv.def_op)

        if kind == "modswitch":
            op.set_ty(op.ty.switch_level(op.ty.level + minf))
        else:
            op.set_ty(op.ty.switch_scale(op.ty.scale + minf))
        for u in uses:
            if u is not _RET and u.opcode == kind:
                u.attrs[factor_key] -= minf

    if inserted:
        new_ops = []
        for op in fn.ops:
            new_ops.extend(inserted.get(id(op), []))
            new_ops.append(op)
        fn.ops = new_ops
    return fn


def _insert_before(fn, op, kind, v, f, users, inserted):
    factor_key = "downFactor" if kind == "modswitch" else "upFactor"
    if kind == "modswitch":
        ty = v.ty.switch_level(v.ty.level + f)
    else:
        ty = v.ty.switch_scale(v.ty.scale + f)
    nop = Op(kind, [v], {factor_key: f}, ty, op.loc)
    inserted.setdefault(id(op), []).append(nop)
    # maintain user maps
    lst = users.get(v, [])
    if op in lst:
        lst.remove(op)
    lst.append(nop)
    users[v] = lst
    users[nop.result] = [op]
    return nop.result


def early_modswitch(fn: Function):
    return _hoist(fn, "modswitch")


def upscale_bubbling(fn: Function):
    return _hoist(fn, "upscale")


def flexible_bootstrap(fn: Function):
    """Absorb modswitch users into the bootstrap target level.

    Port of lib/Dialect/Earth/Transforms/FlexibleBootstrap.cpp:35-77: when
    every user of an `earth.bootstrap` is a modswitch, raise the bootstrap's
    targetLevel by the minimum downFactor — the bootstrap then refreshes to a
    shallower level, which is cheaper (bootstrap latency grows with target
    level) and wastes no freshly raised levels. Zero-factor modswitches left
    behind fold away in canonicalize.
    """
    users = _build_users(fn)
    for op in fn.ops:
        if op.opcode != "bootstrap":
            continue
        uses = users.get(op.result, [])
        if not uses:
            continue
        minf = None
        for u in uses:
            if u is _RET or u.opcode != "modswitch":
                minf = 0
                break
            f = u.attrs["downFactor"]
            minf = f if minf is None else min(minf, f)
        if not minf:
            continue
        op.attrs["targetLevel"] = op.attrs.get("targetLevel", 0) + minf
        op.set_ty(op.ty.switch_level(op.ty.level + minf))
        for u in uses:
            u.attrs["downFactor"] -= minf
    return fn
