"""Tracing frontend: the `hc.*` user-facing DSL (copy of dacapo_tpu/ir/trace.py).

API-compatible with the reference's hecate.expr (python/hecate/hecate/
expr.py): `@func("c")` decorators, `Plain`, `Empty`, operator overloading,
`rotate`, `bootstrap`, `save`. Instead of ctypes calls into an MLIR builder
(tools/frontend.cpp), tracing builds the pure-python Earth IR directly; the
trace-time cleanup pipeline (CSE -> canonicalize -> elide constants ->
privatize constants -> canonicalize, frontend.cpp:123-147) runs at save().

Source locations are captured with sys._getframe (the reference's
inspect.stack() walk is the dominant cost of its tracing hot loop).
"""

import os
import sys

import numpy as np

from .earth import Function, Op, ScaleType, Value


class TraceModule:
    def __init__(self):
        self.funcs = []           # list[Func] (tracer wrappers)

    def reset(self):
        self.funcs = []


_module = TraceModule()


def _loc(depth=2):
    f = sys._getframe(depth)
    return (f.f_code.co_filename, f.f_lineno)


class _TraceState:
    current: Function = None


def _emit(opcode, operands, attrs=None, loc=None):
    fn = _TraceState.current
    assert fn is not None, "op traced outside @func body evaluation"
    op = Op(opcode, [e.value for e in operands], attrs or {}, None, loc or _loc(3))
    from .earth import infer_type
    op.set_ty(infer_type(op))
    fn.ops.append(op)
    return Expr(op.result)


class Expr:
    __slots__ = ("value",)

    # Make `ndarray <op> Expr` defer to our reflected operators (one Plain
    # constant for the whole array) instead of numpy broadcasting the Expr
    # elementwise into an object array.
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, value: Value):
        self.value = value

    # copying a traced handle is forbidden, like the reference metaclass
    def __copy__(self):
        raise Exception("Copying traced objects is forbidden")

    def __deepcopy__(self, memo):
        raise Exception("Copying traced objects is forbidden")

    def __add__(self, other):
        if isinstance(other, Empty):     # additive identity (MPCB padding)
            return self
        return _emit("add", (self, resolve(other)))

    def __radd__(self, other):
        if isinstance(other, Empty):
            return self
        return _emit("add", (resolve(other), self))

    def __sub__(self, other):
        if isinstance(other, Empty):
            return self
        o = resolve(other)
        return _emit("add", (self, _emit("negate", (o,))))

    def __rsub__(self, other):
        if isinstance(other, Empty):
            return _emit("negate", (self,))
        o = resolve(other)
        return _emit("add", (o, _emit("negate", (self,))))

    def __mul__(self, other):
        return _emit("mul", (self, resolve(other)))

    def __rmul__(self, other):
        return _emit("mul", (resolve(other), self))

    def __neg__(self):
        return _emit("negate", (self,))

    def rotate(self, offset):
        return _emit("rotate", (self,), {"offset": int(offset)})

    def bootstrap(self):
        return _emit("bootstrap", (self,), {"targetLevel": 0})

    __iadd__ = __add__
    __isub__ = __sub__
    __imul__ = __mul__


def bootstrap(x):
    """Free-function bootstrap like the reference's unaryFactory global.

    On iterables the reference (expr.py:115-127) creates bootstrap ops but
    drops their results (rebinding the loop variable) — harmless only because
    --dacapo strips user bootstraps. Here containers map properly.
    """
    if isinstance(x, Expr):
        return x.bootstrap()
    out = [t.bootstrap() for t in x]
    if isinstance(x, np.ndarray):
        arr = np.empty(len(out), dtype=object)
        arr[:] = out
        return arr
    return type(x)(out) if isinstance(x, (list, tuple)) else out


def resolve(other):
    if isinstance(other, Expr):
        return other
    if isinstance(other, (int, float, np.integer, np.floating)):
        return Plain(np.array([float(other)], dtype=np.float64))
    if isinstance(other, (list, tuple)):
        return Plain(np.asarray(other, dtype=np.float64))
    if isinstance(other, np.ndarray):
        return Plain(other)
    try:
        import torch
        if isinstance(other, torch.Tensor):
            return Plain(np.asarray(torch.flatten(other).tolist(), dtype=np.float64))
    except ImportError:
        pass
    raise Exception(f"Cannot create compatible type for {type(other)}")


class Plain(Expr):
    def __init__(self, data, scale=40):
        arr = np.asarray(data, dtype=np.float64).ravel()
        rms = float(np.sqrt(np.mean(arr * arr))) if arr.size else 0.0
        fn = _TraceState.current
        op = Op("constant", [], {"value": arr, "rms_var": rms}, ScaleType(False, 0, 0), _loc(2))
        fn.ops.append(op)
        super().__init__(op.result)


class Empty:
    """Additive identity placeholder (reference expr.py:276-290).

    Outside an active trace (plain-numpy evaluation of the MPCB closures,
    used by the golden tests) operands pass through unchanged instead of
    becoming constants.
    """

    __array_ufunc__ = None
    __array_priority__ = 1000

    def __add__(self, other):
        if isinstance(other, Expr) or _TraceState.current is None:
            return other
        return resolve(other)

    __radd__ = __add__
    __iadd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Expr) or _TraceState.current is None:
            return -other
        return -resolve(other)

    def __rsub__(self, other):
        if isinstance(other, Expr) or _TraceState.current is None:
            return other
        return resolve(other)

    __isub__ = __sub__


class Func:
    def __init__(self, fun, paramstr, loc):
        self.fun = fun
        self.name = fun.__name__
        self.input_is_cipher = [a.strip() == "c" for a in paramstr.split(",")]
        self.loc = loc
        self.traced: Function = None

    def eval(self):
        args = [
            Value(ScaleType(is_c, 0, 0), arg_index=i)
            for i, is_c in enumerate(self.input_is_cipher)
        ]
        fn = Function(self.name, args)
        _TraceState.current = fn
        try:
            rets = self.fun(*[Expr(a) for a in args])
        finally:
            _TraceState.current = None
        if not isinstance(rets, (list, tuple)):
            rets = [rets]
        fn.returns = [r.value for r in rets]
        self.traced = fn
        return fn

    def __call__(self, *args):
        raise NotImplementedError(
            "function calls are unsupported (reference frontend.cpp declares "
            "createCall but never implements it; multi-function programs "
            "are unsupported there too)"
        )


def func(param):
    def deco(f):
        fobj = Func(f, param, _loc(2))
        _module.funcs.append(fobj)
        return fobj
    return deco


def save(dirs="", cst_dirs=""):
    """Trace all registered functions and write artifacts.

    Writes <dirs>/<Name>.eir.json (serialized Earth IR) and
    <cst_dirs>/_hecate_<Name>.cst (reference-binary-compatible constants,
    lib/Dialect/Earth/Transforms/ElideConstant.cpp:40-53), plus a readable
    <dirs>/<Name>.earth.mlir dump.
    """
    from ..passes.rewrite import cse, canonicalize, elide_constants, privatize_constants
    from .serialize import save_function, write_cst

    dirs = dirs or os.getcwd()
    cst_dirs = cst_dirs or os.getcwd()
    os.makedirs(dirs, exist_ok=True)
    os.makedirs(cst_dirs, exist_ok=True)
    out = None
    for fobj in _module.funcs:
        fn = fobj.eval()
        cse(fn)
        canonicalize(fn)
        payloads = elide_constants(fn)
        privatize_constants(fn)
        canonicalize(fn)
        write_cst(payloads, os.path.join(cst_dirs, f"_hecate_{fn.name}.cst"))
        out = save_function(fn, os.path.join(dirs, f"{fn.name}.eir.json"))
        with open(os.path.join(dirs, f"{fn.name}.earth.mlir"), "w") as f:
            f.write(fn.dump())
    _module.reset()
    return out
