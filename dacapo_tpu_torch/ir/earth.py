"""Earth-equivalent scale-aware SSA IR (copy of dacapo_tpu/ir/earth.py).

Mirrors the reference's Earth dialect semantics (include/hecate/Dialect/Earth/
IR/EarthOps.td, lib/Dialect/Earth/IR/EarthDialect.cpp:182-334) with a
lightweight object IR:

* Types carry (is_cipher, scale, level): `ci<scale*level>` / `pl<scale*level>`
  where `level` counts rescales performed (0 = fresh).
* Ops: constant, rotate, negate, bootstrap, rescale, modswitch, upscale,
  apply_schedule, add, mul. Single result each, held in topological order in a
  single-block Func.
* Scale-management walks rebuild the op list forward, applying a running
  substitution — equivalent to MLIR's insert-before + replaceAllUsesExcept.
"""

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ScaleType:
    is_cipher: bool
    scale: int
    level: int

    def switch_scale(self, scale):
        return replace(self, scale=scale)

    def switch_level(self, level):
        return replace(self, level=level)

    def to_cipher(self):
        return replace(self, is_cipher=True)

    def to_plain(self):
        return replace(self, is_cipher=False)

    def __str__(self):
        k = "ci" if self.is_cipher else "pl"
        return f"!earth.{k}<{self.scale}*{self.level}>"


class Value:
    __slots__ = ("ty", "def_op", "arg_index")

    def __init__(self, ty, def_op=None, arg_index=None):
        self.ty = ty
        self.def_op = def_op
        self.arg_index = arg_index

    @property
    def is_arg(self):
        return self.arg_index is not None


# opcode -> is_consume (burns a level budget like mul) ; is rotate noisy etc.
OPNAMES = (
    "constant", "rotate", "negate", "bootstrap", "rescale", "modswitch",
    "upscale", "apply_schedule", "add", "mul",
)


class Op:
    __slots__ = ("opcode", "operands", "attrs", "result", "loc")

    def __init__(self, opcode, operands, attrs=None, result_ty=None, loc=None):
        self.opcode = opcode
        self.operands = list(operands)
        self.attrs = attrs or {}
        self.result = Value(result_ty, def_op=self)
        self.loc = loc

    @property
    def ty(self):
        return self.result.ty

    def set_ty(self, ty):
        self.result.ty = ty

    def is_single(self):
        """Reference isSingle(): op involves at most one cipher operand."""
        if self.opcode in ("add", "mul"):
            return not all(v.ty.is_cipher for v in self.operands)
        return True

    def is_consume(self):
        return self.opcode == "mul"

    def __repr__(self):
        return f"{self.opcode}({len(self.operands)})->{self.ty}"


@dataclass
class Function:
    name: str
    args: list                      # list[Value] (arg_index set)
    ops: list = field(default_factory=list)     # list[Op] topo order
    returns: list = field(default_factory=list)  # list[Value]
    attrs: dict = field(default_factory=dict)

    def clone(self):
        """Deep-copy (new Value/Op objects), preserving attrs per-op."""
        vmap = {}
        new_args = []
        for a in self.args:
            na = Value(a.ty, arg_index=a.arg_index)
            vmap[a] = na
            new_args.append(na)
        new_ops = []
        for op in self.ops:
            nop = Op(op.opcode, [vmap[v] for v in op.operands], dict(op.attrs),
                     op.ty, op.loc)
            vmap[op.result] = nop.result
            new_ops.append(nop)
        return Function(
            self.name, new_args, new_ops, [vmap[v] for v in self.returns],
            dict(self.attrs),
        ), vmap

    def verify(self, config=None):
        """Type verification mirroring the reference's infer-type rules."""
        seen = set(self.args)
        for op in self.ops:
            for v in op.operands:
                assert v in seen, f"operand not dominated at {op}"
            ty = infer_type(op, config)
            assert ty is not None, f"type inference failed for {op.opcode}: " + ", ".join(
                str(v.ty) for v in op.operands
            )
            assert ty == op.ty, f"type mismatch for {op.opcode}: {ty} vs {op.ty}"
            seen.add(op.result)
        for v in self.returns:
            assert v in seen

    def dump(self, max_ops=None):
        lines = [f"func @{self.name}({', '.join(str(a.ty) for a in self.args)}) {self.attrs}"]
        ids = {a: f"%arg{i}" for i, a in enumerate(self.args)}
        for i, op in enumerate(self.ops):
            ids[op.result] = f"%{i}"
            if max_ops and i >= max_ops:
                continue
            args = ", ".join(ids[v] for v in op.operands)
            at = {k: v for k, v in op.attrs.items() if k != "value"}
            lines.append(f"  %{i} = earth.{op.opcode}({args}) {at} : {op.ty}")
        lines.append("  return " + ", ".join(ids[v] for v in self.returns))
        return "\n".join(lines)


def infer_type(op, config=None):
    """Return the inferred result type, or None on failure.

    Mirrors EarthDialect.cpp:182-334; `config` supplies rescalingFactor and
    bootstrap bounds (defaults to the registered global config).
    """
    from .config import current_config

    cfg = config or current_config()
    rf = cfg.rescaling_factor
    o = [v.ty for v in op.operands]
    oc = op.opcode
    if oc == "constant":
        return op.ty if op.ty is not None else ScaleType(False, 0, 0)
    if oc == "rescale":
        return o[0].switch_level(o[0].level + 1).switch_scale(o[0].scale - rf)
    if oc == "modswitch":
        d = op.attrs["downFactor"]
        return o[0].switch_level(o[0].level + d) if d >= 0 else None
    if oc == "upscale":
        u = op.attrs["upFactor"]
        return o[0].switch_scale(o[0].scale + u) if u >= 0 else None
    if oc == "bootstrap":
        if o[0].level <= cfg.bootstrap_level_upper - cfg.bootstrap_level_lower:
            return o[0].switch_level(op.attrs.get("targetLevel", 0))
        return None
    if oc in ("rotate", "negate", "apply_schedule"):
        return o[0]
    if oc == "add":
        if o[0].level == o[1].level and o[0].scale == o[1].scale:
            return o[0].to_cipher()
        return None
    if oc == "mul":
        if o[0].level == o[1].level and (
            cfg.bootstrap_level_upper * rf >= o[0].level * rf + o[0].scale
        ):
            return o[0].switch_scale(o[0].scale + o[1].scale).to_cipher()
        return None
    raise ValueError(f"unknown opcode {oc}")
