"""Earth IR (de)serialization + reference-compatible constant files (.cst).

Port of dacapo_tpu/ir/serialize.py in pure Python (the reference's native
.cst fast path writes the same bytes). .cst layout (reference
lib/Dialect/Earth/Transforms/ElideConstant.cpp:40-53 write side,
lib/Runtime/SEAL_HEVM.cpp:182-200 read side):
    int64 count, then per constant: int64 len, f64 data[len].
"""

import hashlib
import json
import struct

import numpy as np

from .earth import Function, Op, ScaleType, Value


def write_cst(payloads, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<q", len(payloads)))
        for arr in payloads:
            a = np.asarray(arr, dtype="<f8").ravel()
            f.write(struct.pack("<q", a.size))
            f.write(a.tobytes())


def read_cst(path):
    out = []
    with open(path, "rb") as f:
        (count,) = struct.unpack("<q", f.read(8))
        for _ in range(count):
            (ln,) = struct.unpack("<q", f.read(8))
            out.append(np.frombuffer(f.read(8 * ln), dtype="<f8").copy())
    return out


def _ty_json(ty: ScaleType):
    return [1 if ty.is_cipher else 0, ty.scale, ty.level]


def _ty_from(j):
    return ScaleType(bool(j[0]), j[1], j[2])


def save_function(fn: Function, path: str) -> str:
    ids = {}
    for i, a in enumerate(fn.args):
        ids[a] = -1 - i  # args get negative ids
    ops_json = []
    for i, op in enumerate(fn.ops):
        ids[op.result] = i
        attrs = {k: v for k, v in op.attrs.items() if k != "value"}
        assert "value" not in op.attrs or "cst_index" in op.attrs, \
            "constants must be elided before serialization"
        ops_json.append(
            dict(
                op=op.opcode,
                args=[ids[v] for v in op.operands],
                attrs=attrs,
                ty=_ty_json(op.ty),
                loc=list(op.loc) if op.loc else None,
            )
        )
    doc = dict(
        name=fn.name,
        num_args=len(fn.args),
        arg_types=[_ty_json(a.ty) for a in fn.args],
        ops=ops_json,
        returns=[ids[v] for v in fn.returns],
        attrs=fn.attrs,
    )
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def load_function(path: str) -> Function:
    with open(path) as f:
        doc = json.load(f)
    args = [
        Value(_ty_from(t), arg_index=i) for i, t in enumerate(doc["arg_types"])
    ]
    vals = {-1 - i: a for i, a in enumerate(args)}
    ops = []
    for i, oj in enumerate(doc["ops"]):
        op = Op(
            oj["op"], [vals[a] for a in oj["args"]], dict(oj["attrs"]),
            _ty_from(oj["ty"]), tuple(oj["loc"]) if oj.get("loc") else None,
        )
        vals[i] = op.result
        ops.append(op)
    attrs = dict(doc.get("attrs", {}))
    if "arg_attrs" in attrs:   # JSON stringifies the int arg-index keys
        attrs["arg_attrs"] = {int(k): v for k, v in attrs["arg_attrs"].items()}
    return Function(
        doc["name"], args, ops, [vals[r] for r in doc["returns"]], attrs,
    )


def function_digest(path: str) -> str:
    """SHA-256 of a saved .eir.json with every op's source location dropped:
    locations name the files of the package that traced it, so only this
    digest can agree between checkouts, and between the JAX package's tracer
    and the port's."""
    with open(path) as f:
        doc = json.load(f)
    for op in doc["ops"]:
        op["loc"] = None
    return hashlib.sha256(json.dumps(doc).encode()).hexdigest()
