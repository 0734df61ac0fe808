"""HEVM bytecode: binary-compatible with the reference .hevm format.

Copy of dacapo_tpu/vm/hevm.py with the pure-Python reader, writer and
validator only (the reference's optional ctypes core is not ported).

Layout (include/hecate/Support/HEVMHeader.h:10-35, write side
lib/Dialect/CKKS/Transforms/EmitHEVM.cpp:109-119, read side
lib/Runtime/SEAL_HEVM.cpp:202-234):

    HEVMHeader { u32 magic=0x4845564D; u32 hevm_header_size;
                 u64 arg_length; u64 res_length; }
    ConfigBody { u64 config_body_length; u64 num_operations;
                 u64 num_ctxt_buffer; u64 num_ptxt_buffer; u64 init_level; }
    u64 arg_scale[arg], arg_level[arg], res_scale[res], res_level[res],
    u64 res_dst[res]
    HEVMOperation { u16 opcode, dst, lhs, rhs } * num_operations

Opcodes (CKKSOps.td:26-224): 0 encode, 1 rotatec, 2 negatec, 3 rescalec,
4 modswitchc, 5 upscalec, 6 addcc, 7 addcp, 8 mulcc, 9 mulcp, 10 bootstrapc;
0xFFFF = buffer-alloc marker (tensor.empty), skipped by interpreters.
"""

import struct
from dataclasses import dataclass, field

MAGIC = 0x4845564D
OP_ENCODE, OP_ROTATE, OP_NEGATE, OP_RESCALE, OP_MODSWITCH, OP_UPSCALE = range(6)
OP_ADDCC, OP_ADDCP, OP_MULCC, OP_MULCP, OP_BOOTSTRAP = range(6, 11)
OP_ALLOC = 0xFFFF

OP_NAMES = {
    0: "encode", 1: "rotatec", 2: "negatec", 3: "rescalec", 4: "modswitchc",
    5: "upscalec", 6: "addcc", 7: "addcp", 8: "mulcc", 9: "mulcp",
    10: "bootstrapc", OP_ALLOC: "alloc",
}


@dataclass
class HEVMOp:
    opcode: int
    dst: int = 0
    lhs: int = 0
    rhs: int = 0
    # index into the on-disk op stream (set by fuse.ssa_expand) — links the
    # runtime op back to compile-time per-op metadata (scale-steering Ks,
    # vm/steer.py); NOT serialized.
    orig: int = -1


@dataclass
class HEVMProgram:
    arg_scale: list = field(default_factory=list)
    arg_level: list = field(default_factory=list)
    res_scale: list = field(default_factory=list)
    res_level: list = field(default_factory=list)
    res_dst: list = field(default_factory=list)
    init_level: int = 0
    num_ctxt: int = 0
    num_ptxt: int = 0
    ops: list = field(default_factory=list)

    @property
    def arg_length(self):
        return len(self.arg_scale)

    @property
    def res_length(self):
        return len(self.res_scale)

    def rotation_offsets(self):
        return sorted({op.rhs for op in self.ops if op.opcode == OP_ROTATE})

    def save(self, path):
        return self._save_py(path)

    def _save_py(self, path):
        hdr_size = 24
        body_ints = (
            list(self.arg_scale) + list(self.arg_level)
            + list(self.res_scale) + list(self.res_level) + list(self.res_dst)
        )
        body_len = 40 + 8 * len(body_ints)
        with open(path, "wb") as f:
            f.write(struct.pack("<IIQQ", MAGIC, hdr_size,
                                self.arg_length, self.res_length))
            f.write(struct.pack("<QQQQQ", body_len, len(self.ops),
                                self.num_ctxt, self.num_ptxt, self.init_level))
            for x in body_ints:
                f.write(struct.pack("<Q", int(x)))
            for op in self.ops:
                f.write(struct.pack("<HHHH", op.opcode & 0xFFFF, op.dst & 0xFFFF,
                                    op.lhs & 0xFFFF, op.rhs & 0xFFFF))
        return path

    @classmethod
    def load(cls, path):
        return cls._load_py(path)

    @classmethod
    def _load_py(cls, path):
        p = cls()
        with open(path, "rb") as f:
            magic, hdr_size, argn, resn = struct.unpack("<IIQQ", f.read(24))
            if magic != MAGIC:
                raise ValueError(f"{path}: not a .hevm file (magic {magic:#x})")
            body_len, nops, nct, npt, init_level = struct.unpack("<QQQQQ", f.read(40))
            p.num_ctxt, p.num_ptxt, p.init_level = nct, npt, init_level

            def read_u64s(n):
                return list(struct.unpack(f"<{n}Q", f.read(8 * n))) if n else []

            p.arg_scale = read_u64s(argn)
            p.arg_level = read_u64s(argn)
            p.res_scale = read_u64s(resn)
            p.res_level = read_u64s(resn)
            p.res_dst = read_u64s(resn)
            for _ in range(nops):
                oc, dst, lhs, rhs = struct.unpack("<HHHH", f.read(8))
                p.ops.append(HEVMOp(oc, dst, lhs, rhs))
        return p

    def validate(self):
        """-1 if the stream is well-formed, else the index of the first bad
        op (-2: bad result descriptor)."""
        return self._validate_py()

    def _validate_py(self):
        nct, npt = self.num_ctxt, self.num_ptxt
        cdef = [False] * nct
        pdef = [False] * npt
        for i in range(min(self.arg_length, nct)):
            cdef[i] = True
        two_c = (OP_ADDCC, OP_MULCC)
        c_p = (OP_ADDCP, OP_MULCP)
        unary = (OP_ROTATE, OP_NEGATE, OP_RESCALE, OP_MODSWITCH,
                 OP_UPSCALE, OP_BOOTSTRAP)
        for i, op in enumerate(self.ops):
            if op.opcode == OP_ALLOC:
                continue
            if op.opcode == OP_ENCODE:
                if op.dst >= npt:
                    return i
                pdef[op.dst] = True
            elif op.opcode in unary:
                if op.dst >= nct or op.lhs >= nct or not cdef[op.lhs]:
                    return i
                cdef[op.dst] = True
            elif op.opcode in two_c:
                if (op.dst >= nct or op.lhs >= nct or op.rhs >= nct
                        or not cdef[op.lhs] or not cdef[op.rhs]):
                    return i
                cdef[op.dst] = True
            elif op.opcode in c_p:
                if (op.dst >= nct or op.lhs >= nct or op.rhs >= npt
                        or not cdef[op.lhs] or not pdef[op.rhs]):
                    return i
                cdef[op.dst] = True
            else:
                return i
        for r in self.res_dst:
            if r >= nct or not cdef[r]:
                return -2
        return -1

    def dump(self, limit=None):
        lines = [
            f"hevm: args={self.arg_length} res={self.res_length} "
            f"ctxt={self.num_ctxt} ptxt={self.num_ptxt} init_level={self.init_level}"
        ]
        for i, op in enumerate(self.ops[: limit or len(self.ops)]):
            lines.append(f"  {i:5d}: {OP_NAMES.get(op.opcode, op.opcode):10s} "
                         f"d{op.dst} l{op.lhs} r{op.rhs}")
        return "\n".join(lines)
