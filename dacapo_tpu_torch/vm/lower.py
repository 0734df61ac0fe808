"""Lowering: managed Earth IR -> HEVM bytecode program (copy of dacapo_tpu/vm/lower.py).

Combines the reference's EarthToCKKS conversion (lib/Conversion/EarthToCKKS/
EarthToCKKS.cpp:146-338), RemoveLevel, liveness-based ReuseBuffer
(lib/Dialect/CKKS/Transforms/ReuseBuffer.cpp:27-55), and EmitHEVM register
assignment (EmitHEVM.cpp:28-120) into one walk over the python IR.

Differences from the reference, by design:
* upscale lowers to the native upscalec opcode (our VM implements exact
  scalar 2^k multiplication) instead of UpscaleToMulcp's encode(ones)+mulcp;
  `lower(..., upscale_to_mulcp=True)` reproduces the reference behavior for
  artifact-level parity.
* Levels: earth level l -> hevm "levels-remaining" init_level - l
  (PolyTypeConverter.cpp:46-53 semantics).
"""

from ..ir.earth import Function
from ..ir.config import current_config
from .hevm import (
    HEVMOp, HEVMProgram, OP_ENCODE, OP_ROTATE, OP_NEGATE, OP_RESCALE,
    OP_MODSWITCH, OP_UPSCALE, OP_ADDCC, OP_ADDCP, OP_MULCC, OP_MULCP,
    OP_BOOTSTRAP, OP_ALLOC,
)


def lower(fn: Function, config=None, upscale_to_mulcp=False, reuse_buffers=True):
    cfg = config or current_config()
    init_level = fn.attrs.get("init_level")
    assert init_level is not None, "run a scale-management pipeline before lowering"
    n_slots = cfg.polynomial_degree // 2

    def hevm_level(ty):
        if cfg.bootstrap_level_lower > 0:
            return init_level - ty.level
        return cfg.bootstrap_level_upper - ty.level

    prog = HEVMProgram(init_level=init_level)

    # --- liveness (last textual use) for cipher register reuse
    last_use = {}
    for i, op in enumerate(fn.ops):
        for v in op.operands:
            last_use[v] = i
    for v in fn.returns:
        last_use[v] = len(fn.ops) + 1  # results live to the end

    reg_of = {}          # Value -> ('c'|'p', reg)
    free_ciphers = []
    n_cipher = 0
    n_plain = 0

    def alloc_cipher():
        nonlocal n_cipher
        if reuse_buffers and free_ciphers:
            return free_ciphers.pop()
        prog.ops.append(HEVMOp(OP_ALLOC))
        n_cipher += 1
        return n_cipher - 1

    def alloc_plain():
        nonlocal n_plain
        prog.ops.append(HEVMOp(OP_ALLOC))
        n_plain += 1
        return n_plain - 1

    # args occupy the first cipher registers (EmitHEVM walk order)
    for a in fn.args:
        assert a.ty.is_cipher, "plain args unsupported in HEVM emission"
        reg_of[a] = ("c", n_cipher)
        n_cipher += 1

    def cipher_reg(v):
        kind, r = reg_of[v]
        assert kind == "c", "expected cipher operand"
        return r

    def release(op_index, operands):
        if not reuse_buffers:
            return
        for v in operands:
            if last_use.get(v, -1) <= op_index and v in reg_of:
                kind, r = reg_of[v]
                if kind == "c" and r >= len(fn.args):
                    free_ciphers.append(r)
                    del reg_of[v]

    for i, op in enumerate(fn.ops):
        oc = op.opcode
        if oc == "constant":
            dst = alloc_plain()
            lv = hevm_level(op.ty)
            assert 0 <= op.ty.scale < 1024, f"encode scale {op.ty.scale} overflows rhs packing"
            prog.ops.append(HEVMOp(
                OP_ENCODE, dst, op.attrs["cst_index"], (lv << 10) | op.ty.scale))
            reg_of[op.result] = ("p", dst)
            continue

        if oc == "upscale" and upscale_to_mulcp:
            # reference UpscaleToMulcp.cpp:52-72: encode identity at
            # scale=upFactor (cst index 0xFFFF = ones), then mulcp
            pdst = alloc_plain()
            lv = hevm_level(op.operands[0].ty)
            prog.ops.append(HEVMOp(
                OP_ENCODE, pdst, 0xFFFF, (lv << 10) | op.attrs["upFactor"]))
            srcs = [cipher_reg(op.operands[0])]
            release(i, op.operands)
            dst = alloc_cipher()
            prog.ops.append(HEVMOp(OP_MULCP, dst, srcs[0], pdst))
            reg_of[op.result] = ("c", dst)
            continue

        # gather sources before releasing (release may free operand regs for dst)
        if oc in ("add", "mul"):
            kinds = [reg_of[v][0] for v in op.operands]
            regs = [reg_of[v][1] for v in op.operands]
            release(i, op.operands)
            dst = alloc_cipher()
            if kinds[0] == "c" and kinds[1] == "c":
                code = OP_ADDCC if oc == "add" else OP_MULCC
                prog.ops.append(HEVMOp(code, dst, regs[0], regs[1]))
            else:
                code = OP_ADDCP if oc == "add" else OP_MULCP
                c, p = (regs[0], regs[1]) if kinds[1] == "p" else (regs[1], regs[0])
                prog.ops.append(HEVMOp(code, dst, c, p))
            reg_of[op.result] = ("c", dst)
            continue

        src_kind, src = reg_of[op.operands[0]]
        if src_kind == "p":
            # management op on a plain value: fold at encode level is expected
            # after canonicalization; tolerate by re-encoding semantics
            raise AssertionError(f"{oc} on plain operand should have been folded")
        release(i, op.operands)
        dst = alloc_cipher()
        if oc == "rotate":
            prog.ops.append(HEVMOp(OP_ROTATE, dst, src, op.attrs["offset"] % n_slots))
        elif oc == "negate":
            prog.ops.append(HEVMOp(OP_NEGATE, dst, src))
        elif oc == "rescale":
            prog.ops.append(HEVMOp(OP_RESCALE, dst, src))
        elif oc == "modswitch":
            prog.ops.append(HEVMOp(OP_MODSWITCH, dst, src, op.attrs["downFactor"]))
        elif oc == "upscale":
            prog.ops.append(HEVMOp(OP_UPSCALE, dst, src, op.attrs["upFactor"]))
        elif oc == "bootstrap":
            prog.ops.append(HEVMOp(
                OP_BOOTSTRAP, dst, src, cfg.level_upper - op.ty.level))
        else:
            raise ValueError(f"cannot lower {oc}")
        reg_of[op.result] = ("c", dst)

    prog.num_ctxt = n_cipher
    prog.num_ptxt = n_plain
    prog.arg_scale = list(fn.attrs["arg_scale"])
    prog.arg_level = [init_level - l for l in fn.attrs["arg_level"]]
    prog.res_scale = list(fn.attrs["res_scale"])
    prog.res_level = [init_level - l for l in fn.attrs["res_level"]]
    prog.res_dst = [cipher_reg(v) for v in fn.returns]
    return prog
