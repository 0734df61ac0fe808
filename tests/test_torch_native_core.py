"""The port's native artifact core (dacapo_tpu_torch/vm/native.py over its
copy csrc/hevm_core.cpp) against the port's pure-Python path and the JAX
package's native core, the counterpart of every case of
tests/test_native_core.py: .hevm/.cst round trips native against Python,
validation codes, register-reuse compaction (symbolically, and a compacted
compiled program the port's executor runs bit-equal to the original), the
bytes the two packages' native writers produce, and DACAPO_TPU_NO_NATIVE
selecting the pure-Python path."""

import struct

import numpy as np
import pytest
import torch

from dacapo_tpu.ir.serialize import write_cst as ref_write_cst
from dacapo_tpu.vm import native as ref_native
from dacapo_tpu.vm.hevm import HEVMOp as RefOp, HEVMProgram as RefProgram
from dacapo_tpu_torch.crypto.params import COMPILER_PROFILES
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.ir import trace as hc
from dacapo_tpu_torch.ir.config import load_profile
from dacapo_tpu_torch.ir.serialize import read_cst, write_cst
from dacapo_tpu_torch.passes.pipeline import compile_function
from dacapo_tpu_torch.passes.rewrite import canonicalize, cse, elide_constants
from dacapo_tpu_torch.vm import native
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import (
    HEVMOp, HEVMProgram, OP_ADDCC, OP_ADDCP, OP_ALLOC, OP_ENCODE, OP_MULCC,
    OP_RESCALE, OP_ROTATE,
)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _toy_program(cls=HEVMProgram, op=HEVMOp):
    """tests/test_native_core.py:_toy_program: 2 args, r2=a0*a1,
    r3=rescale(r2), r4=rot(r3)+p0, out r4."""
    p = cls()
    p.arg_scale, p.arg_level = [40, 40], [2, 2]
    p.res_scale, p.res_level, p.res_dst = [40], [4], [4]
    p.init_level = 6
    p.num_ctxt, p.num_ptxt = 5, 1
    p.ops = [
        op(OP_ENCODE, 0, 0, (3 << 10) | 40),
        op(OP_ALLOC), op(OP_MULCC, 2, 0, 1),
        op(OP_ALLOC), op(OP_RESCALE, 3, 2),
        op(OP_ALLOC), op(OP_ROTATE, 4, 3, 5),
        op(OP_ADDCP, 4, 4, 0),
    ]
    return p


def _fields(p):
    return ([(o.opcode, o.dst, o.lhs, o.rhs) for o in p.ops],
            (p.arg_scale, p.arg_level, p.res_scale, p.res_level, p.res_dst,
             p.init_level, p.num_ctxt, p.num_ptxt))


def _run_symbolic(prog):
    regs = {i: ("arg", i) for i in range(prog.arg_length)}
    for op in prog.ops:
        if op.opcode == OP_ALLOC:
            continue
        if op.opcode == OP_ROTATE:
            regs[op.dst] = ("rot", regs[op.lhs], op.rhs)
        elif op.opcode == OP_MULCC:
            regs[op.dst] = ("mul", regs[op.lhs], regs[op.rhs])
        else:
            assert op.opcode == OP_ADDCC
            regs[op.dst] = ("add", regs[op.lhs], regs[op.rhs])
    return [regs[r] for r in prog.res_dst]


def test_native_core_builds_into_the_package_build_dir():
    assert native.get_lib() is not None
    lib = native.BUILD_INFO["library"]
    assert "dacapo_tpu_torch/build/libhevm_core_" in lib.replace("\\", "/")
    assert native.SOURCE.read_bytes() == (native._PKG.parent / "native"
                                          / "hevm_core.cpp").read_bytes()


def test_hevm_roundtrip_native_vs_python(tmp_path):
    p = _toy_program()
    f1, f2 = str(tmp_path / "a.hevm"), str(tmp_path / "b.hevm")
    before = dict(native.CALLS)
    assert native.save_program(p, f1)                 # native write
    p._save_py(f2)                                    # python write
    assert _bytes(f1) == _bytes(f2)
    ln = native.load_program(f1, HEVMProgram, HEVMOp)  # native read
    lp = HEVMProgram._load_py(f2)                     # python read
    assert _fields(ln) == _fields(p) == _fields(lp)
    assert native.CALLS["hevm_save"] == before["hevm_save"] + 1
    assert native.CALLS["hevm_load"] == before["hevm_load"] + 1
    # HEVMProgram.save/load take the native path
    p.save(str(tmp_path / "c.hevm"))
    assert _fields(HEVMProgram.load(str(tmp_path / "c.hevm"))) == _fields(p)
    assert native.CALLS["hevm_save"] == before["hevm_save"] + 2
    assert native.CALLS["hevm_load"] == before["hevm_load"] + 2


def test_cst_roundtrip_native_vs_python(tmp_path):
    rng = np.random.default_rng(0)
    payloads = [rng.normal(size=n) for n in (4, 1, 257, 0)]
    f1, f2 = str(tmp_path / "a.cst"), str(tmp_path / "b.cst")
    before = native.CALLS["cst_save"]
    write_cst(payloads, f1)                           # native (the default)
    assert native.CALLS["cst_save"] == before + 1
    with open(f2, "wb") as f:                         # the layout, by hand
        f.write(struct.pack("<q", len(payloads)))
        for arr in payloads:
            a = np.asarray(arr, dtype="<f8").ravel()
            f.write(struct.pack("<q", a.size))
            f.write(a.tobytes())
    assert _bytes(f1) == _bytes(f2)
    for got in (native.read_cst_native(f1), read_cst(f2)):
        assert len(got) == len(payloads)
        for g, w in zip(got, payloads):
            np.testing.assert_array_equal(g, w)


def test_validate_catches_malformed_streams():
    p = _toy_program()
    before = native.CALLS["hevm_validate"]
    assert p.validate() == -1 == p._validate_py()
    bad = _toy_program()
    bad.ops[2] = HEVMOp(OP_MULCC, 2, 0, 4)            # rhs register never defined
    assert bad.validate() == 2 == bad._validate_py()
    bad2 = _toy_program()
    bad2.res_dst = [4, 9]
    bad2.res_scale, bad2.res_level = [40, 40], [4, 4]
    assert bad2.validate() == -2 == bad2._validate_py()
    assert native.CALLS["hevm_validate"] == before + 3


def test_reuse_compact_preserves_semantics():
    """A wasteful SSA stream (one fresh register per op) compacts to fewer
    registers, still validates, and keeps its dataflow."""
    p = HEVMProgram()
    p.arg_scale, p.arg_level = [40], [2]
    p.init_level = 6
    n = 12
    p.num_ctxt, p.num_ptxt = 1 + n, 0
    src = 0
    for i in range(n):
        p.ops += [HEVMOp(OP_ALLOC), HEVMOp(OP_ROTATE, 1 + i, src, i + 1)]
        src = 1 + i
    p.res_scale, p.res_level, p.res_dst = [40], [2], [src]
    assert p.validate() == -1
    q = p.reuse_compact()
    assert q.validate() == -1
    # serial rotate chain: each value dies at the next op -> 1 arg + 2 regs
    assert q.num_ctxt <= 3 < p.num_ctxt
    assert _run_symbolic(q) == _run_symbolic(p)


def test_reuse_compact_keeps_live_values_apart():
    p = HEVMProgram()
    p.arg_scale, p.arg_level = [40, 40], [2, 2]
    p.init_level = 6
    p.num_ctxt, p.num_ptxt = 6, 0
    p.ops = [
        HEVMOp(OP_ALLOC), HEVMOp(OP_ROTATE, 2, 0, 1),
        HEVMOp(OP_ALLOC), HEVMOp(OP_ROTATE, 3, 1, 2),
        HEVMOp(OP_ALLOC), HEVMOp(OP_MULCC, 4, 2, 3),
        HEVMOp(OP_ALLOC), HEVMOp(OP_ADDCC, 5, 4, 2),  # r2 still live here
    ]
    p.res_scale, p.res_level, p.res_dst = [40], [2], [5]
    q = p.reuse_compact()
    assert q.validate() == -1
    assert _run_symbolic(q) == _run_symbolic(p)


def test_native_writers_equal_to_the_jax_package(tmp_path):
    """The same program and constants through the port's native core and
    the JAX package's give the same bytes, and so does the compaction."""
    if ref_native.get_lib() is None:
        pytest.skip("the JAX package's native core did not build")
    mine, ref = _toy_program(), _toy_program(RefProgram, RefOp)
    f1, f2 = str(tmp_path / "port.hevm"), str(tmp_path / "jax.hevm")
    assert native.save_program(mine, f1) and ref_native.save_program(ref, f2)
    assert _bytes(f1) == _bytes(f2)
    compact = mine.reuse_compact()
    compact.save(f1)
    ref.reuse_compact().save(f2)
    assert _bytes(f1) == _bytes(f2)
    assert _fields(compact) == _fields(ref.reuse_compact())
    payloads = [np.random.default_rng(1).normal(size=n) for n in (3, 0, 64)]
    c1, c2 = str(tmp_path / "port.cst"), str(tmp_path / "jax.cst")
    write_cst(payloads, c1)
    ref_write_cst(payloads, c2)
    assert _bytes(c1) == _bytes(c2)


def test_no_native_env_selects_the_python_path(tmp_path, monkeypatch):
    monkeypatch.setenv("DACAPO_TPU_NO_NATIVE", "1")
    assert native.get_lib() is None
    before = dict(native.CALLS)
    p = _toy_program()
    path = str(tmp_path / "p.hevm")
    p.save(path)
    assert _fields(HEVMProgram.load(path)) == _fields(p)
    assert p.validate() == -1
    assert p.reuse_compact() is p
    write_cst([np.arange(3.0)], str(tmp_path / "c.cst"))
    np.testing.assert_array_equal(read_cst(str(tmp_path / "c.cst"))[0], np.arange(3.0))
    assert native.CALLS == before
    monkeypatch.delenv("DACAPO_TPU_NO_NATIVE")
    npath = str(tmp_path / "n.hevm")
    assert native.save_program(p, npath)
    assert _bytes(path) == _bytes(npath)


def test_compiled_program_native_reuse_runs_bit_equal():
    """A program the port traces and compiles, compacted natively, runs
    through the port's executor bit-equal to the original on the same
    ciphertext, and near the plaintext model."""
    profile = "test_n10"
    load_profile(COMPILER_PROFILES[profile])
    s = Scheme(profile, device="cpu")
    s.generate_keys(rot_steps=(1, 2))
    n = s.ctx.config.n_slots
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.3, n)

    def model(x):
        t = x.rotate(1) * hc.Plain(w)
        u = x.rotate(2) + t
        return u * u

    hc._module.reset()
    fn = hc.func("c")(model).eval()
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    prog = compile_function(fn, "pars", 25)
    assert prog.validate() == -1
    compact = prog.reuse_compact()
    assert compact.validate() == -1
    assert compact.num_ctxt <= prog.num_ctxt

    x = rng.uniform(-0.5, 0.5, n)
    golden = (np.roll(x, -2) + np.roll(x, -1) * w) ** 2
    nl = (prog.arg_level[0] + 1) * s.ctx.config.rescale_rows
    ct = s.encrypt(x, scale=float(2.0 ** prog.arg_scale[0]), nl=nl)
    outs = []
    for pr in (prog, compact):
        ex = HEVMExecutor(s, pr, payloads)
        ex.preprocess()
        outs.append(ex.run_encrypted([(ct.data, nl, ct.scale)], jit=False))
    (a, meta_a), (b, meta_b) = outs
    assert meta_a == meta_b
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    ex.run_encrypted([(ct.data, nl, ct.scale)], jit=False)
    got = ex.decrypt_outputs()[0]
    assert np.sqrt(np.mean((got - golden) ** 2)) < 5e-3
