"""Plaintext streaming on the CPU: the compact plaintext pool
(vm/executor.py preprocess over the plaintext budget), its on-device decode
(crypto/ops.py Evaluator.decode_plain), the in-graph decode of the segment
windows and the LRU of the per-op path, held bit for bit against the JAX
package run on the CPU from the same seeds and ciphertexts:

(a) decode_plain at batch 1 and 3, on Q rows and on QP rows, at scales 2^40
    and 2^95 (k > 0): equal to the JAX package's decode_plain and to the
    resident encode (host residues, then the port's NTT), as
    tests/test_ntt.py:71-90 holds the JAX decode;
(b) the mode: `_pt_budget` and `_streaming` equal to the JAX executor's on
    the same program and profile, with and without DACAPO_TPU_HBM_BYTES,
    and the budget rule at N = 2^14 .. 2^16 (16 GiB from N = 2^15 on a
    device that reports no memory);
(c) the StreamProbe program of tests/test_memory_streaming.py (test_n10),
    forced to stream by the same tiny `_pt_budget`: per-op (the LRU) equal
    to the JAX package's streaming per-op run, the segment path (in-graph
    decode) to its `_run_segmented` with `_pt_ingraph`, both to the port's
    resident run; at B=3 to the JAX package's run_encrypted_batch(mesh=None);
(d) a bootstrapped program streamed on the host-RNG oracle: equal to the
    JAX package with DACAPO_TPU_ORACLE_JIT=0;
(e) the LRU's bookkeeping: the device bytes stay within the budget after
    every insert but a single oversize one, and a hit moves to the end.
The graphs on the card are tests/test_torch_stream_cuda.py."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dacapo_tpu.crypto.encoding import Encoder as RefEncoder
from dacapo_tpu.crypto.ops import Evaluator as RefEvaluator
from dacapo_tpu.crypto.params import CKKSContext as RefContext, PROFILES as REF_PROFILES
from dacapo_tpu.ir import trace as trace_mod
from dacapo_tpu.ir.config import load_profile
from dacapo_tpu.passes.pipeline import compile_function
from dacapo_tpu.passes.rewrite import cse, canonicalize, elide_constants, privatize_constants
from dacapo_tpu.crypto.params import COMPILER_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram
import dacapo_tpu as hc
from dacapo_tpu_torch.crypto.encoding import Encoder
from dacapo_tpu_torch.crypto.ops import Evaluator
from dacapo_tpu_torch.crypto.params import CKKSContext, PROFILES
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP
from test_memory_streaming import _compile_rotation_program
from test_torch_batch import T, U, _dryrun_model, _encrypt_rows

B = 3


def _tiny_budget(ctx):
    """The budget tests/test_memory_streaming.py forces: two planes."""
    return 2 * ctx.n * 4


def _port(profile, path, payloads, budget=None, **kw):
    """A port executor on a fresh CPU keyset of `profile` (the JAX
    package's key draws), preprocessed; budget: the forced _pt_budget."""
    s = Scheme(profile, device="cpu")
    s.generate_keys()
    ex = HEVMExecutor(s, HEVMProgram.load(path), payloads, **kw)
    if budget is not None:
        ex._pt_budget = budget
    ex.preprocess()
    return ex


# ------------------------------------------------------------ (a) the decode
@pytest.fixture(scope="module")
def n11c():
    rc = RefContext(REF_PROFILES["test_n11c"])
    ctx = CKKSContext(PROFILES["test_n11c"], "cpu")
    return RefEncoder(rc), RefEvaluator(rc), Encoder(ctx), Evaluator(ctx)


@pytest.mark.parametrize("batch", [1, B])
@pytest.mark.parametrize("qp", [False, True], ids=["Q", "QP"])
@pytest.mark.parametrize("scale_bits", [40, 95])
def test_decode_plain_bit_equal_to_jax(n11c, batch, qp, scale_bits):
    ref_enc, ref_ev, enc, ev = n11c
    cfg = ev.ctx.config
    rng = np.random.default_rng(4 + batch)
    vals = [rng.uniform(-1, 1, cfg.n_slots)] + [
        rng.uniform(-3, 3, 32 * (i + 1)) for i in range(batch - 1)]
    scales = [2.0 ** scale_bits] * batch
    rows = list(range(6)) + ([cfg.num_q, cfg.num_q + 1] if qp else [])
    compact = ref_enc.encode_compact_batch(vals, scales)
    np.testing.assert_array_equal(enc.encode_compact_batch(vals, scales), compact)
    assert ((compact[:, 1] >> 24).max() > 0) == (scale_bits == 95)   # the 2^k path
    got = U(ev.decode_plain(T(compact), rows))
    assert got.shape == (batch, len(rows), ev.n)
    np.testing.assert_array_equal(got, np.asarray(ref_ev.decode_plain(jnp.asarray(compact), rows)))
    for i, (v, s) in enumerate(zip(vals, scales)):
        res = enc._rns_residues(enc._raw_coeffs(v) * s, 0,
                                primes=[ev.ctx.primes[r] for r in rows])
        np.testing.assert_array_equal(got[i], U(ev.ntt(T(res), rows)))


def test_decode_plain_refuses_other_records(n11c):
    ev = n11c[3]
    with pytest.raises(ValueError):
        ev.decode_plain(torch.zeros((1, 3, ev.n), dtype=torch.int32), [0])
    with pytest.raises(ValueError):
        ev.decode_plain(torch.zeros((1, 2, ev.n), dtype=torch.int64), [0])


# ----------------------------------------------------------- (c) StreamProbe
@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    ref, prog, payloads, x, want = _compile_rotation_program()
    path = str(tmp_path_factory.mktemp("probe") / "StreamProbe.hevm")
    prog._save_py(path)
    budget = _tiny_budget(ref.ctx)
    # the executor makes the galois keys before the encryptions draw
    rex = RefExecutor(ref, prog, payloads)
    rex._pt_budget = budget
    rex.preprocess()
    xs = np.random.default_rng(21).uniform(-1, 1, (B, ref.ctx.config.n_slots))
    cts, cts_t, nl, scale = _encrypt_rows(ref, prog, xs)
    assert rex._streaming and rex._pt_ingraph()
    arg = [(cts[0], nl, scale)]
    jax = dict(per_op=rex.run_encrypted(arg, jit=False),
               segment=rex.run_encrypted(arg, jit="segment"),
               batch=rex.run_encrypted_batch([(cts, nl, scale)], mesh=None))
    jax = {k: ([np.asarray(o) for o in outs], [tuple(m) for m in meta])
           for k, (outs, meta) in jax.items()}
    return dict(ref=ref, path=path, payloads=payloads, budget=budget, cts_t=cts_t, nl=nl,
                scale=scale, jax=jax)


@pytest.fixture(scope="module")
def port_probe(probe):
    stream = _port("test_n10", probe["path"], probe["payloads"], budget=probe["budget"])
    resident = HEVMExecutor(stream.s, stream.prog, probe["payloads"])
    resident.preprocess()
    return stream, resident


def _run(ex, probe, path):
    if path == "batch":
        return ex.run_encrypted_batch([(probe["cts_t"], probe["nl"], probe["scale"])])
    arg = [(probe["cts_t"][0], probe["nl"], probe["scale"])]
    return ex.run_encrypted(arg, jit=False if path == "per_op" else "segment")


def test_probe_streams(probe, port_probe):
    stream, resident = port_probe
    assert stream.streaming and not resident.streaming
    assert stream.plain_bytes == 0 and resident.pool_bytes == 0
    assert stream.pool_bytes == stream.n_plains * 2 * stream.s.ctx.n * 4
    assert tuple(stream._pt_pool.shape) == (stream.n_plains, 2, stream.s.ctx.n)
    assert all(isinstance(p, int) for p in stream.plains if p is not None)
    assert resident.plain_bytes > 0


@pytest.mark.parametrize("path", ["per_op", "segment", "batch"])
def test_probe_bit_equal_to_jax_and_resident(probe, port_probe, path):
    stream, resident = port_probe
    inserts = []
    insert = stream._pt_insert

    def checked(cid, planes):
        insert(cid, planes)
        inserts.append(stream._pt_dev_bytes <= stream._pt_budget or len(stream._pt_dev) == 1)

    stream._pt_insert = checked
    try:
        outs, meta = _run(stream, probe, path)
    finally:
        del stream._pt_insert
    want, want_meta = probe["jax"][path]
    assert [tuple(m) for m in meta] == want_meta
    assert len(outs) == len(want) >= 1
    for got, w in zip(outs, want):
        np.testing.assert_array_equal(U(got), w)
    res_outs, res_meta = _run(resident, probe, path)
    assert res_meta == meta
    assert all(torch.equal(a, b) for a, b in zip(outs, res_outs))
    # the per-op path reads through the LRU; a window of at least
    # SEGMENT_MIN_OPS ops decodes in-graph (its groups), never the LRU
    if path == "per_op":
        assert inserts and all(inserts)
    else:
        assert not inserts and stream._pt_groups


def test_probe_groups_cover_each_window(port_probe):
    stream, _ = port_probe
    plan = stream._segment_plan()
    for wi, info in enumerate(plan):
        if info["kind"] != "seg" or len(info["ops"]) < stream.SEGMENT_MIN_OPS:
            continue
        groups = stream._seg_pt_groups(wi, info)
        assert sorted(r for _, regs, _ in groups for r in regs) == sorted(info["plain_regs"])
        assert [rows for rows, _, _ in groups] == sorted(rows for rows, _, _ in groups)
        for rows, regs, idx in groups:
            assert idx.tolist() == [stream._pt_cid[r] for r in regs]
            assert all(tuple(stream._pt_rows[stream._pt_cid[r]]) == rows for r in regs)


# --------------------------------------------------------------- (b) the mode
@pytest.mark.parametrize("env", [None, "65536", "1000000000000"])
def test_mode_equals_jax(probe, monkeypatch, env):
    if env is not None:
        monkeypatch.setenv("DACAPO_TPU_HBM_BYTES", env)
    rex = RefExecutor(probe["ref"], RefProgram.load(probe["path"]), probe["payloads"])
    rex.preprocess()
    port = _port("test_n10", probe["path"], probe["payloads"])
    assert (port._pt_budget, port.streaming) == (rex._pt_budget, rex._streaming)
    assert port.streaming == (env == "65536")


@pytest.mark.parametrize("logn", [14, 15, 16])
@pytest.mark.parametrize("env", [None, "17179869184", "1000000"])
def test_budget_rule_equals_jax(monkeypatch, logn, env):
    """The limit rule alone, on executors made without a program: at N >=
    2^15 a device without memory stats gets 16 GiB, below it no budget."""
    if env is not None:
        monkeypatch.setenv("DACAPO_TPU_HBM_BYTES", env)
    budgets = []
    for cls in (RefExecutor, HEVMExecutor):
        ex = object.__new__(cls)
        ex.s = types.SimpleNamespace(ctx=types.SimpleNamespace(n=1 << logn),
                                     device=torch.device("cpu"),
                                     galois_key_bytes=lambda: 1, set_key_budget=None)
        ex.prog = types.SimpleNamespace(rotation_offsets=lambda: [1])
        ex.key_bytes, ex._pt_budget = 1, None
        ex._set_memory_budgets()
        budgets.append(ex._pt_budget)
    assert budgets[0] == budgets[1]
    if env is None:
        assert budgets[1] == (int(0.12 * (16 << 30)) if logn >= 15 else None)


# --------------------------------------------------------- (d) a bootstrap
def test_bootstrap_streamed_bit_equal_to_jax(tmp_path, monkeypatch):
    profile = "test_n10"
    load_profile(COMPILER_PROFILES[profile])
    ref = RefScheme(profile)
    ref.generate_keys()
    n = ref.ctx.config.n_slots
    w = np.random.default_rng(0).normal(0, 0.3, (8, n))
    model, golden = _dryrun_model(n, w)
    trace_mod._module.reset()
    fn = hc.func("c")(model).eval()
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    privatize_constants(fn)
    canonicalize(fn)
    prog = compile_function(fn, "pars", 25)
    path = str(tmp_path / "dryrun.hevm")
    prog._save_py(path)
    assert sum(op.opcode == OP_BOOTSTRAP for op in prog.ops) == 1
    x = np.random.default_rng(5).uniform(-1, 1, n)
    budget = _tiny_budget(ref.ctx)

    monkeypatch.setenv("DACAPO_TPU_ORACLE_JIT", "0")
    rex = RefExecutor(ref, prog, payloads)
    rex._pt_budget = budget
    rex.preprocess()
    cts, _, nl, scale = _encrypt_rows(ref, prog, [x])
    want, want_meta = rex.run_encrypted([(cts[0], nl, scale)], jit="segment")
    assert rex._streaming
    monkeypatch.delenv("DACAPO_TPU_ORACLE_JIT")

    # the port draws in the same order: keys, galois keys, the encryption,
    # then the oracle's draws
    port = _port(profile, path, payloads, budget=budget, host_rng=True)
    assert port.streaming
    ct = port.s.encrypt(x, scale=scale, nl=nl).data
    np.testing.assert_array_equal(U(ct), cts[0])
    outs, meta = port.run_encrypted([(ct, nl, scale)])
    assert port.bootstrapper.calls == 1
    assert [tuple(m) for m in meta] == [tuple(m) for m in want_meta]
    for got, w_ in zip(outs, want):
        np.testing.assert_array_equal(U(got), np.asarray(w_))
    res = port.decrypt_outputs()[0]
    assert float(np.sqrt(np.mean((res - golden(x)) ** 2))) < 5e-2


# ----------------------------------------------------------------- (e) LRU
def test_lru_budget_and_order(probe, port_probe):
    stream, _ = port_probe
    cids = sorted({c for c in stream._pt_cid if c is not None})
    plane = len(stream._pt_rows[cids[0]]) * stream.s.ctx.n * 4
    regs = {}
    for r, c in enumerate(stream._pt_cid):
        if c is not None:
            regs.setdefault(c, r)
    stream._pt_dev.clear()
    stream._pt_dev_bytes = 0
    budget = stream._pt_budget
    try:
        stream._pt_budget = int(2.5 * plane)
        for c in cids:
            got = stream._plain(regs[c], None)
            assert list(stream._pt_dev)[-1] == c
            assert stream._pt_dev_bytes <= stream._pt_budget
            assert stream._pt_dev_bytes == sum(p.nbytes for p in stream._pt_dev.values())
            assert torch.equal(got, stream.ev.decode_plain(stream._pt_pool[c: c + 1],
                                                           stream._pt_rows[c])[0])
        held = list(stream._pt_dev)
        assert len(held) >= 2
        stream._plain(regs[held[0]], None)           # a hit moves to the end
        assert list(stream._pt_dev) == held[1:] + held[:1]
        stream._pt_budget = plane // 2               # a single entry over budget stays
        stream._pt_dev.clear()
        stream._pt_dev_bytes = 0
        stream._plain(regs[cids[0]], None)
        stream._plain(regs[cids[1]], None)
        assert list(stream._pt_dev) == [cids[1]]
        assert stream._pt_dev_bytes > stream._pt_budget
    finally:
        stream._pt_budget = budget
        stream._pt_dev.clear()
        stream._pt_dev_bytes = 0
