"""The batch path on the CPU (vm/executor.py:run_encrypted_batch, the
batched oracle, runtime/runner.py:setInputBatch/runBatch), held against the
JAX package's batch path (mesh=None) on keys made from the same seed and on
the same argument ciphertexts:

(a) a bootstrap-free program (the StreamProbe rotation program of
    tests/test_memory_streaming.py, test_n10) at B=3: bit-equal to the JAX
    package's run_encrypted_batch, and to the port's single path row by row;
(b) the program of dacapo_tpu/parallel/mesh.py:dryrun_program (test_n10, one
    bootstrap), batched: on the host-RNG oracle bit-equal to the JAX package
    with DACAPO_TPU_ORACLE_JIT=0 (the reference's batch draw order), and on
    the device oracle every row near the plaintext model;
(c) the batched device oracle at test_n11c against its single form and the
    JAX package's batched oracle (tests/test_bootstrap.py:80-140);
(d) HEVM setInputBatch/runBatch on the committed test_n11 MLP: [B, results,
    slots], equal to B single requests on the same ciphertexts, decrypted
    as the JAX package decrypts them; a server returns None;
(e) a batch of the wrong shape raises.
The native bootstrap's batch is tests/test_torch_batch_native.py; the batch
graphs on the card are tests/test_torch_batch_cuda.py; the batch over a mesh
is tests/test_torch_mesh.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

import dacapo_tpu as hc
from dacapo_tpu.crypto.bootstrap import EmulatedBootstrapper as RefOracle
from dacapo_tpu.crypto.params import COMPILER_PROFILES
from dacapo_tpu.crypto.scheme import Ciphertext as RefCiphertext, Scheme as RefScheme
from dacapo_tpu.ir import trace as trace_mod
from dacapo_tpu.ir.config import load_profile
from dacapo_tpu.passes.pipeline import compile_function
from dacapo_tpu.passes.rewrite import cse, canonicalize, elide_constants, privatize_constants
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.crypto.bootstrap import EmulatedBootstrapper
from dacapo_tpu_torch.crypto.scheme import Ciphertext, Scheme
from dacapo_tpu_torch.models.mlp import make_input
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP
from test_memory_streaming import _compile_rotation_program

ART_N11 = (Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts"
           / "mlp_pars25_test_n11")
B = 3


def U(t):
    return t.numpy().view(np.uint32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _rms(got, want):
    return float(np.sqrt(np.mean((np.asarray(got) - np.asarray(want)) ** 2)))


def _encrypt_rows(ref, prog, xs):
    """JAX-encrypted batch [B, 2, nl, N] of argument 0 at its compiled
    (level, scale): (numpy uint32, the same bits as a port tensor, nl, scale)."""
    nl = (prog.arg_level[0] + 1) * ref.ctx.config.rescale_rows
    scale = float(2.0 ** prog.arg_scale[0])
    cts = np.stack([np.asarray(ref.encrypt(x, scale=scale, nl=nl).data) for x in xs])
    return cts, T(cts), nl, scale


def _port_executor(profile, path, payloads, **kw):
    s = Scheme(profile, device="cpu")
    s.generate_keys()
    ex = HEVMExecutor(s, HEVMProgram.load(path), payloads, **kw)
    ex.preprocess()
    return ex


# ---------------------------------------------------------- (a) no bootstrap
@pytest.fixture(scope="module")
def rotation(tmp_path_factory):
    ref, prog, payloads, x, _ = _compile_rotation_program()
    path = str(tmp_path_factory.mktemp("rot") / "StreamProbe.hevm")
    prog._save_py(path)
    rex = RefExecutor(ref, prog, payloads)
    rex.preprocess()
    xs = np.random.default_rng(21).uniform(-1, 1, (B, ref.ctx.config.n_slots))
    cts, cts_t, nl, scale = _encrypt_rows(ref, prog, xs)
    ref_outs, ref_meta = rex.run_encrypted_batch([(cts, nl, scale)], mesh=None)
    port = _port_executor("test_n10", path, payloads)
    outs, meta = port.run_encrypted_batch([(cts_t, nl, scale)])
    return dict(port=port, cts_t=cts_t, nl=nl, scale=scale, ref_outs=ref_outs,
                ref_meta=ref_meta, outs=outs, meta=meta)


def test_batch_bit_equal_to_jax(rotation):
    assert not any(op.opcode == OP_BOOTSTRAP for op in rotation["port"].prog.ops)
    assert [tuple(m) for m in rotation["meta"]] == [tuple(m) for m in rotation["ref_meta"]]
    assert len(rotation["outs"]) == len(rotation["ref_outs"]) >= 1
    for got, want in zip(rotation["outs"], rotation["ref_outs"]):
        assert tuple(got.shape) == (B,) + tuple(np.asarray(want).shape[1:])
        np.testing.assert_array_equal(U(got), np.asarray(want))


def test_batch_rows_equal_single_requests(rotation):
    port = rotation["port"]
    for b in range(B):
        single, meta = port.run_encrypted(
            [(rotation["cts_t"][b], rotation["nl"], rotation["scale"])])
        assert meta == rotation["meta"]
        for got, want in zip(rotation["outs"], single):
            assert torch.equal(got[b], want)


# --------------------------------------------------------- (b) one bootstrap
def _dryrun_model(n, w):
    """dacapo_tpu/parallel/mesh.py:dryrun_program's model and golden."""
    def model(x):
        acc = None
        for i in range(8):
            t = x.rotate(i) * hc.Plain(w[i])
            acc = t if acc is None else acc + t
        h = acc + 0.1
        h = h * h
        h = hc.bootstrap(h)
        return h * hc.Plain(w[0])

    def golden(x):
        acc = sum(np.roll(x, -i) * w[i] for i in range(8))
        h = acc + 0.1
        return h * h * w[0]

    return model, golden


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    profile = "test_n10"
    load_profile(COMPILER_PROFILES[profile])
    ref = RefScheme(profile)
    ref.generate_keys()
    n = ref.ctx.config.n_slots
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.3, (8, n))
    model, golden = _dryrun_model(n, w)
    trace_mod._module.reset()
    fn = hc.func("c")(model).eval()
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    privatize_constants(fn)
    canonicalize(fn)
    prog = compile_function(fn, "pars", 25)
    path = str(tmp_path_factory.mktemp("dryrun") / "dryrun.hevm")
    prog._save_py(path)
    xs = rng.uniform(-1, 1, (B, n))

    mp = pytest.MonkeyPatch()
    mp.setenv("DACAPO_TPU_ORACLE_JIT", "0")
    try:
        rex = RefExecutor(ref, prog, payloads)
        rex.preprocess()
        cts, cts_t, nl, scale = _encrypt_rows(ref, prog, xs)
        ref_outs, ref_meta = rex.run_encrypted_batch([(cts, nl, scale)], mesh=None)
        ref_outs = [np.asarray(o) for o in ref_outs]
    finally:
        mp.undo()

    # the port draws in the same order: keys, galois keys, the batch's
    # encryptions (checked equal), then the oracle's batch draws
    host = _port_executor(profile, path, payloads, host_rng=True)
    port_cts = torch.stack([host.s.encrypt(x, scale=scale, nl=nl).data for x in xs])
    assert torch.equal(port_cts, cts_t)
    host_outs, host_meta = host.run_encrypted_batch([(port_cts, nl, scale)])
    device = HEVMExecutor(host.s, host.prog, payloads)
    device.preprocess()
    dev_outs, dev_meta = device.run_encrypted_batch([(cts_t, nl, scale)])
    return dict(prog=host.prog, xs=xs, golden=golden, ref_outs=ref_outs, ref_meta=ref_meta,
                host=host, host_outs=host_outs, host_meta=host_meta, device=device,
                dev_outs=dev_outs, dev_meta=dev_meta, ref=ref)


def test_dryrun_bootstraps(dryrun):
    assert sum(op.opcode == OP_BOOTSTRAP for op in dryrun["prog"].ops) == 1
    assert dryrun["host"].bootstrapper.calls == dryrun["device"].bootstrapper.calls == 1


def test_host_oracle_batch_bit_equal_to_jax(dryrun):
    assert [tuple(m) for m in dryrun["host_meta"]] == [tuple(m) for m in dryrun["ref_meta"]]
    for got, want in zip(dryrun["host_outs"], dryrun["ref_outs"]):
        np.testing.assert_array_equal(U(got), want)


def test_device_oracle_batch_rows_near_the_model(dryrun):
    assert [tuple(m) for m in dryrun["dev_meta"]] == [tuple(m) for m in dryrun["ref_meta"]]
    res = dryrun["device"].decrypt_outputs()
    ref = dryrun["ref"]
    sc = dryrun["ref_meta"][0][1]
    assert res.shape == (B, 1, ref.ctx.config.n_slots)
    for b, x in enumerate(dryrun["xs"]):
        want = dryrun["golden"](x)
        assert _rms(res[b, 0], want) < 5e-2, b
        jax_row = ref.decrypt(RefCiphertext(dryrun["ref_outs"][0][b], sc))
        assert _rms(jax_row, want) < 5e-2, b
    # fresh randomness per row and per request: the refreshed rows differ
    # from the host path's, and the decrypted rows agree with it
    assert not torch.equal(dryrun["dev_outs"][0], dryrun["host_outs"][0])


# ----------------------------------------------------- (c) the batched oracle
@pytest.fixture(scope="module")
def n11c():
    ref = RefScheme("test_n11c")
    ref.generate_keys()
    port = Scheme("test_n11c", device="cpu")
    port.generate_keys()
    np.testing.assert_array_equal(U(port.keys.pk), np.asarray(ref.keys.pk))
    return ref, port


@pytest.mark.parametrize("nl_in,scale_bits,target,seed", [
    (2, None, 3, 5),         # tests/test_bootstrap.py:80-108, the pair base
    (6, 60, 5, 11),          # :110-140, the hot 2^60 input (three base rows)
])
def test_device_oracle_batch_matches_single(n11c, nl_in, scale_bits, target, seed):
    ref, port = n11c
    n = ref.ctx.config.n_slots
    scale = 2.0 ** (scale_bits or ref.ctx.config.scale_bits)
    vals = np.random.default_rng(seed).uniform(-1, 1, (B, n))
    cts = np.stack([np.asarray(ref.encrypt(v, scale=scale, nl=nl_in).data) for v in vals])
    nl2 = (target + 1) * ref.ctx.config.rescale_rows

    jax_out, (jax_nl2, jax_sc) = RefOracle(ref).bootstrap_batch(cts, nl_in, scale, target)
    bs = EmulatedBootstrapper(port)
    out, (got_nl2, sc) = bs.bootstrap_batch(T(cts), nl_in, scale, target)
    assert (got_nl2, sc) == (jax_nl2, jax_sc) == (nl2, scale)   # the scale is kept
    assert tuple(out.shape) == (B, 2, nl2, port.ctx.n) and bs.calls == 1
    for b, v in enumerate(vals):
        assert _rms(port.decrypt(Ciphertext(out[b], sc)), v) < 5e-4, b
        assert _rms(ref.decrypt(RefCiphertext(jax_out[b], sc)), v) < 5e-4, b
        single, meta = bs.bootstrap(T(cts[b]), nl_in, scale, target)
        assert meta == (nl2, scale)
        assert _rms(port.decrypt(Ciphertext(single, sc)), v) < 5e-4, b
    # the deterministic part of the batch is the single one's, row by row;
    # the randomness is every row's own
    nb = bs._base_rows(nl_in, scale)
    m2 = bs._lifted_plaintext(T(cts), nb, 1, nl2)
    for b in range(B):
        assert torch.equal(m2[b], bs._lifted_plaintext(T(cts[b]), nb, 1, nl2))
    noise = bs.draw((B,))
    assert noise.shape == (B, 3, port.ctx.n)
    assert not torch.equal(noise[0], noise[1])


def test_host_oracle_batch_draw_order_equals_jax(n11c, monkeypatch):
    """The host-RNG batch on its own: all B v, then all B e0, then all B
    e1, the reference's order, bit-equal from equal key generator states."""
    ref, port = n11c
    monkeypatch.setenv("DACAPO_TPU_ORACLE_JIT", "0")
    vals = np.random.default_rng(3).uniform(-1, 1, (B, ref.ctx.config.n_slots))
    cts = np.stack([np.asarray(ref.encrypt(v, scale=2.0 ** 60, nl=6).data) for v in vals])
    port.keygen.rng.bit_generator.state = ref.keygen.rng.bit_generator.state
    want, want_meta = RefOracle(ref).bootstrap_batch(cts, 6, 2.0 ** 60, 5)
    got, meta = EmulatedBootstrapper(port, host_rng=True).bootstrap_batch(
        T(cts), 6, 2.0 ** 60, 5)
    assert meta == tuple(want_meta)
    np.testing.assert_array_equal(U(got), np.asarray(want))


# ------------------------------------------------------ (d) the runner's batch
@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    kd = str(tmp_path_factory.mktemp("keys_n11"))
    cst, hv = str(ART_N11 / "MLP.cst"), str(ART_N11 / "MLP.hevm")
    vm = HEVM("test_n11", keyset_dir=kd, device="cpu")
    vm.load(cst, hv)
    xs = np.stack([make_input(seed) for seed in range(B)])
    rng = vm.scheme.keygen.rng.bit_generator
    state = rng.state
    vm.setInputBatch(0, xs)
    batch_cts = vm._arg_cts_batch[0][0]
    rng.state = state
    singles = []
    for x in xs:                       # the same draws as B setInput calls
        vm.setInput(0, x)
        singles.append(vm._arg_cts[0][0])
    out = vm.runBatch()
    outs = [c.clone() for c in vm.executor._last_outputs[0]]
    return dict(vm=vm, kd=kd, cst=cst, hv=hv, xs=xs, batch_cts=batch_cts,
                singles=singles, out=out, outs=outs)


def test_set_input_batch_encrypts_row_by_row(runner):
    assert tuple(runner["batch_cts"].shape[:2]) == (B, 2)
    for b, single in enumerate(runner["singles"]):
        assert torch.equal(runner["batch_cts"][b], single)


def test_run_batch_equals_single_requests(runner):
    vm, out = runner["vm"], runner["out"]
    assert out.shape == (B, vm.prog.res_length, vm.scheme.ctx.config.n_slots)
    _, nl, scale = vm._arg_cts_batch[0]
    for b in range(B):
        vm._arg_cts[0] = (runner["batch_cts"][b], nl, scale)
        np.testing.assert_array_equal(vm.run(), out[b])
        for got, want in zip(runner["outs"], vm.executor._last_outputs[0]):
            assert torch.equal(got[b], want)


def test_run_batch_decrypts_as_jax(runner):
    """The batch's rows decrypt as the JAX package decrypts the same output
    ciphertexts on the same keys (the executor's batch is held bit for bit
    against the JAX package's in (a) and (b))."""
    vm = runner["vm"]
    ref = RefScheme("test_n11")
    ref.generate_keys()
    np.testing.assert_array_equal(U(vm.scheme.keys.s_ntt), np.asarray(ref.keys.s_ntt))
    meta = vm.executor._last_outputs[1]
    want = np.stack([[ref.decrypt(RefCiphertext(U(o[b]), m[1]))
                      for o, m in zip(runner["outs"], meta)] for b in range(B)])
    np.testing.assert_array_equal(runner["out"], want)


def test_server_run_batch_returns_none(runner):
    server = HEVM("test_n11", keyset_dir=runner["kd"], device="cpu", mode="server")
    server.load(runner["cst"], runner["hv"])
    with pytest.raises(RuntimeError, match="setInputBatch"):
        server.runBatch()
    server.setInputBatch(0, runner["xs"])          # a server encrypts with pk
    assert tuple(server._arg_cts_batch[0][0].shape[:2]) == (B, 2)
    server._arg_cts_batch[0] = runner["vm"]._arg_cts_batch[0]
    assert server.runBatch() is None and server.getOutput() is None
    for got, want in zip(server.executor._last_outputs[0], runner["outs"]):
        assert torch.equal(got, want)


# ---------------------------------------------------------- (e) bad shapes
def test_batch_shape_raises(runner):
    vm = runner["vm"]
    data, nl, scale = vm._arg_cts_batch[0]
    with pytest.raises(ValueError, match="batch"):
        vm.executor.run_encrypted_batch([(data[0], nl, scale)])
