"""ResNet-20 `dacapo 40` on tpu_n15b with native bootstraps, on the CPU.

* The committed artifact (dacapo_tpu_torch/artifacts/resnet_dacapo40_tpu_n15b,
  written by scripts/make_resnet_native_artifact.py with the JAX package's
  compiler): expected.json's counts equal what the .hevm gives through the
  port's reader and the JAX package's, and its bootstrap signatures equal
  the port executor's metadata walk.
* scripts/native_resnet_plan.py's counts equal what the native bootstrapper
  really caches and the keys it really makes: on the deep circuit of
  tests/test_torch_executor_native.py (test_boot with 40 Q primes), for the
  program's bootstrap signature and a second input scale.
* The native bootstrap's ModRaise bound on tpu_n15b (sized_for_secret,
  from the overflow's exact tail and EvalMod's reach, checked over several
  secrets): the reference's K = 16 fails a ciphertext whose overflow passes
  it, the port's K = 24 (degree 40) does not, bit-equal to the JAX
  package's bootstrapper at K = 24, degree 40.
* HEVM.make_keys: a full VM makes a program's keys without loading it, and
  a server on the keyset's server half serves the program without making a
  key.
* The port's own trace and compile of the artifact (slow: ~13 minutes).
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram, OP_BOOTSTRAP as REF_BOOTSTRAP
from dacapo_tpu.vm.hevm import OP_ENCODE as REF_ENCODE
from dacapo_tpu_torch.crypto import keys as keymod
from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import (
    OVERFLOW_TARGET, BootstrapConfig, evalmod_reach, failure_probability, overflow_tail,
    sized_for_secret)
from dacapo_tpu_torch.crypto.params import to_dev
from dacapo_tpu_torch.crypto.scheme import Ciphertext, Scheme
from dacapo_tpu_torch.runtime import runner
from dacapo_tpu_torch.runtime.runner import HEVM
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP, OP_ENCODE
from test_torch_executor_native import CFG, DEPTH, PROFILE, WIDER, _script, compile_test_boot

ROOT = os.path.join(os.path.dirname(__file__), "..")
ART = os.path.join(ROOT, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15b")


def _plan_script():
    spec = importlib.util.spec_from_file_location(
        "native_resnet_plan", os.path.join(ROOT, "scripts", "native_resnet_plan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(ART, "expected.json")) as f:
        return json.load(f)


def _counts(prog, encode, boot):
    return dict(instructions=len(prog.ops),
                encodes=sum(op.opcode == encode for op in prog.ops),
                bootstraps=sum(op.opcode == boot for op in prog.ops),
                rotation_offsets=len({o for o in prog.rotation_offsets() if o != 0}))


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_expected_counts_equal_the_program(expected, reader):
    path = os.path.join(ART, "ResNet.hevm")
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == expected["hevm_sha256"]
    prog, enc, boot = ((HEVMProgram.load(path), OP_ENCODE, OP_BOOTSTRAP) if reader == "port"
                       else (RefProgram.load(path), REF_ENCODE, REF_BOOTSTRAP))
    assert _counts(prog, enc, boot) == {k: expected[k] for k in
                                        ("instructions", "encodes", "bootstraps",
                                         "rotation_offsets")}


def test_expected_signatures_are_the_executor_walk(expected):
    """The bootstrap signatures a load warms (HEVMExecutor._boot_signatures,
    walked without keys by the plan script), one per distinct (rows, scale,
    target), all 18 bootstraps covered."""
    prog = HEVMProgram.load(os.path.join(ART, "ResNet.hevm"))
    sigs = _plan_script().boot_signatures(prog, "tpu_n15b")
    assert [list(s) for s in sigs] == expected["boot_signatures"]
    assert len(sigs) < expected["bootstraps"] == 18
    assert expected["radix"] == (7 if params.PROFILES["tpu_n15b"].n_slots >= 1 << 14 else 5)
    assert BootstrapConfig(**expected["bootstrap_config"]) == sized_for_secret(
        BootstrapConfig(radix=expected["radix"]), params.PROFILES["tpu_n15b"].secret_h,
        params.PROFILES["tpu_n15b"].n)


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    return compile_test_boot(tmp_path_factory.mktemp("resnet_native"))


def test_plan_counts_what_the_bootstrapper_caches(compiled):
    """The plan script's shape-only bootstraps count the diagonals,
    constants, normalizers and galois keys a real native bootstrapper
    makes, signature by signature: the program's signature, then the same
    at a second input scale (a new last-CtS normalizer)."""
    plan = _plan_script()
    prog, payloads, _, _ = compiled
    config = dataclasses.replace(params.PROFILES[PROFILE], **WIDER)
    sigs = plan.boot_signatures(prog, PROFILE, payloads, config)
    assert len(sigs) == 1
    nl, sc, target = sigs[0]
    sigs.append((nl, sc * (1 + 2.0 ** -20), target))
    dry, steps, conj = plan.dry_bootstraps(PROFILE, sigs, BootstrapConfig(**CFG, radix=5),
                                           config)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = Scheme(PROFILE, config=config, seed=7, device="cpu")
        s.generate_keys()
        bs = s.enable_native_bootstrap(BootstrapConfig(**CFG, radix=5))
        before = set(s.keys.galois.keys())
        real = []
        for nl, sc, target in sigs:
            bs.bootstrap(torch.zeros((2, nl, s.ctx.n), dtype=torch.int32), nl, sc, target)
            real.append(bs.cached_planes())
    finally:
        torch.set_num_threads(n)
    assert [{k: a[k] for k in real[0]} for a in dry] == real
    assert real[1]["cts_last_normalizers"] == 2
    assert real[1]["diagonal_bytes"] > real[0]["diagonal_bytes"]
    assert set(steps) == set(s.keys.galois.keys()) - before == set(bs.rotation_steps())
    assert conj and s.keys.conj is not None


def test_make_keys_then_a_server_makes_none(compiled, tmp_path):
    """A full VM's make_keys makes the program's rotation keys and its
    native bootstrap's (test_boot with 40 Q primes, DACAPO_TPU_BOOT=native)
    without loading it; the keyset's server half (save_keyset(parts=...),
    no secret) serves the client's blob: no key made, the client decrypts
    the plaintext model."""
    _, _, hv, cst = compiled
    kd, sd, cd = (str(tmp_path / d) for d in ("keys", "server", "client"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(params.PROFILES, PROFILE,
                   dataclasses.replace(params.PROFILES[PROFILE], **WIDER))
        mp.setattr(runner, "BootstrapConfig",
                   lambda radix: BootstrapConfig(radix=radix, **CFG))
        mp.setenv("DACAPO_TPU_BOOT", "native")
        full = HEVM(PROFILE, keyset_dir=kd, device="cpu")
        prog = HEVMProgram.load(hv)
        made = full.make_keys(hv)
        half = full.scheme.ctx.n // 2
        want = {o % half for o in prog.rotation_offsets() if o % half}
        want |= set(full.scheme._native_bs.rotation_steps())
        assert made == len(want) and set(full.scheme.keys.galois.keys()) == want
        assert os.listdir(os.path.join(kd, "galois")) == []      # nothing persisted
        for d, parts in ((sd, ("public", "eval")), (cd, ("secret", "public"))):
            keymod.save_keyset(full.scheme.keys, d, parts=parts)
            with open(os.path.join(kd, "params.json")) as f, \
                    open(os.path.join(d, "params.json"), "w") as g:
                g.write(f.read())
        assert full.make_keys(hv) == 0                        # all made already
        with pytest.raises(RuntimeError, match="only a full VM"):
            HEVM(PROFILE, keyset_dir=cd, device="cpu", mode="client").make_keys(hv)
        client = HEVM(PROFILE, keyset_dir=cd, device="cpu", mode="client")
        client.loadClient(hv)
        x = np.random.default_rng(0).uniform(0.5, 0.55, client.scheme.ctx.config.n_slots)
        client.setInput(0, x)
        server = HEVM(PROFILE, keyset_dir=sd, device="cpu", mode="server")
        assert server.scheme.keys.s_ntt is None
        n_keys = len(server.scheme.keys.galois)
        server.load(cst, hv)
        server.setCtxt(0, client.getCtxt(0))
        assert server.run() is None
        got = client.decrypt_result(server.getOutputCtxt(0))
    torch.set_num_threads(n)
    assert len(server.scheme.keys.galois) == n_keys == len(want)
    assert server.executor.bootstrapper.calls == 1
    want_out = _script().deep_golden(x, DEPTH)
    assert float(np.sqrt(np.mean((got - want_out) ** 2))) < 1e-3


def test_sized_for_secret():
    """K is the least whose failure probability a bootstrap (some
    coefficient's ModRaise overflow past EvalMod's reach, over N = 2^15) is
    at most OVERFLOW_TARGET: the reference's K = 16, degree 36 stay at
    h = 64 (and for a dense secret, as the reference keeps them);
    tpu_n15b's h = 192 takes K = 24 and degree 40 (K = 23 misses the
    target), which keeps the bootstrap inside its level budget (a
    shape-only bootstrap of the native ResNet's first signature ends at 30
    rows, level 14), where degree 44 would take a level more."""
    n = params.PROFILES["tpu_n15b"].n
    base = BootstrapConfig(radix=7)
    assert sized_for_secret(base, 64, n) is base
    assert sized_for_secret(base, 0, n) is base
    assert sized_for_secret(BootstrapConfig(radix=5, **CFG), 64, 1 << 11) == BootstrapConfig(
        radix=5, **CFG)
    wide = sized_for_secret(base, params.PROFILES["tpu_n15b"].secret_h, n)
    assert (wide.K, wide.degree, wide.radix, wide.r, wide.baby) == (24, 40, 7, 3, 8)
    assert evalmod_reach(base) == 17 and evalmod_reach(wide) == 24
    assert (failure_probability(wide, 192, n) <= OVERFLOW_TARGET
            < failure_probability(dataclasses.replace(wide, K=23), 192, n))
    assert 0.3 < failure_probability(base, 192, n) < 0.4
    plan = _plan_script()
    after, _, _ = plan.dry_bootstraps("tpu_n15b", [(6, 2.0 ** 60, 14)], wide)
    assert after[0]["diagonals"] == 1276
    with pytest.raises(AssertionError, match="consumed too many levels: have 28, need 30"):
        plan.dry_bootstraps("tpu_n15b", [(6, 2.0 ** 60, 14)],
                            dataclasses.replace(wide, degree=44))


OVERFLOW_SEEDS = (1, 2, 3, 4)
OVERFLOW_DRAWS = 16      # ciphertexts a secret: one bootstrap's overflow each


def overflows(seed):
    """ModRaise's overflow round(c1 s / q0) at N = 2^15 for a secret of the
    port's key generator at h = 192 (KeyGenerator._ternary, tpu_n15b's) and
    OVERFLOW_DRAWS uniform c1 (over q0, in [-1/2, 1/2)): int64
    [OVERFLOW_DRAWS, N], the negacyclic product over the secret's support."""
    n, h = 1 << 15, params.PROFILES["tpu_n15b"].secret_h
    gen = keymod.KeyGenerator(SimpleNamespace(n=n, config=SimpleNamespace(seed=seed)), None)
    sec = gen._ternary(h)
    c1 = np.random.default_rng(1000 + seed).uniform(-0.5, 0.5, (OVERFLOW_DRAWS, n))
    acc = np.zeros_like(c1)
    for j in np.nonzero(sec)[0]:
        rolled = np.roll(c1, j, axis=1)                 # c1_{i-j} x^i, wrapped
        rolled[:, :j] *= -1                             # x^N = -1
        acc += sec[j] * rolled
    return np.rint(acc).astype(np.int64)


@pytest.mark.parametrize("seed", OVERFLOW_SEEDS)
def test_overflow_tail_follows_the_model(seed):
    """The overflow's tail over 16 x 2^15 coefficients of one secret
    follows overflow_tail (the Irwin-Hall distribution of h uniforms) at
    |I| > 7, 9, 11, 13, within 5 standard deviations of each count."""
    over = np.abs(overflows(seed)).ravel()
    for bound in (7, 9, 11, 13):
        want = over.size * overflow_tail(192, bound)
        got = int(np.count_nonzero(over > bound))
        assert abs(got - want) <= 5 * np.sqrt(want) + 3, (bound, got, want)


def test_overflow_failures_over_seeds():
    """Over 4 secrets x 16 ciphertexts, the share of bootstraps whose
    overflow passes EvalMod's reach is the model's: ~0.31 for the
    reference's K = 16 (reach 17) at h = 192, none for tpu_n15b's K = 24
    (reach 24; the model's 2.1e-5 a bootstrap)."""
    most = np.concatenate([np.abs(overflows(s)).max(axis=1) for s in OVERFLOW_SEEDS])
    n = 1 << 15
    p = failure_probability(BootstrapConfig(), 192, n)
    want, sd = len(most) * p, np.sqrt(len(most) * p * (1 - p))
    got = int(np.count_nonzero(most > evalmod_reach(BootstrapConfig())))
    assert abs(got - want) <= 4 * sd, (got, want)
    wide = sized_for_secret(BootstrapConfig(radix=7), 192, n)
    assert int(np.count_nonzero(most > evalmod_reach(wide))) == 0


@pytest.fixture(scope="module")
def overflowing():
    """A test_boot ciphertext of a uniform(-0.3, 0.3) message at the bottom
    prime pair, at the scale ModRaise takes as it is (q0 q1 / 2^9), whose c1
    is chosen against the secret so that coefficient 0's overflow is I = 22
    (42 of the 64 support terms aligned; the rest random): past the
    reference's K = 16, inside K = 24."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    s = Scheme(PROFILE, seed=7, device="cpu")
    s.generate_keys()
    ctx = s.ctx
    n = ctx.n
    q0, q1 = int(ctx.q_primes[0]), int(ctx.q_primes[1])
    big = q0 * q1
    sec = s.ev.intt(s.keys.s_ntt[:1].contiguous(), [0]).numpy().astype(np.int64).ravel()
    sec &= 0xFFFFFFFF
    sec = np.where(sec > q0 // 2, sec - q0, sec)
    supp = [int(j) for j in np.nonzero(sec)[0]]
    rng = np.random.default_rng(3)
    c1 = [int(v) - big // 2 for v in rng.integers(0, big, n, dtype=np.uint64)]
    for j in supp[:42]:                 # c1_{-j} s_j x^{-j} x^j adds |c1_{-j}| at 0
        c1[(-j) % n] = int(sec[j]) * (-1 if j else 1) * (big // 2 - 1)
    prod = [0] * n                      # c1 * s, negacyclic, over the integers
    for j in supp:
        sj = int(sec[j])
        for i in range(n):
            if i + j < n:
                prod[i + j] += c1[i] * sj
            else:
                prod[i + j - n] -= c1[i] * sj
    delta = big / 512
    vals = rng.uniform(-0.3, 0.3, ctx.config.n_slots)
    m = np.round(s.encoder._raw_coeffs(vals) * delta).astype(np.int64)
    c0 = [(int(m[i]) - prod[i] + big // 2) % big - big // 2 for i in range(n)]
    overflow = [(c0[i] + prod[i] - int(m[i])) // big for i in range(n)]

    def planes(c):
        return s.ev.ntt(to_dev(np.array([[v % q for v in c] for q in (q0, q1)],
                                        dtype=np.uint32), "cpu"), [0, 1])

    yield s, torch.stack([planes(c0), planes(c1)]), delta, vals, overflow
    torch.set_num_threads(n_threads)


@pytest.mark.parametrize("sized", [False, True], ids=["reference_K16", "sized_K24"])
def test_bootstrap_past_the_reference_bound(overflowing, sized):
    """One coefficient's ModRaise overflow at 22 (|I| passes 16 in about
    one tpu_n15b bootstrap in three, by the overflow's sigma of 4): the
    reference's K = 16 and degree 36 decrypt to garbage, the port's
    tpu_n15b bound (K = 24, degree 40) to the message."""
    s, data, delta, vals, overflow = overflowing
    assert overflow[0] == 22 and max(map(abs, overflow[1:])) <= 16
    assert np.abs(s.decrypt(Ciphertext(data, delta)) - vals).max() < 1e-9
    cfg = BootstrapConfig(radix=5)
    if sized:
        cfg = sized_for_secret(cfg, 192, params.PROFILES["tpu_n15b"].n)
    s._native_bs = None
    bs = s.enable_native_bootstrap(cfg)
    out, (nl2, scale) = bs.bootstrap(data, 2, delta, 4)
    rms = float(np.sqrt(np.mean((s.decrypt(Ciphertext(out, scale)) - vals) ** 2)))
    assert (rms < 1e-5) if sized else (rms > 1.0), rms


def test_sized_bootstrap_bit_equal_to_the_reference(overflowing):
    """tpu_n15b's bootstrap configuration (sized_for_secret at h = 192:
    K = 24, degree 40, here at radix 5) run by the JAX package's
    NativeBootstrapper and by the port's on the overflowing ciphertext
    (same seed, so the same keys): the outputs are bit-equal, and decrypt
    to the message."""
    import jax.numpy as jnp
    from dacapo_tpu.crypto.bootstrap_native import BootstrapConfig as RefConfig
    from dacapo_tpu.crypto.scheme import Scheme as RefScheme
    s, data, delta, vals, _ = overflowing
    cfg = sized_for_secret(BootstrapConfig(radix=5), 192, params.PROFILES["tpu_n15b"].n)
    assert (cfg.K, cfg.degree) == (24, 40)
    ref = RefScheme(PROFILE, seed=7)
    ref.generate_keys()
    np.testing.assert_array_equal(np.asarray(ref.keys.s_ntt), s.keys.s_ntt.numpy().view(np.uint32))
    rbs = ref.enable_native_bootstrap(RefConfig(**dataclasses.asdict(cfg)))
    want, want_meta = rbs.bootstrap(jnp.asarray(data.numpy().view(np.uint32)), 2, delta, 4)
    s._native_bs = None
    got, got_meta = s.enable_native_bootstrap(cfg).bootstrap(data, 2, delta, 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert got_meta == tuple(want_meta)
    out = s.decrypt(Ciphertext(got, got_meta[1]))
    assert float(np.sqrt(np.mean((out - vals) ** 2))) < 1e-5


@pytest.mark.parametrize("script", ["native_resnet_plan.py", "mesh_shard_check.py",
                                    "hevm_read_timing.py"])
def test_scripts_load_no_jax(script):
    """The scripts that count and check the port's native ResNet path and
    what moved out of chip_smoke.py import neither JAX nor the JAX
    package."""
    code = ("import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', 'scripts/{script}')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dacapo_tpu', 'examples'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.slow
def test_port_compile_reproduces_the_artifact(expected, tmp_path):
    """The port traces ResNet-20 (models/cnn_he.trace_resnet) and compiles
    it for tpu_n15b with its own planner (runtime/harness.compile_traced):
    the .cst and the .hevm equal the JAX package's byte for byte. About 13
    minutes of planning on the CPU, hence slow."""
    from dacapo_tpu_torch.models import cnn_he, resnet
    from dacapo_tpu_torch.runtime.harness import compile_traced
    traced = str(tmp_path / "traced")
    model = resnet.get_model(os.path.join(ROOT, "examples", "data", "resnet20.silu.model"))
    cnn_he.trace_resnet(traced, model, nt=expected["nt"])
    hevm = compile_traced("ResNet", "dacapo", 40, "tpu_n15b", traced, str(tmp_path / "opt"))

    def sha(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert sha(os.path.join(traced, "_hecate_ResNet.cst")) == expected["cst_sha256"]
    assert sha(hevm) == expected["hevm_sha256"]
