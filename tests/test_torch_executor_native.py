"""A bootstrapped `dacapo` program through both executors with the native
bootstrapper, on the CPU: the deep circuit of tests/test_dacapo.py traced and
compiled by the JAX package for test_boot (dacapo, waterline 25), run by the
JAX executor (per-op) and by the port's (segment path, eager on the CPU) on
keysets made with the same seed. The output ciphertexts are bit-equal.

test_boot's compiler profile (profiled_TPU_test_boot.json) bounds levels at
18, but the native pipeline (radix 5) takes 30 rows: of test_boot's 36 it
leaves 6, too few for DaCapo to place a bootstrap at waterline 25. The test
runs test_boot's parameters with 40 Q primes instead (alpha 10, the same 4
digits), where it leaves 10 rows, measured ("bootstrap consumed too many
levels: have 10"), and compiles against a copy of the compiler profile with
both level upper bounds at 9.

Also C.2 of the port: a profile made for native bootstrapping never runs the
oracle by itself, HEVM enables the native bootstrapper with the reference's
radix rule, and DACAPO_TPU_BOOT=native keeps the one HEVM built."""

import dataclasses
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dacapo_tpu.crypto.bootstrap_native import BootstrapConfig as RefConfig
from dacapo_tpu.crypto.params import PROFILES as REF_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch.crypto import bootstrap as bs_mod
from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig, NativeBootstrapper
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.runtime import runner
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP

ROOT = os.path.join(os.path.dirname(__file__), "..")
PROFILE = "test_boot"
SEED = 7
DEPTH = 6             # DaCapo places 1 bootstrap
LEVEL_UPPER = 9       # the 10 rows the pipeline leaves, minus one
CFG = dict(K=16, r=3, degree=36, baby=8)      # tests/test_bootstrap.py's
WIDER = dict(num_q=40, alpha=10)              # test_boot with 40 Q primes


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: N=2^11 planes gain nothing from more, and the
    tests run beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_native_artifact", os.path.join(ROOT, "scripts", "make_native_artifact.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compile_test_boot(tmp):
    """The deep circuit compiled for test_boot against the lowered profile
    copy; returns (prog, payloads, hevm path, cst path)."""
    with open(os.path.join(ROOT, "dacapo_tpu", "profiles",
                           "profiled_TPU_test_boot.json")) as f:
        prof = json.load(f)
    prof["levelUpperBound"] = prof["bootstrapLevelUpperBound"] = LEVEL_UPPER
    path = str(tmp / "profiled_test_boot_native.json")
    with open(path, "w") as f:
        json.dump(prof, f)
    prog, payloads = _script().compile_deep(str(tmp), PROFILE, DEPTH, 25,
                                            compiler_profile=path)
    return prog, payloads, str(tmp / "Deep.hevm"), str(tmp / "Deep.cst")


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    return compile_test_boot(tmp_path_factory.mktemp("native"))


@pytest.fixture(scope="module")
def runs(compiled):
    prog, payloads, path, _ = compiled
    ref = RefScheme(PROFILE, config=dataclasses.replace(REF_PROFILES[PROFILE], **WIDER),
                    seed=SEED)
    ref.generate_keys()
    ref.enable_native_bootstrap(RefConfig(**CFG))
    n = ref.ctx.config.n_slots
    x = np.random.default_rng(0).uniform(0.5, 0.55, n)
    ex = RefExecutor(ref, prog, payloads)
    ex.preprocess()
    ref_out = ex.run([x], jit=False)
    ref_cts = [np.asarray(c) for c in ex._last_outputs[0]]

    port = Scheme(PROFILE, config=dataclasses.replace(params.PROFILES[PROFILE], **WIDER),
                  seed=SEED, device="cpu")
    port.generate_keys()
    port.enable_native_bootstrap(BootstrapConfig(**CFG))
    pex = HEVMExecutor(port, HEVMProgram.load(path), payloads)
    pex.preprocess()
    boot_args = []          # (nl, scale, target) of each bootstrap the run made
    native = pex.bootstrapper.bootstrap

    def recorded(data, nl, scale, target):
        boot_args.append((nl, scale, target))
        return native(data, nl, scale, target)

    pex.bootstrapper.bootstrap = recorded
    port_out = pex.run([x])
    del pex.bootstrapper.bootstrap
    return dict(prog=pex.prog, x=x, ref_out=ref_out, ref_cts=ref_cts, pex=pex, ref=ref, ex=ex,
                port=port, port_out=port_out, boot_args=boot_args,
                port_cts=[to_host(c) for c in pex._last_outputs[0]],
                meta=(pex._last_outputs[1], ex._last_outputs[1]))


def test_bootstraps_placed(runs):
    boots = [op for op in runs["prog"].ops if op.opcode == OP_BOOTSTRAP]
    assert len(boots) == 1 and boots[0].rhs == LEVEL_UPPER
    assert isinstance(runs["pex"].bootstrapper, NativeBootstrapper)
    assert runs["pex"].bootstrapper.calls == 1


def test_output_ciphertexts_bit_equal(runs):
    assert len(runs["port_cts"]) == len(runs["ref_cts"]) == 1
    for got, want in zip(runs["port_cts"], runs["ref_cts"]):
        np.testing.assert_array_equal(got, want)
    got_meta, want_meta = runs["meta"]
    assert [tuple(m) for m in got_meta] == [tuple(m) for m in want_meta]


def test_decrypted_output_and_rms(runs):
    np.testing.assert_array_equal(runs["port_out"], runs["ref_out"])
    want = _script().deep_golden(runs["x"], DEPTH)
    rms = float(np.sqrt(np.mean((runs["port_out"][0] - want) ** 2)))
    assert rms < 1e-3, rms


def test_key_count_includes_the_bootstrap(runs):
    """The executor counts the program's rotation keys, the bootstrap's and
    the conjugation key: exactly the keys the run made."""
    pex, port = runs["pex"], runs["port"]
    n_slots = port.ctx.config.n_slots
    want = {o % n_slots for o in runs["prog"].rotation_offsets() if o % n_slots}
    want |= set(pex.bootstrapper.rotation_steps())
    assert set(port.keys.galois.keys()) == want and pex.n_keys == len(want)
    assert pex.key_bytes == (len(want) + 1) * port.galois_key_bytes()
    assert port.keys.conj is not None


def test_key_count_differs_from_the_reference(runs, monkeypatch):
    """ROADMAP C.4: the JAX package's key budget counts the program's
    rotation offsets only (dacapo_tpu/vm/executor.py:88-90), the port's
    `key_bytes` the native bootstrap's rotation keys and the conjugation key
    as well, all of which sit on the device. Side by side here; under a
    limit between the two counts the port budgets its keys and the JAX
    package does not. Neither rule changes."""
    pex, port = runs["pex"], runs["port"]
    kb = port.galois_key_bytes()
    jax_bytes = len({o for o in runs["prog"].rotation_offsets() if o != 0}) * kb
    boot = set(pex.bootstrapper.rotation_steps())
    assert pex.key_bytes == (pex.n_keys + 1) * kb > jax_bytes
    assert pex.n_keys >= len(boot) > jax_bytes // kb
    limit = int((pex.key_bytes + jax_bytes) / 2 / HEVMExecutor.KEY_BUDGET_FRAC)
    monkeypatch.setenv("DACAPO_TPU_HBM_BYTES", str(limit))
    budgets = {}
    for name, cls in (("jax", RefExecutor), ("port", HEVMExecutor)):
        ex = object.__new__(cls)
        ex.s = SimpleNamespace(ctx=port.ctx, device=torch.device("cpu"),
                               galois_key_bytes=lambda: kb,
                               set_key_budget=lambda b, name=name: budgets.update({name: b}))
        ex.prog, ex.key_bytes, ex._pt_budget = runs["prog"], pex.key_bytes, None
        ex._set_memory_budgets()
    assert budgets == {"port": int(HEVMExecutor.KEY_BUDGET_FRAC * limit)}


def test_warm_bootstraps_cover_the_run(runs, monkeypatch):
    """warm_bootstraps (HEVM.load on the card) runs each distinct bootstrap
    of the program once over a zero input, at the level, scale and target
    the request's bootstraps get: a request then finds every key and
    diagonal made."""
    pex = runs["pex"]
    seen = []
    monkeypatch.setattr(pex.bootstrapper, "bootstrap", lambda d, nl, sc, t: seen.append(
        (tuple(d.shape), int(d.abs().sum()), nl, sc, t)))
    assert pex.warm_bootstraps() == 1
    assert len(runs["boot_args"]) == 1
    nl, sc, t = runs["boot_args"][0]
    assert seen == [((2, nl, runs["port"].ctx.n), 0, nl, sc, t)]


B = 3               # the batch of test_batch_bit_equal_to_jax


@pytest.fixture(scope="module")
def batch_runs(runs):
    """B ciphertexts, encrypted by the JAX package under `runs`' keys (both
    packages drew the same keys from SEED), through both packages'
    run_encrypted_batch: the JAX executor of `runs` (whose per-op request
    compiled the native bootstrap's ops in this process), mesh=None, and
    the port's, each bootstrapping the batch row by row."""
    ref, ex, pex = runs["ref"], runs["ex"], runs["pex"]
    nl, scale = (pex.prog.arg_level[0] + 1) * pex.rr, float(2.0 ** pex.prog.arg_scale[0])
    xs = np.random.default_rng(1).uniform(0.5, 0.55, (B, ref.ctx.config.n_slots))
    cts = np.stack([np.asarray(ref.encrypt(v, scale=scale, nl=nl).data) for v in xs])
    ref_outs, ref_meta = ex.run_encrypted_batch([(cts, nl, scale)], mesh=None)
    calls = pex.bootstrapper.calls
    outs, meta = pex.run_encrypted_batch(
        [(torch.from_numpy(cts.astype(np.uint32).view(np.int32)), nl, scale)])
    return dict(xs=xs, ref_outs=[np.asarray(o) for o in ref_outs], ref_meta=ref_meta,
                outs=[to_host(o) for o in outs], meta=meta,
                calls=pex.bootstrapper.calls - calls, pex=pex)


def test_batch_bit_equal_to_jax(batch_runs):
    """The port's native batch of B, every row of every output ciphertext
    and the output metadata, equals the JAX package's run_encrypted_batch
    on the same keys and ciphertexts; B bootstraps ran, one a row, and each
    row decrypts to the model (tests/test_torch_batch_native.py holds the
    rows to single requests)."""
    r = batch_runs
    assert r["calls"] == B
    assert [tuple(m) for m in r["meta"]] == [tuple(m) for m in r["ref_meta"]]
    assert len(r["outs"]) == len(r["ref_outs"]) >= 1
    for got, want in zip(r["outs"], r["ref_outs"]):
        assert got.shape == (B,) + want.shape[1:]
        np.testing.assert_array_equal(got, want)
    dec = r["pex"].decrypt_outputs()
    for b, x in enumerate(r["xs"]):
        rms = float(np.sqrt(np.mean((dec[b][0] - _script().deep_golden(x, DEPTH)) ** 2)))
        assert rms < 1e-3, (b, rms)


# ----------------------------------------------------------------------- C.2
@pytest.fixture
def native_profile(monkeypatch):
    """test_boot marked for native bootstrapping, as a port profile, with
    the 40 Q primes the compiled program's bootstrap reaches (HEVM.load
    refuses a program past the reach)."""
    cfg = dataclasses.replace(params.PROFILES[PROFILE], native_bootstrap=True, **WIDER)
    monkeypatch.setitem(params.PROFILES, "test_boot_native", cfg)
    return "test_boot_native"


def test_native_profile_never_runs_the_oracle(native_profile):
    s = Scheme(native_profile, device="cpu")
    s.generate_keys()
    with pytest.raises(RuntimeError, match="enable_native_bootstrap"):
        bs_mod.Bootstrapper(s)
    assert isinstance(bs_mod.Bootstrapper(s, native=False), bs_mod.EmulatedBootstrapper)
    nb = s.enable_native_bootstrap()
    assert bs_mod.Bootstrapper(s) is nb
    assert isinstance(bs_mod.Bootstrapper(s, native=False), bs_mod.EmulatedBootstrapper)


def test_hevm_dispatches_native_and_env_keeps_it(native_profile, compiled, tmp_path,
                                                  monkeypatch):
    _, _, hevm_path, cst_path = compiled
    vm = runner.HEVM(native_profile, keyset_dir=str(tmp_path / "keys"), device="cpu")
    nb = vm.scheme._native_bs
    assert isinstance(nb, NativeBootstrapper) and nb.cfg.radix == 5
    assert vm.scheme.keys.conj is not None
    vm.load(cst_path, hevm_path)
    assert vm.executor.bootstrapper is nb
    assert "bootstrap_warmup" not in vm.load_seconds      # lazy on the CPU
    assert os.path.exists(tmp_path / "keys" / "conj.npy")
    monkeypatch.setenv("DACAPO_TPU_BOOT", "native")
    vm.load(cst_path, hevm_path)
    assert vm.scheme._native_bs is nb and vm.executor.bootstrapper is nb


def test_env_native_on_a_plain_profile(compiled, tmp_path, monkeypatch):
    """DACAPO_TPU_BOOT=native enables the native path at load on a
    sparse-secret profile not marked for it, with the radix rule (test_boot
    with the 40 Q primes the program's bootstrap reaches)."""
    _, _, hevm_path, cst_path = compiled
    monkeypatch.setitem(params.PROFILES, PROFILE,
                        dataclasses.replace(params.PROFILES[PROFILE], **WIDER))
    vm = runner.HEVM(PROFILE, keyset_dir=str(tmp_path / "keys"), device="cpu")
    assert vm.scheme._native_bs is None
    monkeypatch.setenv("DACAPO_TPU_BOOT", "native")
    vm.load(cst_path, hevm_path)
    nb = vm.executor.bootstrapper
    assert isinstance(nb, NativeBootstrapper) and nb.cfg.radix == 5
    assert nb is vm.scheme._native_bs
