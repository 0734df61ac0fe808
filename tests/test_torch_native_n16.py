"""Native bootstrapping on tpu_n16 (N = 2^16, the 128-bit-secure profile), on
the CPU without a key at N = 2^16:

* the committed deep program (artifacts/deep_dacapo40_tpu_n16) regenerates
  byte for byte with the JAX compiler and with the port's own
  (trace_deep + compile_traced) against profiled_TPU_n16_native.json, the
  JAX package's tpu_n16 compiler profile with both level upper bounds at 11;
* bootstrap_native.rows_left equals what the bootstrap itself leaves,
  walked over shape-only tensors (scripts/native_resnet_plan.py): 8 and 12
  of tpu_n16's 42 rows at radix 7 and 8, 30 of tpu_n15b's 60 at radix 7;
* the runner's radix: 8 on tpu_n16, 7 on tpu_n15b, 5 on test_boot;
* HEVM.load and make_keys refuse, before any galois key, a program whose
  bootstraps target a level past the reach (the JAX bounds' level 29);
* a radix-8 bootstrapper on test_boot against the JAX package's;
* the port's arithmetic from 2^15 slots (the working scale EvalMod returns
  to, SlotToCoeff's first level on it, GAP 7) and the reference's below;
* the dry plan's key and plane counts of the committed program;
* HEVM(save_keys=False) writes no key;
* fault C.5 side by side: the JAX package's bounds and radix rule against
  the port's level 11."""

import dataclasses
import hashlib
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dacapo_tpu.crypto.params import PROFILES as REF_PROFILES
from dacapo_tpu.vm.hevm import OP_BOOTSTRAP as REF_BOOTSTRAP
from dacapo_tpu_torch.crypto.bootstrap_native import (
    BootstrapConfig, native_config, native_radix, rows_left, sized_for_secret)
from dacapo_tpu_torch.crypto.params import CKKSContext, PROFILES
from dacapo_tpu_torch.ir.serialize import read_cst
from dacapo_tpu_torch.runtime.runner import HEVM, keyset_fingerprint
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP

ROOT = os.path.join(os.path.dirname(__file__), "..")
ART = os.path.join(ROOT, "dacapo_tpu_torch", "artifacts", "deep_dacapo40_tpu_n16")
NATIVE_PROFILE = os.path.join(ART, "profiled_TPU_n16_native.json")
with open(os.path.join(ART, "expected.json")) as _f:
    EXPECTED = json.load(_f)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def ctx16():
    return CKKSContext(PROFILES["tpu_n16"], device="cpu")


@pytest.fixture(scope="module")
def jax_compiled(tmp_path_factory):
    """The artifact again with the JAX compiler, and the deep circuit at
    depth 20 against the JAX package's own tpu_n16 bounds."""
    mod = _load("make_native_artifact")
    art = _load("make_native_artifact_n16")
    out = tmp_path_factory.mktemp("n16_jax")
    mod.compile_deep(str(out / "native"), profile="tpu_n16", depth=art.DEPTH,
                     compiler_profile=NATIVE_PROFILE)
    prog, _ = mod.compile_deep(str(out / "jax_bounds"), profile="tpu_n16", depth=20)
    return out, prog


@pytest.mark.parametrize("name", ["Deep.hevm", "Deep.cst"])
def test_artifact_regenerates_with_the_jax_compiler(jax_compiled, name):
    out, _ = jax_compiled
    assert _bytes(str(out / "native" / name)) == _bytes(os.path.join(ART, name))


def test_artifact_regenerates_with_the_port_compiler(tmp_path):
    from dacapo_tpu_torch.models.deep import trace_deep
    from dacapo_tpu_torch.runtime.harness import compile_traced
    traced = str(tmp_path / "traced")
    trace_deep(traced, PROFILES["tpu_n16"].n_slots, EXPECTED["depth"])
    hevm = compile_traced("Deep", "dacapo", EXPECTED["waterline"], "tpu_n16",
                          traced_dir=traced, out_dir=str(tmp_path / "optimized"),
                          compiler_profile=NATIVE_PROFILE)
    assert _bytes(hevm) == _bytes(os.path.join(ART, "Deep.hevm"))
    assert _bytes(os.path.join(traced, "_hecate_Deep.cst")) == _bytes(
        os.path.join(ART, "Deep.cst"))


def test_expected_json():
    prog = HEVMProgram.load(os.path.join(ART, "Deep.hevm"))
    boots = [op.rhs for op in prog.ops if op.opcode == OP_BOOTSTRAP]
    assert boots == EXPECTED["bootstrap_target_levels"] == [11]
    assert len(prog.ops) == EXPECTED["instructions"]
    for name in ("cst", "hevm"):
        assert hashlib.sha256(_bytes(os.path.join(ART, f"Deep.{name}"))).hexdigest() == \
            EXPECTED[f"{name}_sha256"]
    assert EXPECTED["bootstrap_config"] == dataclasses.asdict(native_config(
        PROFILES["tpu_n16"])) == dict(K=25, r=3, degree=40, baby=8, radix=8)
    assert (EXPECTED["bootstrap_rows_left"], EXPECTED["bootstrap_reach_level"]) == (12, 11)
    with open(NATIVE_PROFILE) as f:
        native = json.load(f)
    with open(os.path.join(ROOT, "dacapo_tpu", "profiles", "profiled_TPU_n16.json")) as f:
        jax_profile = json.load(f)
    assert {k for k in native if native[k] != jax_profile[k]} == {
        "levelUpperBound", "bootstrapLevelUpperBound"}
    assert native["levelUpperBound"] == native["bootstrapLevelUpperBound"] == 11


@pytest.fixture(scope="module")
def plan():
    return _load("native_resnet_plan")


@pytest.fixture(scope="module")
def n16_walk(plan):
    """The committed program's bootstrap signatures by the executor's walk,
    and its bootstrap (native_config) run over shape-only tensors: (the
    program, its signatures, the planes after each, the galois steps asked
    for, whether the conjugation key was, the bootstrapper)."""
    prog = HEVMProgram.load(os.path.join(ART, "Deep.hevm"))
    sigs = plan.boot_signatures(prog, "tpu_n16", read_cst(os.path.join(ART, "Deep.cst")))
    held = []
    after, steps, conj = plan.dry_bootstraps("tpu_n16", sigs, native_config(PROFILES["tpu_n16"]),
                                             bootstrapper=held)
    return prog, sigs, after, steps, conj, held[0]


@pytest.mark.parametrize("profile, radix, rows", [
    ("tpu_n16", 7, 8), ("tpu_n16", 8, 12), ("tpu_n15b", 7, 30)])
def test_rows_left_matches_the_meta_walk(plan, request, profile, radix, rows):
    """rows_left counts what the bootstrap spends; the bootstrap over
    shape-only tensors reaches the level it says and stops one level past
    it (radix 8 on tpu_n16: the committed program's own bootstrap; else an
    input at the bottom pair)."""
    cfg = PROFILES[profile]
    boot = sized_for_secret(BootstrapConfig(radix=radix), cfg.secret_h, cfg.n)
    ctx = CKKSContext(cfg, device="cpu")
    assert rows_left(ctx, boot) == rows
    reach = rows // cfg.rescale_rows - 1
    if (profile, radix) == ("tpu_n16", 8):
        _, sigs, _, _, _, bs = request.getfixturevalue("n16_walk")
        assert boot == bs.cfg and sigs[0][2] == reach
        nl, scale = sigs[0][:2]
    else:
        nl, scale = 2 * cfg.rescale_rows, 2.0 ** cfg.scale_bits
        held = []
        plan.dry_bootstraps(profile, [(nl, scale, reach)], boot, bootstrapper=held)
        bs = held[0]
    with pytest.raises(AssertionError, match=f"have {rows}, need {rows + cfg.rescale_rows}"):
        bs.bootstrap(torch.empty((2, nl, cfg.n), dtype=torch.int32, device="meta"),
                     nl, scale, reach + 1)


@pytest.mark.parametrize("profile, radix", [("tpu_n16", 8), ("tpu_n15b", 7),
                                            ("test_boot", 5)])
def test_runner_radix(profile, radix, monkeypatch):
    """HEVM builds its native bootstrapper with native_radix (and K sized for
    the secret), the same config native_config gives; no key is made."""
    cfg = PROFILES[profile]
    assert native_radix(cfg.n_slots) == radix
    built = []
    vm = object.__new__(HEVM)
    vm.profile, vm.mode = profile, "full"
    vm.scheme = SimpleNamespace(
        ctx=SimpleNamespace(config=cfg), _native_bs=None,
        enable_native_bootstrap=lambda c: built.append(c) or c)
    vm._native_bootstrapper()
    assert built == [native_config(cfg)] and built[0].radix == radix


@pytest.mark.parametrize("profile, working", [("tpu_n16", True), ("tpu_n15b", False),
                                              ("test_boot", False)])
def test_stc_schedule_by_slots(plan, profile, working):
    """From 2^15 slots (tpu_n16) SlotToCoeff's first level lands on the
    working scale (2^60) and the last on the output's; below (tpu_n15b,
    test_boot) both land on the output's, the reference's schedule, so
    those bootstraps stay bit-equal to the JAX package's. A level landing on
    T from a ciphertext at scale S encodes its planes at T * q_span / S:
    walked over shape-only tensors, the first level's planes sit above the
    last level's exactly with the working schedule."""
    cfg = PROFILES[profile]
    boot = native_config(cfg)
    reach = rows_left(CKKSContext(cfg, device="cpu"), boot) // cfg.rescale_rows - 1
    held = []
    plan.dry_bootstraps(profile, [(2 * cfg.rescale_rows, 2.0 ** cfg.scale_bits, reach)], boot,
                        bootstrapper=held)
    bs = held[0]
    assert bs.wide is working
    _, first, rest = bs._transforms()
    assert len(rest) == 1
    first_scales = {k[3] for k in first[0]._pt_cache}
    last_scales = {k[3] for k in rest[0]._pt_cache}
    assert len(first_scales) == len(last_scales) == 1
    assert (first_scales.pop() > last_scales.pop()) is working


@pytest.mark.parametrize("profile, wide", [("tpu_n16", True), ("tpu_n15b", False),
                                           ("test_boot", False)])
def test_working_scale_returns(profile, wide):
    """From 2^15 slots the working scale is where EvalMod's squarings return
    to (tpu_n16's prime pairs span 2^59.78 to 2^59.93, and from the nominal
    2^60 EvalMod's output leaves at 2^99) and the input is raised to GAP 7;
    below, the nominal 2^60 and GAP 9 stay (tpu_n15b's balanced pairs span
    2^60). No key, no data: the level walk."""
    import math
    from dacapo_tpu_torch.crypto.bootstrap_native import NativeBootstrapper
    cfg = PROFILES[profile]
    bs = NativeBootstrapper(SimpleNamespace(ctx=CKKSContext(cfg, device="cpu"), ev=None),
                            native_config(cfg))
    assert bs.wide is wide
    assert bs.GAP_BITS == (7 if wide else 9)
    t, _ = bs._cts_walk()
    out = math.log2(bs._evalmod(t).scale / (2 * math.pi))
    if wide:
        assert 59.7 < math.log2(bs.delta_bs) < 59.9
        assert abs(out - math.log2(bs.delta_bs)) < 1e-9
        bs.delta_bs = 2.0 ** 60                 # the reference's nominal scale
        t, _ = bs._cts_walk()
        assert math.log2(bs._evalmod(t).scale / (2 * math.pi)) > 99
    else:
        assert bs.delta_bs == 2.0 ** 60 and abs(out - 60) < 1.0


def _server_keyset(d, profile):
    """A server keyset directory with stand-in public, relinearization and
    conjugation keys and no galois key: enough for HEVM(mode="server") to
    start and build its native bootstrapper, no key drawn."""
    os.makedirs(d)
    for name in ("pk", "rlk", "conj"):
        np.save(os.path.join(d, f"{name}.npy"), np.zeros((1, 1), dtype=np.uint32))
    scheme = SimpleNamespace(ctx=CKKSContext(PROFILES[profile], device="cpu"))
    with open(os.path.join(d, "params.json"), "w") as f:
        json.dump({"primes": keyset_fingerprint(scheme)}, f)


def test_load_refuses_the_jax_bounds(jax_compiled, tmp_path):
    """The deep circuit compiled against the JAX package's tpu_n16 bounds
    lands its bootstraps at level 29; HEVM.load refuses it, naming 29 and
    the reach of 11, before any galois key or executor exists."""
    out, prog = jax_compiled
    assert {op.rhs for op in prog.ops if op.opcode == REF_BOOTSTRAP} == {29}
    kd = str(tmp_path / "keys")
    _server_keyset(kd, "tpu_n16")
    vm = HEVM("tpu_n16", keyset_dir=kd, device="cpu", mode="server")
    with pytest.raises(ValueError, match=r"level 29, past level 11"):
        vm.load(str(out / "jax_bounds" / "Deep.cst"), str(out / "jax_bounds" / "Deep.hevm"))
    assert vm.executor is None and len(vm.scheme.keys.galois) == 0
    assert vm.scheme._native_bs.cfg.radix == 8


@pytest.fixture(scope="module")
def test_boot_past_reach(tmp_path_factory):
    """The deep circuit compiled for test_boot against the JAX package's
    test_boot bounds (18): its bootstrap target passes the level 5 that
    test_boot's radix-5 bootstrap reaches (6 of 36 rows)."""
    out = tmp_path_factory.mktemp("boot_past_reach")
    prog, _ = _load("make_native_artifact").compile_deep(str(out), "test_boot", 12, 25)
    target = max(op.rhs for op in prog.ops if op.opcode == REF_BOOTSTRAP)
    assert target > 5
    return out, target


@pytest.mark.parametrize("entry", ["load", "make_keys"])
def test_full_vm_refuses_before_any_key(test_boot_past_reach, tmp_path, monkeypatch, entry):
    """A full VM's load (in the executor, before its first key) and
    make_keys refuse the same way."""
    out, target = test_boot_past_reach
    monkeypatch.setenv("DACAPO_TPU_BOOT", "native")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        vm = HEVM("test_boot", keyset_dir=str(tmp_path / "keys"), device="cpu")
        with pytest.raises(ValueError, match=rf"level {target}, past level 5"):
            if entry == "load":
                vm.load(str(out / "Deep.cst"), str(out / "Deep.hevm"))
            else:
                vm.make_keys(str(out / "Deep.hevm"))
        assert vm.executor is None and len(vm.scheme.keys.galois) == 0
    finally:
        torch.set_num_threads(n)


def test_radix8_transforms_bit_equal_to_jax():
    """A radix-8 bootstrapper on test_boot (2^10 slots: a level of 8
    butterfly stages and one of 2 each way) against the JAX package's
    BootstrapConfig(radix=8): every CoeffToSlot and SlotToCoeff level (the
    last CtS level with its normalizer folded in, the first StC level and
    its i-scaled twin) has the same diagonals and BSGS groups and, applied
    to the same ciphertext, gives the same ciphertext bit for bit and the
    same scale (the twins, whose diagonals are their level's times a
    constant, are compared by their diagonals); the galois keys the levels
    made are rotation_steps'. The radix changes nothing else of the bootstrap
    (ModRaise, EvalMod and their scales are held bit-equal at radix 5 in
    tests/test_torch_bootstrap_native.py); the JAX package's whole radix-8
    bootstrap takes ~2 minutes here."""
    from dacapo_tpu.crypto.bootstrap_native import BootstrapConfig as RefConfig
    from dacapo_tpu.crypto.bootstrap_native import CtVal as RefCtVal
    from dacapo_tpu.crypto.scheme import Scheme as RefScheme
    from dacapo_tpu_torch.crypto.bootstrap_native import CtVal
    from dacapo_tpu_torch.crypto.params import to_host
    from dacapo_tpu_torch.crypto.scheme import Scheme
    cfg = dict(K=16, r=3, degree=36, baby=8, radix=8)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = RefScheme("test_boot", seed=6)
        ref.generate_keys()
        rbs = ref.enable_native_bootstrap(RefConfig(**cfg))
        port = Scheme("test_boot", seed=6, device="cpu")
        port.generate_keys()
        pbs = port.enable_native_bootstrap(BootstrapConfig(**cfg))
        vals = np.random.default_rng(3).uniform(-1, 1, port.ctx.config.n_slots)
        nl = 4              # the level leaves no mark on the transforms: the fewest rows
        rct, pct = ref.encrypt(vals, scale=2.0 ** 25, nl=nl), port.encrypt(vals, scale=2.0 ** 25,
                                                                           nl=nl)
        assert np.array_equal(np.asarray(rct.data), to_host(pct.data))
        norm = 2.0 ** -pbs.GAP_BITS / pbs.cfg.K
        levels = []
        for bs in (rbs, pbs):
            cts, stc_first, stc = bs._transforms()
            levels.append(list(cts) + list(bs._cts_last(norm)) + list(stc_first) + list(stc))
        assert [len(t.diags) for t in levels[1]] == [256, 7, 7, 511, 511, 4]
        for i, (rt, pt) in enumerate(zip(*levels)):
            assert sorted(rt.diags) == sorted(pt.diags) and rt.groups == pt.groups
            assert all(np.array_equal(rt.diags[k], pt.diags[k]) for k in rt.diags)
            if i in (2, 4):
                continue        # the twin of the level before: its diagonals scaled
            rout = rt.apply(RefCtVal(rbs, rct.data, rct.scale), rbs.delta_bs)
            pout = pt.apply(CtVal(pbs, pct.data, pct.scale), pbs.delta_bs)
            assert np.array_equal(np.asarray(rout.data), to_host(pout.data))
            assert rout.scale == pout.scale
        assert sorted(port.keys.galois.keys()) == sorted(ref.keys.galois.keys()) == \
            pbs.rotation_steps()
    finally:
        torch.set_num_threads(n)


def test_full_vm_keeps_keys_in_memory(tmp_path):
    """HEVM(save_keys=False): a full VM makes its keys (at start and at
    load) and writes none of them, for a keyset too large to write
    (tpu_n16's ~35 GB; the smoke's native_n16 phase); the same requests
    as a VM that writes them."""
    art = os.path.join(ROOT, "dacapo_tpu_torch", "artifacts", "mlp_pars25_test_n11")
    files = (os.path.join(art, "MLP.cst"), os.path.join(art, "MLP.hevm"))
    outs = {}
    for save in (True, False):
        kd = tmp_path / f"keys_{save}"
        vm = HEVM("test_n11", keyset_dir=str(kd), device="cpu", save_keys=save)
        vm.load(*files)
        vm.setInput(0, np.random.default_rng(0).uniform(-1, 1, vm.scheme.ctx.config.n_slots))
        vm.run()
        outs[save] = vm.getOutput()[0]
        assert kd.exists() is save
        assert len(vm.scheme.keys.galois) > 0
    assert np.array_equal(outs[True], outs[False])


def test_dry_plan_counts(n16_walk):
    """The committed program's bootstrap signature by the executor's walk
    and what a load's warm-up makes, counted over shape-only tensors: 397
    rotation keys (the program's 6 among them) and the conjugation key, 88
    MB each; 1,916 diagonals and 56 constants, 13.33 GB."""
    prog, sigs, after, steps, conj, _ = n16_walk
    assert [list(s) for s in sigs] == EXPECTED["boot_signatures"]
    half = PROFILES["tpu_n16"].n // 2
    prog_steps = {o % half for o in prog.rotation_offsets() if o % half}
    got = dict(program_rotation_keys=len(prog_steps), bootstrap_rotation_keys=len(steps),
               conjugation_key=conj, galois_keys=len(prog_steps | set(steps)) + conj)
    want = EXPECTED["plan"]
    assert got == {k: want[k] for k in got} == dict(
        program_rotation_keys=6, bootstrap_rotation_keys=397, conjugation_key=True,
        galois_keys=398)
    assert prog_steps <= set(steps)
    assert after == want["planes_after_signature"]
    assert (after[0]["diagonals"], after[0]["diagonal_bytes"], after[0]["constants"],
            after[0]["constant_bytes"]) == (1916, 12_922_650_624, 56, 406_323_200)
    assert want["key_bytes_each"] == 3 * 2 * 56 * 2 ** 16 * 4 == 88_080_384


def test_c5_side_by_side(jax_compiled, ctx16):
    """ROADMAP C.5: the JAX package's tpu_n16 bounds land every bootstrap at
    level 29, and its radix rule (7 from 2^14 slots) leaves 8 of the 42
    rows, level 7, which does not reach even the reach-limited profile's
    level 11; the port's radix 8 leaves 12 rows, level 11, where the
    reach-limited profile puts the bootstrap. Neither package's arithmetic
    changes: only the radix and the compiler profile do."""
    _, prog = jax_compiled
    cfg = PROFILES["tpu_n16"]
    assert dataclasses.asdict(REF_PROFILES["tpu_n16"]) == dataclasses.asdict(cfg)
    jax_radix = 7 if cfg.n_slots >= (1 << 14) else 5     # dacapo_tpu/runtime/runner.py:81
    jax_reach = rows_left(ctx16, sized_for_secret(
        BootstrapConfig(radix=jax_radix), cfg.secret_h, cfg.n)) - 1
    port_reach = rows_left(ctx16, native_config(cfg)) - 1
    jax_targets = {op.rhs for op in prog.ops if op.opcode == REF_BOOTSTRAP}
    assert (jax_radix, jax_reach, jax_targets) == (7, 7, {29})
    assert (native_config(cfg).radix, port_reach) == (8, 11)
    assert max(jax_targets) > port_reach > jax_reach
    assert EXPECTED["bootstrap_target_levels"] == [port_reach]
