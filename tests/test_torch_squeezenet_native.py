"""SqueezeNet `dacapo 40` on tpu_n15b with native bootstraps, on the CPU.

* The trace: SqueezeNet (the deterministic-random weights of
  examples/benchmarks/SqueezeNet.py, nt = 2^14) traced by both packages: the
  .eir.json without source locations and the .cst equal, and equal to the
  committed dacapo_tpu_torch/artifacts/squeezenet_dacapo40_tpu_n15b/
  expected.json (written by scripts/make_squeezenet_native_artifact.py).
* The committed SqueezeNet.hevm: expected.json's counts through both
  packages' readers, its bootstrap signatures by the port executor's walk.
* The dry plan (scripts/native_resnet_plan.py:plan) of the program on an
  NVIDIA H100 80GB HBM3: 734 galois keys (57.7 GB) past the 55 % key
  budget, so they stream from the host; nothing left for the bootstrap's
  planes (the plane bound is 0: only the running signature's group stays)
  and the planes each signature change encodes again.
* The prefix chip_smoke.py serves (conv_1, avgpool_1 and fire_2 at full
  width; expected.json's "prefix"): traced by the port
  (models/cnn_he.squeezenet_prefix_he_forward) and by the JAX package (its
  twin over the JAX package's modules, in the artifact script), equal;
  the committed SqueezeNetPrefix.hevm's counts and signatures; its
  exact-float simulation against expected.json's digest and against the
  torch model's activations packed by the output shapes' OutPack; its dry
  plan under its memory plan (keys past the key budget, plane bound 0).
* The hc-test flow's repairs: run_test(save_keys=False) keeps the full VM's
  keys in memory; the CLI's `test` takes --nt and --keys-in-memory.
* The paths' repairs: under a key budget the keys made go straight into
  the key store's slabs (pinned on the card); the encoder's residues past
  2^62 (a bootstrap's diagonals) are taken on the device, equal to the
  host encoder's; the per-op path drops the executor's graphs when the
  plaintexts stream (its plaintext LRU may take the whole budget).
* One Fire module (squeeze ConvBN + SiLU, the two expands, the concat; 4
  channels at 4x4, nt = 1024) traced and compiled with `dacapo` by the JAX
  package for test_boot with 44 Q primes (the native pipeline at radix 5
  leaves 14 rows: both level bounds at 13, where DaCapo places two
  bootstraps; at 9 it finds no plan), run encrypted with the native
  bootstrap by the JAX executor (per op) and by the port's (segment path,
  eager on the CPU): the output ciphertexts are bit-equal (the native
  bootstrap draws no randomness). The port runs it again under a memory
  plan shaped like SqueezeNet's on the card: its keys past the key budget
  (the graph windows' key arena, the bootstraps' keys through the LRU,
  which evicts under them), the plane bound 0; bit-equal again.
* Slow: the committed .hevm regenerated by the JAX compiler and by the
  port's own, byte for byte (two compiles of 47-53 minutes each).
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from dacapo_tpu.crypto.bootstrap_native import BootstrapConfig as RefConfig
from dacapo_tpu.crypto.params import PROFILES as REF_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.ir.serialize import read_cst as ref_read_cst
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram, OP_BOOTSTRAP as REF_BOOTSTRAP
from dacapo_tpu.vm.hevm import OP_ENCODE as REF_ENCODE
from dacapo_tpu_torch import cli
from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig, native_config
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.ir.serialize import function_digest, read_cst
from dacapo_tpu_torch.runtime.harness import run_test
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP, OP_ENCODE

ROOT = os.path.join(os.path.dirname(__file__), "..")
ART = os.path.join(ROOT, "dacapo_tpu_torch", "artifacts", "squeezenet_dacapo40_tpu_n15b")
PROFILE = "tpu_n15b"
# the Fire module's run: test_boot with 44 Q primes (4 digits of 11), the
# native bootstrap of tests/test_bootstrap.py at radix 5
FIRE_PROFILE = "test_boot"
FIRE_WIDER = dict(num_q=44, alpha=11)
FIRE_LEVEL_UPPER = 13          # the 14 rows the pipeline leaves, minus one
FIRE_CFG = dict(K=16, r=3, degree=36, baby=8, radix=5)
FIRE_NT, FIRE_HW = 1024, 4
SEED = 7


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


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


@pytest.fixture(scope="module")
def traces(tmp_path_factory, expected):
    """SqueezeNet traced by both packages at expected.json's nt: {package:
    (.eir.json, .cst)}."""
    from dacapo_tpu_torch.examples.benchmarks import SqueezeNet as port_bench
    from examples.benchmarks import SqueezeNet as jax_bench
    out = {}
    for name, bench in (("jax", jax_bench), ("port", port_bench)):
        d = str(tmp_path_factory.mktemp(f"squeezenet_{name}"))
        bench.trace(dirs=d, nt=expected["nt"], model=bench.get_model())
        out[name] = (os.path.join(d, "SqueezeNet.eir.json"),
                     os.path.join(d, "_hecate_SqueezeNet.cst"))
    return out


def test_traces_equal_the_jax_package(traces, expected):
    for eir, cst in traces.values():
        assert function_digest(eir) == expected["eir_json_sha256_without_loc"]
        assert os.path.getsize(cst) == expected["cst_bytes"]
        assert _sha(cst) == expected["cst_sha256"]


def _counts(prog, encode, boot):
    return dict(instructions=len(prog.ops),
                encodes=sum(op.opcode == encode for op in prog.ops),
                bootstraps=sum(op.opcode == boot for op in prog.ops),
                rotation_offsets=len({o for o in prog.rotation_offsets() if o != 0}))


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_expected_counts_equal_the_program(expected, reader):
    path = os.path.join(ART, "SqueezeNet.hevm")
    assert _sha(path) == expected["hevm_sha256"]
    prog, enc, boot = ((HEVMProgram.load(path), OP_ENCODE, OP_BOOTSTRAP) if reader == "port"
                       else (RefProgram.load(path), REF_ENCODE, REF_BOOTSTRAP))
    assert _counts(prog, enc, boot) == {k: expected[k] for k in
                                        ("instructions", "encodes", "bootstraps",
                                         "rotation_offsets")}
    assert sorted({op.rhs for op in prog.ops if op.opcode == boot}) == \
        expected["bootstrap_target_levels"]


def test_expected_signatures_are_the_executor_walk(expected):
    """The bootstrap signatures a load warms (HEVMExecutor._boot_signatures,
    walked without keys), and the runner's bootstrap configuration for
    tpu_n15b (radix 7 from 2^14 slots, K and degree sized for h = 192)."""
    prog = HEVMProgram.load(os.path.join(ART, "SqueezeNet.hevm"))
    sigs = _plan_script().boot_signatures(prog, PROFILE)
    assert [list(s) for s in sigs] == expected["boot_signatures"]
    assert 1 < len(sigs) < expected["bootstraps"]
    cfg = native_config(params.PROFILES[PROFILE])
    assert dataclasses.asdict(cfg) == expected["bootstrap_config"] and cfg.radix == 7


def test_dry_plan(traces, expected):
    """The plan of the program on the card (the payloads of the port's .cst
    decide the plaintext dedup): expected.json's numbers, and what they
    say: the keys pass the key budget and so stream from the host, the
    device holding the budget's bytes; the bootstrap's planes get a bound
    of 0 on both paths, so at most one signature's group is held and each
    change of signature in a request encodes its group again."""
    plan = _plan_script()
    prog = HEVMProgram.load(os.path.join(ART, "SqueezeNet.hevm"))
    got = plan.plan(prog, read_cst(traces["port"][1]), PROFILE, plan.H100_BYTES)
    want = expected["plan"]
    for k in ("galois_keys", "program_rotation_keys", "bootstrap_rotation_keys",
              "shared_rotation_keys", "key_bytes", "key_budget", "key_device_bytes",
              "unique_plaintexts", "resident_plaintext_bytes", "plaintexts_stream",
              "signatures", "planes_after_signature", "unbounded_plane_bytes"):
        assert got[k] == want[k], k
    assert got["paths"] == want["paths"]
    assert got["galois_keys"] == (got["program_rotation_keys"] + got["bootstrap_rotation_keys"]
                                  - got["shared_rotation_keys"] + 1)
    assert got["key_bytes"] == got["galois_keys"] * got["key_bytes_each"]
    assert got["keys_stream"] and got["key_device_bytes"] == got["key_budget"]
    groups = [b - a for a, b in zip(
        [0] + [p["diagonal_bytes"] + p["constant_bytes"]
               for p in got["planes_after_signature"]],
        [p["diagonal_bytes"] + p["constant_bytes"] for p in got["planes_after_signature"]])]
    changes = sum(a != b for a, b in zip(got["signatures"], got["signatures"][1:]))
    for path in ("per_op", "segment"):
        p = got["paths"][path]
        assert p["plane_budget"] == 0
        assert p["plane_bytes_held_most"] <= max(groups) < got["unbounded_plane_bytes"]
        assert p["reencoded_planes_per_request"] > 0 and p["evictions_per_request"] >= changes


# ------------------------------------------------------------ the prefix
def _artifact_script():
    spec = importlib.util.spec_from_file_location(
        "make_squeezenet_native_artifact",
        os.path.join(ROOT, "scripts", "make_squeezenet_native_artifact.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def prefix_traces(tmp_path_factory, expected):
    """The prefix traced by the port and by the JAX package: {package:
    (.eir.json, .cst)}, and the port's model."""
    from dacapo_tpu_torch.examples.benchmarks.SqueezeNet import get_model
    from dacapo_tpu_torch.models import cnn_he
    from dacapo_tpu_torch.runtime.harness import trace_and_save
    from examples.benchmarks.SqueezeNet import get_model as jax_model
    from examples.common import trace_and_save as jax_trace_and_save
    want = expected["prefix"]
    name = _artifact_script().PREFIX
    model = get_model()
    out = {}
    d = str(tmp_path_factory.mktemp("prefix_port"))
    trace_and_save(name, "c", lambda x: cnn_he.squeezenet_prefix_he_forward(
        x, model, fires=want["fires"], nt=expected["nt"]), d)
    out["port"] = (os.path.join(d, f"{name}.eir.json"), os.path.join(d, f"_hecate_{name}.cst"))
    d = str(tmp_path_factory.mktemp("prefix_jax"))
    jax_trace_and_save(name, "c", _artifact_script().jax_prefix_body(
        jax_model(), want["fires"], expected["nt"]), d)
    out["jax"] = (os.path.join(d, f"{name}.eir.json"), os.path.join(d, f"_hecate_{name}.cst"))
    return out, model


def test_prefix_traces_equal_the_jax_package(prefix_traces, expected):
    want = expected["prefix"]
    for eir, cst in prefix_traces[0].values():
        assert function_digest(eir) == want["eir_json_sha256_without_loc"]
        assert _sha(cst) == want["cst_sha256"]


def test_prefix_program(prefix_traces, expected):
    """The committed prefix: its counts and bootstrap signatures; its
    simulation equal to expected.json's digest and close to the torch
    model's activations at that point, packed as the program leaves them
    (the output shapes' OutPack); its dry plan under its memory plan: keys
    past the key budget, plaintexts streamed, plane bound 0."""
    from dacapo_tpu_torch.models import cnn_he
    from dacapo_tpu_torch.vm.simulate import simulate
    want = expected["prefix"]
    path = os.path.join(ART, "SqueezeNetPrefix.hevm")
    assert _sha(path) == want["hevm_sha256"]
    prog = HEVMProgram.load(path)
    assert _counts(prog, OP_ENCODE, OP_BOOTSTRAP) == {k: want[k] for k in (
        "instructions", "encodes", "bootstraps", "rotation_offsets")}
    assert len(prog.res_dst) == want["results"] and want["bootstraps"] >= 1
    constants = read_cst(prefix_traces[0]["port"][1])
    plan = _plan_script()
    assert [list(sg) for sg in plan.boot_signatures(prog, PROFILE, constants)] ==         want["boot_signatures"]
    model = prefix_traces[1]
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    packed = cnn_he.cnn_pack_input(x.numpy(), model.conv_1.Conv2d, nt=expected["nt"])
    sim = [np.ascontiguousarray(v) for v, _ in
           simulate(prog, constants, [packed], PROFILE, steer="global").outputs]
    assert hashlib.sha256(b"".join(v.tobytes() for v in sim)).hexdigest() ==         want["simulated_outputs_sha256"]
    with torch.no_grad():
        act = cnn_he.squeezenet_prefix_torch(x, model, fires=want["fires"]).numpy()
    golden = cnn_he.makeClose(cnn_he.squeezenet_prefix_shapes(
        model, fires=want["fires"], nt=expected["nt"]))["OP"](act)
    assert golden.shape == (len(sim), expected["nt"])
    rms = float(np.sqrt(np.mean((np.concatenate(sim) - golden.ravel()) ** 2)))
    assert rms == want["simulated_rms_vs_torch"] < want["rms_bar"] / 100
    got = plan.plan(prog, constants, PROFILE, want["hbm_bytes"])
    assert got["paths"] == want["plan"]["paths"]
    assert got["key_bytes"] == want["hbm_bytes"] and got["keys_stream"]
    assert got["plaintexts_stream"] and got["paths"]["segment"]["plane_budget"] == 0


# ------------------------------------------------------------ the repairs
def test_hc_test_flow_keeps_keys_in_memory(tmp_path, monkeypatch):
    """run_test(save_keys=False), the hc-test flow of a keyset too large to
    write (SqueezeNet on tpu_n15b: 57.7 GB): the full VM makes its keys and
    writes none; the same output as a flow that writes them (the committed
    test_n11 MLP, HOME in tmp: the runner's default keyset directory)."""
    art = os.path.join(ROOT, "dacapo_tpu_torch", "artifacts", "mlp_pars25_test_n11")
    traced, opt = tmp_path / "traced", tmp_path / "optimized" / "pars"
    traced.mkdir()
    opt.mkdir(parents=True)
    shutil.copyfile(os.path.join(art, "MLP.cst"), traced / "_hecate_MLP.cst")
    shutil.copyfile(os.path.join(art, "MLP.hevm"), opt / "MLP.25._hecate_MLP.hevm")
    x = np.random.default_rng(0).uniform(-1, 1, params.PROFILES["test_n11"].n_slots)
    outs = {}
    for save in (True, False):
        monkeypatch.setenv("HOME", str(tmp_path / f"home_{save}"))
        res, _, _ = run_test("MLP", "pars", 25, "test_n11", [x], np.zeros_like(x),
                             traced_dir=str(traced), out_dir=str(tmp_path / "optimized"),
                             device="cpu", save_keys=save)
        outs[save] = res[0]
        keyset = tmp_path / f"home_{save}" / ".hevm" / "torch" / "test_n11"
        assert keyset.exists() is save
        if save:
            assert len(os.listdir(keyset / "galois")) > 0
    assert np.array_equal(outs[True], outs[False])


@pytest.mark.parametrize("argv, want", [
    ([], dict(save_keys=True)),
    (["--nt", "16384", "--keys-in-memory"], dict(nt=16384, save_keys=False)),
])
def test_cli_test_passes_nt_and_keys_in_memory(argv, want, monkeypatch):
    """`test SqueezeNet dacapo 40 tpu_n15b --nt 16384 --keys-in-memory`: the
    example packs its input into 2^14 slots (the profile's; its own default
    is 2^15) and its full VM writes no key; without the options the example
    keeps its own nt and the VM writes its keys."""
    calls = []
    name = "dacapo_tpu_torch.examples.tests.SqueezeNet"
    monkeypatch.setitem(sys.modules, name, SimpleNamespace(
        run=lambda *a, **kw: calls.append((name, a, kw))))
    cli.main(["test", "SqueezeNet", "dacapo", "40", "tpu_n15b", "--device", "cpu"] + argv)
    assert calls == [("dacapo_tpu_torch.examples.tests.SqueezeNet", ("dacapo", 40),
                      dict(profile="tpu_n15b", device="cpu", **want))]


def test_big_residues_equal_the_host_encoder():
    """Evaluator.encoded_residues past INT64_BOUND (the mantissa/exponent
    branch, a bootstrap diagonal's ~2^60 scale) on the device: the integers
    Encoder._rns_residues gives, for single and batched coefficients, mixed
    magnitudes and signs, in chunks too."""
    s = Scheme("test_n11", device="cpu")
    rng = np.random.default_rng(0)
    n, rows = s.ctx.n, list(range(s.ctx.config.num_all))
    primes = [s.ctx.primes[r] for r in rows]
    for lead in [(), (3,), (2, 2)]:
        prod = rng.normal(size=lead + (n,)) * 2.0 ** rng.integers(0, 80, size=lead + (n,))
        prod.flat[0], prod.flat[1] = 2.0 ** 80, -3.3e20
        got = s.ev.encoded_residues(s.encoder, prod, rows)
        assert np.array_equal(to_host(got), s.encoder._rns_residues(prod, None, primes=primes))
    s.ev.BIG_RESIDUES_ELEMS = 5 * len(rows) * n // 2
    prod = rng.normal(size=(7, n)) * 2.0 ** 70
    assert np.array_equal(to_host(s.ev.encoded_residues(s.encoder, prod, rows)),
                          s.encoder._rns_residues(prod, None, primes=primes))


def test_per_op_drops_graphs_when_plaintexts_stream():
    """The per-op path's plaintext LRU may take the whole plaintext budget:
    with streaming plaintexts it drops the executor's graphs (the next
    segment request captures them again); resident, it keeps them."""
    for streaming in (True, False):
        ex = object.__new__(HEVMExecutor)
        ex.bootstrapper, ex._path_budgets, ex._streaming = None, None, streaming
        ex._captured = ex._captured_batch = graphs = object()
        ex._use_path("segment")
        assert ex._captured is graphs
        ex._use_path("per_op")
        assert (ex._captured is None and ex._captured_batch is None) is streaming


def test_script_loads_no_jax():
    """scripts/torch_squeezenet_native.py, which drives chip_smoke.py's
    squeezenet_native phase on the card, imports neither JAX nor the JAX
    package (nor does chip_smoke.py's phase, which it imports)."""
    code = ("import importlib.util, json, sys\n"
            "spec = importlib.util.spec_from_file_location('m', "
            "'scripts/torch_squeezenet_native.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "import chip_smoke\n"
            "from dacapo_tpu_torch.examples.benchmarks import SqueezeNet\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dacapo_tpu', 'examples'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


# -------------------------------------------------------- one Fire module
class TinyFire(nn.Module):
    """A Fire module (models/zoo.py Fire) at 4 channels: squeeze to 2
    (ConvBN + SiLU), expands of 4 (1x1) and 4 (3x3), concatenated."""

    def __init__(self):
        super().__init__()
        from dacapo_tpu.models.zoo import BasicConv2d
        self.squeeze = BasicConv2d(4, 2, 1)
        self.expand1x1 = nn.Conv2d(2, 4, 1)
        self.expand3x3 = nn.Conv2d(2, 4, 3, padding=1)

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1x1(x), self.expand3x3(x)], dim=1)


def fire_body(f):
    """One Fire module as dacapo_tpu/models/cnn_he.py squeezenet_he_forward
    traces it (its inner `fire`, bootstrap hints included), over a block of
    FIRE_HW x FIRE_HW at FIRE_NT slots, with the JAX package's tracer."""
    from dacapo_tpu.ir import trace as hc
    from dacapo_tpu.models.cnn_he import _wrap
    from dacapo_tpu.poly.hefunc import HE_Concat, HE_Conv, HE_ConvBN, HE_SiLU
    from dacapo_tpu.poly.mpcb import CascadeConcat, CascadeConv, makeClose

    def Fire(ctxt):
        bs, act = hc.bootstrap, HE_SiLU
        block_in = {"nt": FIRE_NT, "bb": 32, "ko": 1, "ho": FIRE_HW, "wo": FIRE_HW}
        sq = CascadeConv(block_in, f.squeeze.Conv2d)
        out = HE_ConvBN(makeClose(sq), bs(_wrap(ctxt)), f.squeeze.Conv2d, f.squeeze.bn)
        out = act(bs(out))
        e1 = CascadeConv(sq, f.expand1x1)
        out1 = HE_Conv(makeClose(e1), out, f.expand1x1)
        e3 = CascadeConv(sq, f.expand3x3)
        out2 = HE_Conv(makeClose(e3), out, f.expand3x3)
        cc = CascadeConcat(e1, e3)
        return HE_Concat(makeClose(cc), out1, out2)[0]

    return Fire


@pytest.fixture(scope="module")
def fire(tmp_path_factory):
    """The Fire module traced and compiled (dacapo, waterline 25) by the JAX
    package against test_boot's compiler profile with both level bounds at
    FIRE_LEVEL_UPPER; its packed input and torch output."""
    from dacapo_tpu.ir.config import load_profile
    from dacapo_tpu.ir.serialize import load_function
    from dacapo_tpu.models.cnn_he import cnn_pack_input
    from dacapo_tpu.models.resnet import randomize
    from dacapo_tpu.passes.pipeline import compile_function
    from examples.common import trace_and_save
    tmp = tmp_path_factory.mktemp("fire")
    f = randomize(TinyFire(), seed=0, calib_shape=(4, FIRE_HW, FIRE_HW)).double()
    eir = trace_and_save("Fire", "c", fire_body(f), str(tmp))
    with open(os.path.join(ROOT, "dacapo_tpu", "profiles",
                           "profiled_TPU_test_boot.json")) as fh:
        prof = json.load(fh)
    prof["levelUpperBound"] = prof["bootstrapLevelUpperBound"] = FIRE_LEVEL_UPPER
    path = str(tmp / "profiled_test_boot_fire.json")
    with open(path, "w") as fh:
        json.dump(prof, fh)
    load_profile(path)
    compile_function(load_function(eir), "dacapo", 25, out_prefix=str(tmp / "Fire"))
    x = torch.randn(1, 4, FIRE_HW, FIRE_HW, dtype=torch.double,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = f(x).numpy().ravel()
    packed = cnn_pack_input(x.numpy(), f.squeeze.Conv2d, nt=FIRE_NT, h0=FIRE_HW, w0=FIRE_HW)
    return dict(hevm=str(tmp / "Fire._hecate_Fire.hevm"), cst=str(tmp / "_hecate_Fire.cst"),
                packed=packed, want=want)


def _port_executor(fire, plan_bytes=None, arena=True):
    """The port's executor over the Fire program, keys from the JAX run's
    seed, preprocessed (and its key arena made, as HEVM.load makes it, when
    `arena`), under DACAPO_TPU_HBM_BYTES = plan_bytes when given (the
    budgets are set at construction and preprocess)."""
    mp = pytest.MonkeyPatch()
    if plan_bytes is not None:
        mp.setenv("DACAPO_TPU_HBM_BYTES", str(plan_bytes))
    try:
        s = Scheme(FIRE_PROFILE, config=dataclasses.replace(params.PROFILES[FIRE_PROFILE],
                                                            **FIRE_WIDER),
                   seed=SEED, device="cpu")
        s.generate_keys()
        s.enable_native_bootstrap(BootstrapConfig(**FIRE_CFG))
        ex = HEVMExecutor(s, HEVMProgram.load(fire["hevm"]), read_cst(fire["cst"]))
        ex.preprocess()
        if arena:
            ex.key_arena()
    finally:
        mp.undo()
    return ex


@pytest.fixture(scope="module")
def fire_runs(fire):
    """The Fire program by the JAX executor (per op) and by the port's
    (segment path), resident, on keysets of the same seed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = RefScheme(FIRE_PROFILE, config=dataclasses.replace(REF_PROFILES[FIRE_PROFILE],
                                                                 **FIRE_WIDER), seed=SEED)
        ref.generate_keys()
        ref.enable_native_bootstrap(RefConfig(**FIRE_CFG))
        rex = RefExecutor(ref, RefProgram.load(fire["hevm"]), ref_read_cst(fire["cst"]))
        rex.preprocess()
        ref_out = rex.run([fire["packed"]], jit=False)
        ex = _port_executor(fire)
        ex.run([fire["packed"]])
    finally:
        torch.set_num_threads(n)
    return dict(ref=[np.asarray(c) for c in rex._last_outputs[0]], ref_out=ref_out,
                ref_meta=[tuple(m) for m in rex._last_outputs[1]],
                port=[to_host(c) for c in ex._last_outputs[0]], ex=ex)


def test_fire_module_bit_equal(fire, fire_runs):
    ex = fire_runs["ex"]
    boots = [op for op in ex.prog.ops if op.opcode == OP_BOOTSTRAP]
    assert [op.rhs for op in boots] == [FIRE_LEVEL_UPPER] * 2
    assert ex.bootstrapper.calls == 2 and ex.last_bootstraps == dict(
        replayed=0, eager={"cpu": 2})
    assert ex.s.keys.galois.budget is None and ex.bootstrapper.plane_budget is None
    assert len(fire_runs["port"]) == len(fire_runs["ref"]) == 1
    for got, want in zip(fire_runs["port"], fire_runs["ref"]):
        np.testing.assert_array_equal(got, want)
    assert [tuple(m) for m in ex._last_outputs[1]] == fire_runs["ref_meta"]
    out = np.asarray(fire_runs["ref_out"][0])
    assert np.isfinite(out).all() and np.abs(out).max() < 1      # values over bb = 32


def test_fire_module_under_a_streaming_key_plan(fire, fire_runs, monkeypatch):
    """The Fire program under a memory plan shaped like SqueezeNet's on the
    card (DACAPO_TPU_HBM_BYTES = half its key bytes: the program's own keys
    pass the key budget): the keys stay on the host; the graph windows read
    theirs from the key arena, made with the LRU already evicted to the
    budget's rest (a load's bootstrap warm-up leaves the LRU full; here the
    program's keys fill it), and the native bootstraps read theirs through
    the LRU, which evicts keys under them (GaloisStore.generation grows;
    what the segment graphs are captured for does not change: they read the
    arena); the plane bound is 0. The keys are drawn in the resident run's
    order, so the output ciphertexts equal the resident run's, and so the
    JAX package's."""
    plan_bytes = fire_runs["ex"].key_bytes // 2
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ex = _port_executor(fire, plan_bytes, arena=False)
        galois = ex.s.keys.galois
        kb = ex.s.galois_key_bytes()
        # the program's keys, made under the budget, went straight into slabs
        assert galois._slabs and all(isinstance(h, torch.Tensor) for h in galois._host.values())
        for st in sorted(galois.keys()):        # the LRU filled
            galois[st]
        assert galois._dev_bytes + kb > galois.budget
        allocs = []
        empty = torch.empty

        def recorded(*shape, **kw):
            t = empty(*shape, **kw)
            if t.dim() == 5:
                allocs.append((t.nbytes, galois._dev_bytes))
            return t

        monkeypatch.setattr(torch, "empty", recorded)
        slots = ex.key_arena()
        monkeypatch.setattr(torch, "empty", empty)
        meta = ex._arg_meta()
        key0, gen0, up0 = ex._capture_key("segments", meta), galois.generation, galois.uploads
        ex.run([fire["packed"]])
    finally:
        torch.set_num_threads(n)
    assert ex.key_bytes > galois.budget and slots > 0
    # the arena's allocation (the key store's pinned slabs are 5-dim too),
    # beside what the LRU held then
    lru = [dev for size, dev in allocs if size == slots * kb]
    # the LRU holds no more than the budget leaves beside the arena and the
    # conjugation key (here nothing: a window reads 15 keys, the arena's
    # 15 slots pass the budget, as key_slot_count allows)
    assert len(lru) == 1 and lru[0] <= max(0, galois.budget - slots * kb - kb)
    assert ex.bootstrapper.plane_budget == 0 and ex.last_path == ("segment", None)
    assert ex.bootstrapper.calls == 2
    assert galois.uploads > up0 and galois.generation > gen0
    assert ex._capture_key("segments", meta) == key0
    assert ex.key_staging["host"] > 0
    for got, want in zip([to_host(c) for c in ex._last_outputs[0]], fire_runs["port"]):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- slow
@pytest.mark.slow
def test_both_compilers_reproduce_the_artifact(expected, tmp_path):
    """SqueezeNet traced and compiled for tpu_n15b (dacapo, waterline 40) by
    the JAX package (examples/common.py:compile_traced) and by the port
    (runtime/harness.compile_traced): both .hevm files equal the committed
    one byte for byte. 47-53 minutes of planning each on one core."""
    from dacapo_tpu_torch.examples.benchmarks import SqueezeNet as port_bench
    from dacapo_tpu_torch.runtime.harness import compile_traced as port_compile
    from examples.benchmarks import SqueezeNet as jax_bench
    from examples.common import compile_traced as jax_compile
    for name, bench, compile_traced in (("jax", jax_bench, jax_compile),
                                        ("port", port_bench, port_compile)):
        traced = str(tmp_path / name / "traced")
        bench.trace(dirs=traced, nt=expected["nt"], model=bench.get_model())
        hevm = compile_traced("SqueezeNet", "dacapo", 40, PROFILE, traced,
                              str(tmp_path / name / "optimized"))
        assert _sha(hevm) == expected["hevm_sha256"], name
