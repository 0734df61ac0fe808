"""The port's compiler (passes/, vm/lower.py, runtime/harness.py) against
the JAX package's: the same traced functions through every pipeline give
byte-equal .hevm files; the port's compile_traced regenerates the committed
artifacts byte for byte; the DaCapo planner's candidate analysis and its
refusal of a deep circuit under pars agree; programs the port compiles run
encrypted on the port (device="cpu", the device oracle where they
bootstrap) within the tolerances of tests/test_compile_e2e.py and
tests/test_dacapo.py; and vm/simulate.py gives the JAX package's arrays.
The slow case recompiles ResNet-20 dacapo 40 (about 15 minutes)."""

import hashlib
import json
import os

import numpy as np
import pytest

from dacapo_tpu.ir import trace as ref_trace
from dacapo_tpu.ir.config import load_profile as ref_load_profile
from dacapo_tpu.ir.serialize import read_cst as ref_read_cst
from dacapo_tpu.passes import rewrite as ref_rewrite
from dacapo_tpu.passes.dacapo import CandidateAnalysis as RefCandidates
from dacapo_tpu.passes.dacapo import remove_bootstrap as ref_remove_bootstrap
from dacapo_tpu.passes.pipeline import compile_function as ref_compile
from dacapo_tpu.passes.scale import TypeInferenceError as RefTypeError
from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram
from dacapo_tpu.vm.simulate import simulate as ref_simulate
from dacapo_tpu_torch.crypto.params import COMPILER_PROFILES, PROFILES
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.ir import trace as port_trace
from dacapo_tpu_torch.ir.config import load_profile
from dacapo_tpu_torch.ir.serialize import read_cst
from dacapo_tpu_torch.models import deep, mlp
from dacapo_tpu_torch.passes import rewrite
from dacapo_tpu_torch.passes.dacapo import CandidateAnalysis, remove_bootstrap
from dacapo_tpu_torch.passes.pipeline import compile_function
from dacapo_tpu_torch.passes.scale import TypeInferenceError
from dacapo_tpu_torch.runtime.harness import compile_traced, trace_and_save
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP
from dacapo_tpu_torch.vm.simulate import simulate

PROFILE = "test_n10"
N_SLOTS = PROFILES[PROFILE].n_slots
ART = os.path.join(os.path.dirname(__file__), "..", "dacapo_tpu_torch", "artifacts")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _cfg():
    ref_load_profile(COMPILER_PROFILES[PROFILE])
    load_profile(COMPILER_PROFILES[PROFILE])


def _trace(hc, rw, body):
    """tests/test_compile_e2e.py:_trace on one side's tracer and rewrites."""
    hc._module.reset()
    fn = hc.func("c")(body).eval()
    rw.cse(fn)
    rw.canonicalize(fn)
    payloads = rw.elide_constants(fn)
    rw.privatize_constants(fn)
    rw.canonicalize(fn)
    return fn, payloads


def _bodies(hc):
    """The programs of tests/test_compile_e2e.py and tests/test_dacapo.py,
    over one side's tracer: name -> (body, golden(x), input range)."""
    c = np.linspace(0.1, 0.9, N_SLOTS)
    mask = np.zeros(N_SLOTS)
    mask[:4] = 1.0
    half = np.full(N_SLOTS, 0.5)

    def poly(x):
        return (x * x + x) * hc.Plain(c) + 1.0

    def reduce(x):
        acc = x
        for k in (1, 2, 4):
            acc = acc + acc.rotate(k)
        return acc * hc.Plain(mask)

    def square_half(x):
        return x * x * hc.Plain(half)

    def chain(x):
        y = x
        for _ in range(4):
            y = y * x
        return y

    def reduce_golden(x):
        acc = x.copy()
        for k in (1, 2, 4):
            acc = acc + np.roll(acc, -k)
        return acc * mask

    return {
        "poly": (poly, lambda x: (x * x + x) * c + 1.0, (-1, 1)),
        "reduce": (reduce, reduce_golden, (-1, 1)),
        "square_half": (square_half, lambda x: x * x * 0.5, (-1, 1)),
        "chain": (chain, lambda x: x ** 5, (0.3, 1.0)),
    }


def _deep(hc, depth=10):
    mask = np.full(N_SLOTS, 0.9)

    def body(x):
        y = x
        for i in range(depth):
            y = y * x
            y = y + y.rotate(1 + i)
            y = y * hc.Plain(mask)
        return y

    return body


def _both(name, tmp_path, pipeline, waterline):
    """Compile one program with both packages; returns the two .hevm paths."""
    paths = []
    for hc, rw, comp, side in ((ref_trace, ref_rewrite, ref_compile, "jax"),
                               (port_trace, rewrite, compile_function, "port")):
        body = _deep(hc) if name == "deep" else _bodies(hc)[name][0]
        fn, _ = _trace(hc, rw, body)
        # ELASM's annealing: seeded, small, in this process
        opts = dict(seed=0, parallel=4, num_iter=5, workers=1) if pipeline == "elasm" else {}
        prog = comp(fn, pipeline, waterline, **opts)
        paths.append(str(tmp_path / f"{side}.hevm"))
        prog.save(paths[-1])
    return paths


@pytest.mark.parametrize("pipeline, name, waterline", [
    ("eva", "square_half", 25), ("eva", "poly", 25), ("pars", "poly", 25),
    ("pars", "reduce", 25), ("pars", "chain", 25), ("snr", "chain", 20),
    ("snr", "reduce", 20), ("elasm", "poly", 20), ("dacapo", "deep", 25),
])
def test_hevm_bytes_equal_jax(tmp_path, pipeline, name, waterline):
    want, got = _both(name, tmp_path, pipeline, waterline)
    assert _bytes(got) == _bytes(want)
    if pipeline == "dacapo":
        assert any(op.opcode == OP_BOOTSTRAP for op in HEVMProgram.load(got).ops)


@pytest.fixture(scope="module")
def traced_mlp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlp")
    w = mlp.gen_weights()
    trace_and_save("MLP", "c", lambda x: mlp.mlp_forward(x, w), str(tmp / "traced"))
    return tmp


@pytest.mark.parametrize("art, name, pipeline, waterline, profile", [
    ("mlp_pars25_test_n11", "MLP", "pars", 25, "test_n11"),
    ("mlp_pars40_tpu_n15", "MLP", "pars", 40, "tpu_n15"),
    ("deep_dacapo40_tpu_n15b", "Deep", "dacapo", 40, "tpu_n15b"),
])
def test_compile_traced_regenerates_the_artifacts(traced_mlp, tmp_path, art, name,
                                                  pipeline, waterline, profile):
    """The hc-test flow in the port alone: trace, then compile_traced."""
    traced = traced_mlp / "traced"
    if name == "Deep":
        traced = tmp_path / "traced"
        with open(os.path.join(ART, art, "expected.json")) as f:
            depth = json.load(f)["depth"]
        deep.trace_deep(str(traced), PROFILES[profile].n_slots, depth)
    hv = compile_traced(name, pipeline, waterline, profile, traced_dir=str(traced),
                        out_dir=str(tmp_path / "optimized"))
    assert hv == str(tmp_path / "optimized" / pipeline /
                     f"{name}.{waterline}._hecate_{name}.hevm")
    assert _bytes(hv) == _bytes(os.path.join(ART, art, f"{name}.hevm"))
    assert _bytes(str(traced / f"_hecate_{name}.cst")) == \
        _bytes(os.path.join(ART, art, f"{name}.cst"))


def test_candidate_analysis_equal():
    got = []
    for hc, rw, rb, ca in ((ref_trace, ref_rewrite, ref_remove_bootstrap, RefCandidates),
                           (port_trace, rewrite, remove_bootstrap, CandidateAnalysis)):
        fn, _ = _trace(hc, rw, _deep(hc))
        rb(fn)
        a = ca(fn)
        got.append((sorted(a.edges), a.ret_opid, len(a.values),
                    [list(a.values[e].live_outs) for e in sorted(a.edges) if e > 0]))
    assert got[0] == got[1]
    assert len(got[1][0]) > 3 and got[1][1] == got[1][2] - 1


def test_pars_fails_on_deep_circuit():
    with pytest.raises(RefTypeError):
        ref_compile(_trace(ref_trace, ref_rewrite, _deep(ref_trace))[0], "pars", 25)
    with pytest.raises(TypeInferenceError):
        compile_function(_trace(port_trace, rewrite, _deep(port_trace))[0], "pars", 25)


@pytest.fixture(scope="module")
def scheme():
    s = Scheme(PROFILE, device="cpu")
    s.generate_keys()
    return s


def _run(scheme, name, pipeline, waterline, seed):
    """Compile with the port, run encrypted on the port (segment path)."""
    load_profile(COMPILER_PROFILES[PROFILE])
    body, golden, (lo, hi) = ((_deep(port_trace), lambda x: deep.deep_golden(x, 10),
                               (0.4, 0.9)) if name == "deep"
                              else _bodies(port_trace)[name])
    fn, payloads = _trace(port_trace, rewrite, body)
    prog = compile_function(fn, pipeline, waterline)
    ex = HEVMExecutor(scheme, prog, payloads)
    ex.preprocess()
    x = np.random.default_rng(seed).uniform(lo, hi, N_SLOTS)
    return ex, ex.run([x])[0], golden(x)


@pytest.mark.parametrize("name, pipeline, seed, bar", [
    ("poly", "pars", 0, 2e-3), ("reduce", "pars", 1, 2e-3),
    ("square_half", "eva", 2, 2e-3), ("chain", "pars", 3, 5e-3),
])
def test_port_compiled_programs_run(scheme, name, pipeline, seed, bar):
    _, out, want = _run(scheme, name, pipeline, 25, seed)
    assert float(np.sqrt(np.mean((out - want) ** 2))) < bar


def test_dacapo_program_runs_on_the_device_oracle(scheme):
    """The bootstrapped program the port compiles, on the oracle's device
    path (the default), within tests/test_dacapo.py's bar."""
    ex, out, want = _run(scheme, "deep", "dacapo", 25, 0)
    n_boot = sum(op.opcode == OP_BOOTSTRAP for op in ex.prog.ops)
    assert n_boot > 0 and ex.bootstrapper.calls == n_boot
    assert not ex.bootstrapper.host_rng
    assert float(np.sqrt(np.mean((out - want) ** 2))) < 5e-2


def test_hevm_roundtrip(tmp_path):
    fn, _ = _trace(port_trace, rewrite, lambda x: x * x)
    prog = compile_function(fn, "pars", 25)
    prog.save(str(tmp_path / "t.hevm"))
    back = HEVMProgram.load(str(tmp_path / "t.hevm"))
    assert (back.res_dst, back.arg_scale) == (prog.res_dst, prog.arg_scale)
    assert [(o.opcode, o.dst, o.lhs, o.rhs) for o in back.ops] == \
        [(o.opcode, o.dst, o.lhs, o.rhs) for o in prog.ops]


@pytest.mark.parametrize("steer", [False, True, "global"])
def test_simulate_equals_jax(steer):
    """vm/simulate.py on the committed tpu_n15 MLP: outputs, scales, the
    scale audit and the headroom equal the JAX package's, array for array."""
    d = os.path.join(ART, "mlp_pars40_tpu_n15")
    x = mlp.make_input(0)
    got = simulate(HEVMProgram.load(os.path.join(d, "MLP.hevm")),
                   read_cst(os.path.join(d, "MLP.cst")), [x], "tpu_n15", steer=steer)
    want = ref_simulate(RefProgram._load_py(os.path.join(d, "MLP.hevm")),
                        ref_read_cst(os.path.join(d, "MLP.cst")), [x], "tpu_n15",
                        steer=steer)
    assert len(got.outputs) == len(want.outputs) == 1
    for (g, gs), (w, ws) in zip(got.outputs, want.outputs):
        np.testing.assert_array_equal(g, w)
        assert gs == ws
    assert got.scale_mismatches == want.scale_mismatches
    assert got.max_raw_log2 == want.max_raw_log2


@pytest.mark.slow
def test_resnet_artifact_regenerates(tmp_path):
    """ResNet-20 dacapo 40 (tpu_n15), traced and compiled by the port alone:
    the committed .hevm byte for byte (about 15 minutes on one core)."""
    from dacapo_tpu_torch.models import cnn_he, resnet
    d = os.path.join(ART, "resnet_dacapo40_tpu_n15")
    with open(os.path.join(d, "expected.json")) as f:
        expected = json.load(f)
    ckpt = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                        "resnet20.silu.model")
    traced = str(tmp_path / "traced")
    cnn_he.trace_resnet(traced, resnet.get_model(ckpt), nt=expected["nt"])
    hv = compile_traced("ResNet", "dacapo", 40, "tpu_n15", traced_dir=traced,
                        out_dir=str(tmp_path / "optimized"))
    assert hashlib.sha256(_bytes(hv)).hexdigest() == expected["hevm_sha256"]
    assert _bytes(hv) == _bytes(os.path.join(d, "ResNet.hevm"))
