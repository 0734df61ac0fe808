"""The basic benchmark list through both packages, on the CPU (mirrors
tests/test_kernels_e2e.py): each body of dacapo_tpu_torch/models/kernels.py
(SobelFilter, HarrisCornerDetection, LinearRegression here;
PolynomialRegression and Multivariate in
tests/test_torch_kernels_e2e_regress.py) is traced by each package's tracer,
compiled with `pars` at waterline 25 for test_boot (byte-equal programs),
and run by each package's executor on keysets made from the same seed: the
JAX executor per-op, the port's on its default segment path. The output
ciphertexts are bit-equal, and the decrypted outputs meet the JAX test's
RMS bars against the numpy goldens.

Then the five rows as chip_smoke.py's basic phase serves them (pars/40 on
tpu_n14, PolynomialRegression on tpu_n15), compile only: the port's programs
equal the JAX package's and the committed digests of
dacapo_tpu_torch/artifacts/basic_pars40/expected.json."""

import hashlib
import importlib
import json
import os

import numpy as np
import pytest
import torch

import dacapo_tpu as ref_hc
from dacapo_tpu.crypto.params import COMPILER_PROFILES as REF_COMPILER_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.ir import trace as ref_trace
from dacapo_tpu.ir.config import load_profile as ref_load_profile
from dacapo_tpu.models import kernels as RK
from dacapo_tpu.passes import rewrite as ref_rewrite
from dacapo_tpu.passes.pipeline import compile_function as ref_compile
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from examples.common import compile_traced as ref_compile_traced
from dacapo_tpu_torch.crypto.params import COMPILER_PROFILES, to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.ir import trace as port_trace
from dacapo_tpu_torch.ir.config import load_profile
from dacapo_tpu_torch.ir.serialize import function_digest
from dacapo_tpu_torch.models import kernels as K
from dacapo_tpu_torch.passes import rewrite
from dacapo_tpu_torch.passes.pipeline import compile_function
from dacapo_tpu_torch.runtime.harness import compile_traced
from dacapo_tpu_torch.vm.executor import HEVMExecutor

PROFILE = "test_boot"      # 14-level chain: fits the 2-epoch GD traces
SEED = 21


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(trace_mod, func, rw, compile_fn, body, n_args, waterline):
    """Trace `body`, clean up as tests/test_kernels_e2e.py does, compile
    with pars; returns (program, payloads)."""
    trace_mod._module.reset()
    fn = func(",".join(["c"] * n_args))(body).eval()
    rw.cse(fn)
    rw.canonicalize(fn)
    payloads = rw.elide_constants(fn)
    rw.privatize_constants(fn)
    rw.canonicalize(fn)
    return compile_fn(fn, "pars", waterline), payloads


def run_both(tmp_path, ref_body, port_body, n_args, args, waterline=25):
    """Both packages' runs of one body; returns (port decrypted outputs,
    JAX decrypted outputs)."""
    ref_load_profile(REF_COMPILER_PROFILES[PROFILE])
    load_profile(COMPILER_PROFILES[PROFILE])
    ref_prog, ref_payloads = _program(ref_trace, ref_hc.func, ref_rewrite, ref_compile,
                                      ref_body, n_args, waterline)
    prog, payloads = _program(port_trace, port_trace.func, rewrite, compile_function,
                              port_body, n_args, waterline)
    ref_prog.save(str(tmp_path / "ref.hevm"))
    prog.save(str(tmp_path / "port.hevm"))
    assert (tmp_path / "ref.hevm").read_bytes() == (tmp_path / "port.hevm").read_bytes()
    for a, b in zip(payloads, ref_payloads):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    ref = RefScheme(PROFILE, seed=SEED)
    ref.generate_keys()
    ex = RefExecutor(ref, ref_prog, ref_payloads)
    ex.preprocess()
    ref_out = ex.run(args, jit=False)

    port = Scheme(PROFILE, seed=SEED, device="cpu")
    port.generate_keys()
    pex = HEVMExecutor(port, prog, payloads)
    pex.preprocess()
    out = pex.run(args)
    got_cts, got_meta = pex._last_outputs
    want_cts, want_meta = ex._last_outputs
    assert len(got_cts) == len(want_cts) == prog.res_length
    for g, w in zip(got_cts, want_cts):
        np.testing.assert_array_equal(to_host(g), np.asarray(w))
    assert [tuple(m) for m in got_meta] == [tuple(m) for m in want_meta]
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    return out, ref_out


def rms(a, b):
    d = np.asarray(a, np.float64).ravel() - np.asarray(b, np.float64).ravel()
    return float(np.sqrt(np.mean(d * d)))


def n_slots():
    from dacapo_tpu_torch.crypto.params import PROFILES
    return PROFILES[PROFILE].n_slots


def test_sobel(tmp_path):
    n, w = n_slots(), 16
    img = np.random.default_rng(0).uniform(0, 1, n) * 0.5
    out, _ = run_both(tmp_path, lambda x: RK.sobel_body(x, w=w),
                      lambda x: K.sobel_body(x, w=w), 1, [img])
    want = K.sobel_golden(img, w=w)
    np.testing.assert_array_equal(want, RK.sobel_golden(img, w=w))
    assert rms(out[0], want) < 5e-3, rms(out[0], want)


def test_harris(tmp_path):
    n, w = n_slots(), 16
    img = np.random.default_rng(1).uniform(0, 1, n) * 0.5
    out, _ = run_both(tmp_path, lambda x: RK.harris_body(x, w=w),
                      lambda x: K.harris_body(x, w=w), 1, [img])
    want = K.harris_golden(img, w=w)
    np.testing.assert_array_equal(want, RK.harris_golden(img, w=w))
    assert rms(out[0], want) < 5e-3, rms(out[0], want)


def test_linear_regression(tmp_path):
    n = n_slots()
    log_n = int(np.log2(n))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, n)
    y = 2.0 * x + 1.0 + rng.uniform(-0.01, 0.01, n)
    out, _ = run_both(tmp_path, lambda a, b: RK.linreg_body(a, b, log_n=log_n, n_mean=n),
                      lambda a, b: K.linreg_body(a, b, log_n=log_n, n_mean=n), 2, [x, y])
    W, b = K.linreg_golden(x, y, n_mean=n)
    assert (W, b) == RK.linreg_golden(x, y, n_mean=n)
    got = np.array([out[0][0], out[1][0]])
    assert rms(got, [W, b]) < 1e-3, (got, W, b)


# ------------------------------------------------- the rows at pars/40
ROWS = ("SobelFilter", "HarrisCornerDetection", "LinearRegression",
        "PolynomialRegression", "Multivariate")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "dacapo_tpu_torch") + os.sep
REF_DIR = os.path.join(REPO, "dacapo_tpu") + os.sep


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(PORT_DIR, "artifacts", "basic_pars40", "expected.json")) as f:
        return json.load(f)["rows"]


@pytest.mark.parametrize("name", ROWS)
def test_row_compiles_as_the_jax_package(name, expected, tmp_path):
    """The hc-trace/hopt steps of each row at its profile, pars/40: the port's
    .hevm, .cst and .eir.json (source directories mapped) equal the JAX
    package's byte for byte, and the .hevm's SHA-256 is expected.json's."""
    row = expected[name]
    ref_bench = importlib.import_module(f"examples.benchmarks.{name}")
    port_bench = importlib.import_module(f"dacapo_tpu_torch.examples.benchmarks.{name}")
    port_test = importlib.import_module(f"dacapo_tpu_torch.examples.tests.{name}")
    assert port_test.PROFILE == row["profile"]
    files = {}
    for tag, bench, compile_fn in (("jax", ref_bench, ref_compile_traced),
                                   ("port", port_bench, compile_traced)):
        traced = str(tmp_path / tag / "traced")
        bench.trace(dirs=traced, nt=row["nt"])
        hevm = compile_fn(name, "pars", 40, row["profile"], traced, str(tmp_path / tag / "opt"))
        files[tag] = [(tmp_path / tag / "traced" / f).read_bytes()
                      for f in (f"_hecate_{name}.cst", f"{name}.eir.json")] + [
            open(hevm, "rb").read()]
    (ref_cst, ref_eir, ref_hevm), (cst, eir, hevm) = files["jax"], files["port"]
    assert hevm == ref_hevm and cst == ref_cst
    assert hashlib.sha256(hevm).hexdigest() == row["hevm_sha256"]
    assert hashlib.sha256(cst).hexdigest() == row["cst_sha256"]
    mapped = eir.replace((PORT_DIR + "examples" + os.sep).encode(),
                         os.path.join(REPO, "examples", "").encode())
    assert PORT_DIR.encode() in mapped
    assert mapped.replace(PORT_DIR.encode(), REF_DIR.encode()) == ref_eir
    assert function_digest(str(tmp_path / "port" / "traced" / f"{name}.eir.json")) == \
        row["eir_json_sha256_without_loc"]
