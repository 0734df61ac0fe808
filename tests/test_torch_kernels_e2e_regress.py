"""PolynomialRegression and Multivariate (the two regressions of the basic
list) through both packages at test_boot, as tests/test_torch_kernels_e2e.py
runs the other three bodies: byte-equal programs, bit-equal output
ciphertexts, and the RMS bars of tests/test_kernels_e2e.py. Also
scripts/make_basic_artifact.py rewrites the committed expected.json byte
for byte."""

import importlib.util
import os

import numpy as np

from dacapo_tpu.models import kernels as RK
from dacapo_tpu_torch.models import kernels as K
from test_torch_kernels_e2e import REPO, _one_thread, n_slots, rms, run_both  # noqa: F401


def test_polynomial_regression(tmp_path):
    n = n_slots()
    log_n = int(np.log2(n))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, n)
    y = 0.5 + 1.5 * x - 0.7 * x * x + rng.uniform(-0.01, 0.01, n)
    out, _ = run_both(tmp_path, lambda a, b: RK.polyreg_body(a, b, log_n=log_n, n_mean=n),
                      lambda a, b: K.polyreg_body(a, b, log_n=log_n, n_mean=n), 2, [x, y])
    W = K.polyreg_golden(x, y, n_mean=n)
    np.testing.assert_array_equal(W, RK.polyreg_golden(x, y, n_mean=n))
    got = np.array([out[i][0] for i in range(3)])
    assert rms(got, W) < 1e-3, (got, W)


def test_multivariate(tmp_path):
    n = n_slots()
    log_n = int(np.log2(n))
    rng = np.random.default_rng(4)
    X = [rng.uniform(-1, 1, n) for _ in range(3)]
    Y = [X[0] + 0.5 * X[1] - X[2] + rng.uniform(-0.01, 0.01, n) for _ in range(3)]
    out, _ = run_both(tmp_path, lambda *a: RK.multivariate_body(*a, log_n=log_n, n_mean=n),
                      lambda *a: K.multivariate_body(*a, log_n=log_n, n_mean=n), 6, X + Y)
    W = K.multivariate_golden(X, Y, n_mean=n)
    np.testing.assert_array_equal(W, RK.multivariate_golden(X, Y, n_mean=n))
    got = np.array([out[k][0] for k in range(9)]).reshape(3, 3)
    assert rms(got, W) < 1e-3, (got, W)


def test_make_basic_artifact_regenerates_expected(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_basic_artifact", os.path.join(REPO, "scripts", "make_basic_artifact.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(tmp_path))
    committed = os.path.join(mod.ART, "expected.json")
    with open(committed, "rb") as f, open(tmp_path / "expected.json", "rb") as g:
        assert f.read() == g.read()
