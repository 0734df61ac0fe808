"""PolynomialRegression golden test (reference examples/tests/
PolynomialRegression.py)."""

import numpy as np

from dacapo_tpu_torch.models.kernels import polyreg_golden
from dacapo_tpu_torch.runtime.harness import run_test
from dacapo_tpu_torch.examples.benchmarks.PolynomialRegression import trace

# deeper than tpu_n14's 7 levels (PARS "failed to infer modswitch" =
# chain exhausted); the reference runs the basic list at SEAL N=2^15,
# 13 levels (profiled_SEAL_CPU.json) — use the parity profile
PROFILE = "tpu_n15"


def case(nt=4096):
    """(inputs, golden, postprocess) of the run."""
    rng = np.random.default_rng(100)
    x = rng.uniform(-1, 1, nt)
    y = 0.5 + 1.5 * x - 0.7 * x * x + rng.uniform(-0.01, 0.01, nt)
    W = polyreg_golden(x, y, n_mean=nt // 2)
    return [x, y], W, lambda res: [res[i][0] for i in range(3)]


def run(pipeline="pars", waterline=40, profile=None, nt=4096, **kw):
    profile = profile or PROFILE
    inputs, golden, post = case(nt=nt)
    trace(nt=nt)
    return run_test("PolynomialRegression", pipeline, waterline, profile,
                    inputs, golden, postprocess=post, **kw)


if __name__ == "__main__":
    import sys
    run(*(sys.argv[1:] or []))
