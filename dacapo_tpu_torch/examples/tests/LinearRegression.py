"""LinearRegression golden test (reference examples/tests/
LinearRegression.py): 2-epoch GD; compare learned (W, b)."""

import numpy as np

from dacapo_tpu_torch.models.kernels import linreg_golden
from dacapo_tpu_torch.runtime.harness import run_test
from dacapo_tpu_torch.examples.benchmarks.LinearRegression import trace

PROFILE = "tpu_n14"


def case(nt=4096):
    """(inputs, golden, postprocess) of the run."""
    rng = np.random.default_rng(100)
    x = rng.uniform(-1, 1, nt)
    y = 2.0 * x + 1.0 + rng.uniform(-0.01, 0.01, nt)
    W, b = linreg_golden(x, y, n_mean=nt // 2)
    return [x, y], [W, b], lambda res: [res[0][0], res[1][0]]


def run(pipeline="pars", waterline=40, profile=None, nt=4096, **kw):
    profile = profile or PROFILE
    inputs, golden, post = case(nt=nt)
    trace(nt=nt)
    return run_test("LinearRegression", pipeline, waterline, profile,
                    inputs, golden, postprocess=post, **kw)


if __name__ == "__main__":
    import sys
    run(*(sys.argv[1:] or []))
