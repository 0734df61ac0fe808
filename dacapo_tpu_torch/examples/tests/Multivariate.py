"""Multivariate golden test (reference examples/tests/Multivariate.py)."""

import numpy as np

from dacapo_tpu_torch.models.kernels import multivariate_golden
from dacapo_tpu_torch.runtime.harness import run_test
from dacapo_tpu_torch.examples.benchmarks.Multivariate import trace

PROFILE = "tpu_n14"


def case(nt=4096, seed=100):
    """(inputs, golden, postprocess) of the run; another seed draws another
    input set (the batch rows of chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    X = [rng.uniform(-1, 1, nt) for _ in range(3)]
    Y = [X[0] + 0.5 * X[1] - X[2] + rng.uniform(-0.01, 0.01, nt)
         for _ in range(3)]
    W = multivariate_golden(X, Y, n_mean=nt // 2)
    return X + Y, W.ravel(), lambda res: [res[k][0] for k in range(9)]


def run(pipeline="pars", waterline=40, profile=None, nt=4096, **kw):
    profile = profile or PROFILE
    inputs, golden, post = case(nt=nt)
    trace(nt=nt)
    return run_test("Multivariate", pipeline, waterline, profile,
                    inputs, golden, postprocess=post, **kw)


if __name__ == "__main__":
    import sys
    run(*(sys.argv[1:] or []))
