"""LinearRegression benchmark: 2-epoch encrypted gradient descent
(reference examples/benchmarks/LinearRegression.py:12-37)."""

import numpy as np

from dacapo_tpu_torch.models.kernels import linreg_body
from dacapo_tpu_torch.runtime.harness import trace_and_save


def trace(dirs="traced", cst_dirs=None, nt=4096):
    log_n = int(np.log2(nt))
    return trace_and_save(
        "LinearRegression", "c,c",
        lambda x, y: linreg_body(x, y, log_n=log_n, n_mean=nt // 2),
        dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
