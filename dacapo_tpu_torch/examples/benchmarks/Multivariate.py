"""Multivariate benchmark: three 3-feature linear regressions trained under
HE (reference examples/benchmarks/Multivariate.py)."""

import numpy as np

from dacapo_tpu_torch.models.kernels import multivariate_body
from dacapo_tpu_torch.runtime.harness import trace_and_save


def trace(dirs="traced", cst_dirs=None, nt=4096):
    log_n = int(np.log2(nt))
    return trace_and_save(
        "Multivariate", "c,c,c,c,c,c",
        lambda *a: multivariate_body(*a, log_n=log_n, n_mean=nt // 2),
        dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
