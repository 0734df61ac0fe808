"""MLP benchmark: 784 -> 100 (square) -> 10 diagonal-packed network
(reference examples/benchmarks/MLP.py)."""

from dacapo_tpu_torch.models.mlp import mlp_forward, gen_weights
from dacapo_tpu_torch.runtime.harness import trace_and_save


def trace(dirs="traced", cst_dirs=None, nt=2 ** 14):
    w = gen_weights()
    return trace_and_save("MLP", "c", lambda x: mlp_forward(x, w),
                          dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
