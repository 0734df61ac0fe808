"""SobelFilter benchmark (reference examples/benchmarks/SobelFilter.py)."""

from dacapo_tpu_torch.models.kernels import sobel_body
from dacapo_tpu_torch.runtime.harness import trace_and_save


def trace(dirs="traced", cst_dirs=None, nt=4096, w=64):
    return trace_and_save("SobelFilter", "c",
                          lambda img: sobel_body(img, w=w), dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
