"""HarrisCornerDetection benchmark (reference examples/benchmarks/
HarrisCornerDetection.py)."""

from dacapo_tpu_torch.models.kernels import harris_body
from dacapo_tpu_torch.runtime.harness import trace_and_save


def trace(dirs="traced", cst_dirs=None, nt=4096, w=64):
    return trace_and_save("HarrisCornerDetection", "c",
                          lambda img: harris_body(img, w=w), dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
