"""SobelFilter golden test (reference examples/tests/SobelFilter.py)."""

import numpy as np

from dacapo_tpu_torch.models.kernels import sobel_golden
from dacapo_tpu_torch.runtime.harness import run_test
from dacapo_tpu_torch.examples.benchmarks.SobelFilter import trace

PROFILE = "tpu_n14"


def case(nt=4096, w=64):
    """(inputs, golden, postprocess) of the run."""
    img = np.random.default_rng(100).uniform(0, 1, nt) * 0.5
    # decrypt returns the full slot vector (n_slots of the profile, e.g.
    # 8192 at tpu_n14); the traced image occupies the first nt slots
    return [img], sobel_golden(img, w=w), lambda res: np.asarray(res)[..., :nt]


def run(pipeline="pars", waterline=40, profile=None, nt=4096, w=64, **kw):
    profile = profile or PROFILE
    inputs, golden, post = case(nt=nt, w=w)
    trace(nt=nt, w=w)
    return run_test("SobelFilter", pipeline, waterline, profile,
                    inputs, golden, postprocess=post, **kw)


if __name__ == "__main__":
    import sys
    run(*(sys.argv[1:] or []))
