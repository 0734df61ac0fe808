"""MLP golden test (reference examples/tests/MLP.py)."""

from dacapo_tpu_torch.models.mlp import gen_weights, mlp_plain, make_input
from dacapo_tpu_torch.runtime.harness import run_test
from dacapo_tpu_torch.examples.benchmarks.MLP import trace


def run(pipeline="pars", waterline=40, profile=None, nt=2 ** 14, **kw):
    # nt=2^14 packed slots needs n_slots >= 2^14 -> N=2^15 (the reference
    # MLP trace regime; tpu_n14 only has 2^13 slots and encode would wrap)
    profile = profile or "tpu_n15"
    x = make_input()
    w = gen_weights()
    trace(nt=nt)
    want = mlp_plain(x, w)
    return run_test("MLP", pipeline, waterline, profile, [x], want,
                    postprocess=lambda res: res[0][:10],
                    **kw)


if __name__ == "__main__":
    import sys
    run(*(sys.argv[1:] or []))
