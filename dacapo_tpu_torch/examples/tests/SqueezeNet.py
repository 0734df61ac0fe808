"""SqueezeNet golden test (reference examples/tests/SqueezeNet.py):
encrypted CIFAR-10 forward pass vs the torch model, RMS over the 10
channel-pooled logits."""

import torch

from dacapo_tpu_torch.models.cnn_he import cnn_pack_input, resnet_postprocess
from dacapo_tpu_torch.runtime.harness import run_test
from dacapo_tpu_torch.examples.benchmarks.SqueezeNet import trace, get_model


def run(pipeline="dacapo", waterline=40, profile=None, nt=2 ** 15, **kw):
    profile = profile or "tpu_n16"
    model = get_model()
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    trace(nt=nt, model=model)
    with torch.no_grad():
        want = model(x).numpy().ravel()
    packed = cnn_pack_input(x.numpy(), model.conv_1.Conv2d, nt=nt)
    return run_test("SqueezeNet", pipeline, waterline, profile,
                    [packed], want,
                    postprocess=lambda res: resnet_postprocess(res[0]),
                    **kw)


if __name__ == "__main__":
    import sys
    run(*(sys.argv[1:] or []))
