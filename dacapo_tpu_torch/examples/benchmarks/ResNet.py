"""ResNet20 benchmark: CIFAR-10 ResNet with SiLU activations under MPCB
packing, bootstrapped between blocks (reference examples/benchmarks/
ResNet.py:39-136). Weights: the reference's trained checkpoint
(examples/data/resnet20.silu.model — the model behind the published
RMS 9.5152e-4); deterministic-random fallback when absent."""

import os

from dacapo_tpu_torch.models import resnet
from dacapo_tpu_torch.models.cnn_he import resnet_he_forward
from dacapo_tpu_torch.runtime.harness import trace_and_save

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
CKPT = os.path.join(_REPO, "examples", "data", "resnet20.silu.model")


def get_model(seed=0, pretrained=True):
    if pretrained and os.path.exists(CKPT):
        return resnet.get_model(CKPT)
    return resnet.randomize(resnet.resnet20(), seed=seed).double()


def trace(dirs="traced", cst_dirs=None, nt=2 ** 14, model=None):
    model = model or get_model()
    return trace_and_save(
        "ResNet", "c",
        lambda x: resnet_he_forward(x, model, nt=nt), dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
