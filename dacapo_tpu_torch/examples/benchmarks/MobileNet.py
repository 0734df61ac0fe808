"""MobileNet benchmark: CIFAR MobileNetV1 (depthwise + pointwise ConvBN)
with SiLU activations under MPCB packing (reference examples/benchmarks/
MobileNet.py). Weights are deterministic-random with calibrated BN."""

from dacapo_tpu_torch.models.zoo import mobilenet, randomize
from dacapo_tpu_torch.models.cnn_he import mobilenet_he_forward
from dacapo_tpu_torch.runtime.harness import trace_and_save


def get_model(seed=0):
    return randomize(mobilenet(), seed=seed).double()


def trace(dirs="traced", cst_dirs=None, nt=2 ** 15, model=None):
    model = model or get_model()
    return trace_and_save(
        "MobileNet", "c",
        lambda x: mobilenet_he_forward(x, model, nt=nt), dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
