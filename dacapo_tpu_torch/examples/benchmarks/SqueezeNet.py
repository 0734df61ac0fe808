"""SqueezeNet benchmark: CIFAR SqueezeNet (Fire modules) with SiLU
activations under MPCB packing (reference examples/benchmarks/
SqueezeNet.py). Weights are deterministic-random with calibrated BN."""

from dacapo_tpu_torch.models.zoo import squeezenet, randomize
from dacapo_tpu_torch.models.cnn_he import squeezenet_he_forward
from dacapo_tpu_torch.runtime.harness import trace_and_save


def get_model(seed=0):
    return randomize(squeezenet(), seed=seed).double()


def trace(dirs="traced", cst_dirs=None, nt=2 ** 15, model=None):
    model = model or get_model()
    return trace_and_save(
        "SqueezeNet", "c",
        lambda x: squeezenet_he_forward(x, model, nt=nt), dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
