"""VGG16 benchmark: CIFAR VGG16 with SiLU activations under MPCB packing,
bootstrapped per block (reference examples/benchmarks/VGG16.py). Weights are
deterministic-random with calibrated BN."""

from dacapo_tpu_torch.models.zoo import vgg16, randomize
from dacapo_tpu_torch.models.cnn_he import vgg16_he_forward
from dacapo_tpu_torch.runtime.harness import trace_and_save


def get_model(seed=0):
    return randomize(vgg16(), seed=seed).double()


def trace(dirs="traced", cst_dirs=None, nt=2 ** 15, model=None):
    model = model or get_model()
    return trace_and_save(
        "VGG16", "c",
        lambda x: vgg16_he_forward(x, model, nt=nt), dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
