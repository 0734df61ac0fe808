"""AlexNet benchmark: CIFAR AlexNet with SiLU activations under MPCB
packing, bootstrapped between stages (reference examples/benchmarks/
AlexNet.py). Weights are deterministic-random with calibrated BN."""

from dacapo_tpu_torch.models.zoo import alexnet, randomize
from dacapo_tpu_torch.models.cnn_he import alexnet_he_forward
from dacapo_tpu_torch.runtime.harness import trace_and_save


def get_model(seed=0):
    return randomize(alexnet(), seed=seed).double()


def trace(dirs="traced", cst_dirs=None, nt=2 ** 15, model=None):
    model = model or get_model()
    return trace_and_save(
        "AlexNet", "c",
        lambda x: alexnet_he_forward(x, model, nt=nt), dirs, cst_dirs)


if __name__ == "__main__":
    print(trace())
