"""dacapo_tpu_torch: the PyTorch/CUDA port of dacapo_tpu's CKKS runtime.

Runs compiled `.hevm`/`.cst` programs encrypted on an NVIDIA H100 (or, with
device="cpu", on the plain PyTorch path). The NTT is a hand-written CUDA
kernel (csrc/ntt.cu); everything else is PyTorch. Imports neither JAX nor
the dacapo_tpu package.
"""

from .crypto.scheme import Scheme
from .runtime.runner import HEVM, current_profile, setLibnHW

__all__ = ["HEVM", "Scheme", "current_profile", "setLibnHW"]
