"""dacapo_tpu_torch: the PyTorch/CUDA port of dacapo_tpu's CKKS runtime.

Runs compiled `.hevm`/`.cst` programs encrypted on an NVIDIA H100 (or, with
device="cpu", on the plain PyTorch path). The NTT is a hand-written CUDA
kernel (csrc/ntt.cu); everything else is PyTorch. Imports neither JAX nor
the dacapo_tpu package.

The top-level namespace carries the JAX package's `hc`-compatible names
(`import hecate as hc`): `@hc.func("c")`, `hc.Plain`, `hc.Empty`, `hc.save`,
`hc.bootstrap`, the compiler configuration, `hc.setLibnHW` and `hc.HEVM`,
from the port's own tracer and configuration (ir/trace.py, ir/config.py).
"""

from .crypto.scheme import Scheme
from .ir.config import CompilerConfig, current_config, load_profile, set_config
from .ir.trace import Empty, Expr, Plain, bootstrap, func, resolve, save
from .runtime.runner import HEVM, current_profile, setLibnHW

__all__ = ["HEVM", "Scheme", "current_profile", "setLibnHW", "func", "Plain", "Empty",
           "Expr", "save", "bootstrap", "resolve", "load_profile", "current_config",
           "set_config", "CompilerConfig"]
