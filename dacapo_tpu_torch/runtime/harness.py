"""The trace and compile steps of the `hc-test` flow (PyTorch port).

Port of examples/common.py:19-43. `trace_and_save` is the `hc-trace` step:
trace one function with the port's tracer (ir/trace.py), run the cleanup
pipeline and write <dirs>/<Name>.eir.json and <cst_dirs>/_hecate_<Name>.cst.
`compile_traced` is the `hopt`/`hbt` step: the port's planner
(passes/pipeline.py) reads the .eir.json against a compiler profile and
writes <out_dir>/<pipeline>/<Name>.<waterline>._hecate_<Name>.hevm, the file
HEVM.load serves. Neither touches a device.
"""

import os
import time

from ..crypto.params import COMPILER_PROFILES
from ..ir import trace as trace_mod
from ..ir.config import load_profile
from ..ir.serialize import load_function
from ..passes.pipeline import compile_function


def trace_and_save(name, paramstr, body, dirs="traced", cst_dirs=None):
    """Trace `body` as the program `name` (paramstr: "c"/"p" per argument)
    and write its .eir.json and .cst. Returns the .eir.json path."""
    trace_mod._module.reset()
    body.__name__ = name
    trace_mod.func(paramstr)(body)
    return trace_mod.save(dirs, cst_dirs or dirs)


def compile_traced(name, pipeline, waterline, profile,
                   traced_dir="traced", out_dir="optimized"):
    """Earth IR -> scale-managed -> .hevm, for the crypto profile's compiler
    profile. Returns the .hevm path."""
    load_profile(COMPILER_PROFILES[profile])
    fn = load_function(os.path.join(traced_dir, f"{name}.eir.json"))
    prefix = os.path.join(out_dir, pipeline, f"{name}.{waterline}")
    t0 = time.perf_counter()
    compile_function(fn, pipeline, waterline, out_prefix=prefix)
    print(f"[hc] compile {name} ({pipeline},{waterline}): "
          f"{time.perf_counter()-t0:.1f}s", flush=True)
    return f"{prefix}._hecate_{name}.hevm"
