"""The `hc-trace`, `hopt` and `hc-test` steps of the benchmark flow (PyTorch
port of examples/common.py).

`trace_and_save` is the `hc-trace` step: trace one function with the port's
tracer (ir/trace.py), run the cleanup pipeline and write
<dirs>/<Name>.eir.json and <cst_dirs>/_hecate_<Name>.cst. `compile_traced` is
the `hopt`/`hbt` step: the port's planner (passes/pipeline.py) reads the
.eir.json against a compiler profile and writes
<out_dir>/<pipeline>/<Name>.<waterline>._hecate_<Name>.hevm. Neither touches
a device. `run_test` is the `hc-test` step: a full HEVM loads the two files
(compiling first when the .hevm is absent), encrypts the inputs, runs,
decrypts and reports latency and RMS against the golden with the runner's
printer block.
"""

import os
import time

import numpy as np
import torch

from ..crypto.params import COMPILER_PROFILES
from ..ir import trace as trace_mod
from ..ir.config import load_profile
from ..ir.serialize import load_function
from ..passes.pipeline import compile_function
from .runner import HEVM


def trace_and_save(name, paramstr, body, dirs="traced", cst_dirs=None):
    """Trace `body` as the program `name` (paramstr: "c"/"p" per argument)
    and write its .eir.json and .cst. Returns the .eir.json path."""
    trace_mod._module.reset()
    body.__name__ = name
    trace_mod.func(paramstr)(body)
    return trace_mod.save(dirs, cst_dirs or dirs)


def compile_traced(name, pipeline, waterline, profile,
                   traced_dir="traced", out_dir="optimized", compiler_profile=None):
    """Earth IR -> scale-managed -> .hevm, for the crypto profile's compiler
    profile, or `compiler_profile` (a profile name or json path, e.g. the
    reach-limited artifacts/deep_dacapo40_tpu_n16/profiled_TPU_n16_native.json).
    Returns the .hevm path."""
    load_profile(compiler_profile or COMPILER_PROFILES[profile])
    fn = load_function(os.path.join(traced_dir, f"{name}.eir.json"))
    prefix = os.path.join(out_dir, pipeline, f"{name}.{waterline}")
    t0 = time.perf_counter()
    compile_function(fn, pipeline, waterline, out_prefix=prefix)
    print(f"[hc] compile {name} ({pipeline},{waterline}): "
          f"{time.perf_counter()-t0:.1f}s", flush=True)
    return f"{prefix}._hecate_{name}.hevm"


def run_test(name, pipeline, waterline, profile, inputs, golden,
             postprocess=None, traced_dir="traced", out_dir="optimized",
             jit="auto", warmup=None, device=None):
    """Load the traced and compiled `name`, run it encrypted on `inputs`,
    compare with `golden` and print the report. Returns (output, latency
    seconds, RMS).

    warmup: untimed runs first; by default 1 on the card (the first request
    builds the Evaluator's device tables) and 0 on the CPU. The latency is a
    host clock around one run() that ends in torch.cuda.synchronize() on the
    card (run() decrypts to host arrays in full mode)."""
    hevm = HEVM(profile=profile, device=device, jit=jit)
    on_card = hevm.device.type == "cuda"
    if warmup is None:
        warmup = 1 if on_card else 0

    def sync():
        if on_card:
            torch.cuda.synchronize(hevm.device)

    cst = os.path.join(traced_dir, f"_hecate_{name}.cst")
    hv = os.path.join(out_dir, pipeline, f"{name}.{waterline}._hecate_{name}.hevm")
    if not os.path.exists(hv):
        compile_traced(name, pipeline, waterline, profile, traced_dir, out_dir)
    t0 = time.perf_counter()
    hevm.load(cst, hv)
    print(f"[hc] load+preencode: {time.perf_counter() - t0:.1f}s", flush=True)
    for i, dat in enumerate(inputs):
        hevm.setInput(i, dat)
    for w in range(warmup):
        t0 = time.perf_counter()
        hevm.run()
        sync()
        print(f"[hc] warmup run {w}: {time.perf_counter() - t0:.1f}s", flush=True)
    sync()
    t0 = time.perf_counter_ns()
    hevm.run()
    sync()
    latency = (time.perf_counter_ns() - t0) / 1e9
    res = hevm.getOutput()
    if postprocess is not None:
        res = postprocess(res)
    err = np.asarray(res, np.float64).ravel() - np.asarray(golden, np.float64).ravel()
    rms = float(np.sqrt(np.mean(err * err)))
    hevm.printer(latency, rms)
    return res, latency, rms
