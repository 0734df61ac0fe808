#!/usr/bin/env python3
"""Regenerate dacapo_tpu_torch/artifacts/deep_dacapo40_tpu_n15b with the JAX
package (on the CPU, about 2 s):

    JAX_PLATFORMS=cpu python3 scripts/make_native_artifact.py

The program is the deep circuit of tests/test_dacapo.py (y = y * x;
y = y + rot(y, 1 + i); y = y * 0.9, DEPTH times) over the full 2^14 slots of
tpu_n15b, traced by the JAX tracer and compiled by its `dacapo` pipeline at
waterline 40 against profiled_TPU_n15b. DaCapo places its bootstraps, which
the port runs natively on that profile. Writes Deep.cst, Deep.hevm and
expected.json (depth, input seed and range, counts, digests).

The input draws x uniform in [0.5, 0.55]: each step multiplies the value by
about 1.8 x <= 0.99, so every bootstrap input stays inside the EvalMod
geometry (|value| well below 1).

tests/test_torch_artifacts_native.py regenerates the files and compares them
byte for byte; tests/test_torch_executor_native.py compiles the same circuit
for test_boot with compile_deep.
"""

import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "deep_dacapo40_tpu_n15b")
PROFILE = "tpu_n15b"
DEPTH = 20
WATERLINE = 40
X_SEED = 0
X_RANGE = (0.5, 0.55)


def deep_body(n_slots, depth):
    """The circuit of tests/test_dacapo.py:_deep_body."""
    import dacapo_tpu as hc
    mask = np.full(n_slots, 0.9)

    def body(x):
        y = x
        for i in range(depth):
            y = y * x                      # burn a level each time
            y = y + y.rotate(1 + i)        # SMU-crossing edges
            y = y * hc.Plain(mask)
        return y

    return body


def deep_golden(x, depth):
    """The plaintext model of deep_body."""
    y = x.copy()
    for i in range(depth):
        y = y * x
        y = y + np.roll(y, -(1 + i))
        y = y * 0.9
    return y


def compile_deep(out_dir, profile=PROFILE, depth=DEPTH, waterline=WATERLINE,
                 compiler_profile=None):
    """Trace and compile the deep circuit with the JAX package; writes
    out_dir/Deep.cst and out_dir/Deep.hevm. compiler_profile: a profile name
    or json path (default: the profile's own). Returns (program, payloads)."""
    import dacapo_tpu as hc
    from dacapo_tpu.crypto.params import COMPILER_PROFILES, PROFILES
    from dacapo_tpu.ir import trace as trace_mod
    from dacapo_tpu.ir.config import load_profile
    from dacapo_tpu.ir.serialize import write_cst
    from dacapo_tpu.passes.pipeline import compile_function
    from dacapo_tpu.passes.rewrite import (cse, canonicalize, elide_constants,
                                           privatize_constants)
    load_profile(compiler_profile or COMPILER_PROFILES[profile])
    trace_mod._module.reset()
    fn = hc.func("c")(deep_body(PROFILES[profile].n_slots, depth)).eval()
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    privatize_constants(fn)
    canonicalize(fn)
    prog = compile_function(fn, "dacapo", waterline)
    os.makedirs(out_dir, exist_ok=True)
    write_cst(payloads, os.path.join(out_dir, "Deep.cst"))
    prog._save_py(os.path.join(out_dir, "Deep.hevm"))
    return prog, payloads


def sha256_file(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main():
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dacapo_tpu.vm.hevm import OP_BOOTSTRAP, OP_ENCODE
    prog, _ = compile_deep(ART)
    boots = [op for op in prog.ops if op.opcode == OP_BOOTSTRAP]
    expected = {
        "program": "the deep circuit of tests/test_dacapo.py over 2^14 slots, depth "
                   f"{DEPTH}, dacapo, waterline {WATERLINE}, compiler profile "
                   "profiled_TPU_n15b; scripts/make_native_artifact.py:compile_deep",
        "profile": PROFILE,
        "depth": DEPTH,
        "waterline": WATERLINE,
        "input": f"numpy.random.default_rng({X_SEED}).uniform({X_RANGE[0]}, "
                 f"{X_RANGE[1]}, 16384)",
        "input_seed": X_SEED,
        "input_range": list(X_RANGE),
        "golden": "scripts/make_native_artifact.py:deep_golden(x, depth)",
        "instructions": len(prog.ops),
        "encodes": sum(op.opcode == OP_ENCODE for op in prog.ops),
        "bootstraps": len(boots),
        "bootstrap_target_levels": [op.rhs for op in boots],
        "rotation_offsets": len({o for o in prog.rotation_offsets() if o != 0}),
        "cst_sha256": sha256_file(os.path.join(ART, "Deep.cst")),
        "hevm_sha256": sha256_file(os.path.join(ART, "Deep.hevm")),
        "rms_bar": 1e-4,
    }
    with open(os.path.join(ART, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")
    print(json.dumps(expected))


if __name__ == "__main__":
    main()
