#!/usr/bin/env python3
"""Regenerate dacapo_tpu_torch/artifacts/deep_dacapo40_tpu_n16 with the JAX
compiler (on the CPU, about a minute, most of it the dry plan):

    JAX_PLATFORMS=cpu python3 scripts/make_native_artifact_n16.py

The program is the deep circuit of tests/test_dacapo.py (y = y * x;
y = y + rot(y, 1 + i); y = y * 0.9, DEPTH times) over the 2^15 slots of
tpu_n16, the 128-bit-secure N = 2^16 profile, traced and compiled by the
JAX package (scripts/make_native_artifact.py:compile_deep, dacapo at
waterline 40) against profiled_TPU_n16_native.json beside the artifact: the
JAX package's profiled_TPU_n16.json with levelUpperBound and
bootstrapLevelUpperBound at 11, the level the port's native bootstrap
reaches there (radix 8 leaves 12 of the chain's 42 rows,
bootstrap_native.rows_left). Against the JAX package's own bounds (29 and
16) DaCapo lands every bootstrap at level 29, which no bootstrap of either
package reaches.

DEPTH is 6, one bootstrap: at depth 8 (two bootstraps of two input
signatures) the bootstrap's planes take 21.50 GB against the 21.89 GB the
card's memory plan leaves them, so the segment path pins both, but the
plane bound counts each signature's group whole (13.33 GB each) and the
per-op path encodes 3,944 planes again a request (PERF.md).

Writes Deep.cst, Deep.hevm and expected.json: the depth, input, counts and
digests; the bootstrap signatures by the port executor's walk; the
bootstrapper's config (bootstrap_native.native_config), the rows it leaves
and the level it reaches; the dry plan's keys and planes (the native
bootstrap over shape-only tensors, scripts/native_resnet_plan.py).
tests/test_torch_native_n16.py regenerates the files and compares them byte
for byte, also through the port's own compiler.
"""

import dataclasses
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "deep_dacapo40_tpu_n16")
COMPILER_PROFILE = os.path.join(ART, "profiled_TPU_n16_native.json")
PROFILE = "tpu_n16"
DEPTH = 6
WATERLINE = 40
X_SEED = 0
X_RANGE = (0.5, 0.55)


def sha256_file(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def dry_plan(prog, constants):
    """The program's bootstrap signatures by the port executor's walk, the
    bootstrapper's config and reach, and what a load's warm-up makes: the
    galois keys and the planes (diagonals, constants) of each signature,
    counted over shape-only tensors (no key, nothing encoded)."""
    from native_resnet_plan import boot_signatures, dry_bootstraps
    from dacapo_tpu_torch.crypto.bootstrap_native import native_config, rows_left
    from dacapo_tpu_torch.crypto.params import PROFILES, CKKSContext
    cfg = PROFILES[PROFILE]
    boot = native_config(cfg)
    sigs = boot_signatures(prog, PROFILE, constants)
    after, boot_steps, conj = dry_bootstraps(PROFILE, sigs, boot)
    half = cfg.n // 2
    prog_steps = {o % half for o in prog.rotation_offsets() if o % half}
    key_each = cfg.dnum * 2 * cfg.num_all * cfg.n * 4
    keys = len(prog_steps | set(boot_steps)) + conj
    rows = rows_left(CKKSContext(cfg, device="cpu"), boot)
    return dict(
        boot_signatures=[list(s) for s in sigs],
        bootstrap_config=dataclasses.asdict(boot),
        bootstrap_rows_left=rows, bootstrap_reach_level=rows // cfg.rescale_rows - 1,
        plan=dict(program_rotation_keys=len(prog_steps),
                  bootstrap_rotation_keys=len(boot_steps), conjugation_key=conj,
                  galois_keys=keys, key_bytes_each=key_each, key_bytes=keys * key_each,
                  planes_after_signature=after))


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from make_native_artifact import compile_deep
    from dacapo_tpu.vm.hevm import OP_BOOTSTRAP, OP_ENCODE
    from dacapo_tpu_torch.ir.serialize import read_cst
    from dacapo_tpu_torch.vm.hevm import HEVMProgram
    prog, _ = compile_deep(ART, profile=PROFILE, depth=DEPTH, compiler_profile=COMPILER_PROFILE)
    boots = [op for op in prog.ops if op.opcode == OP_BOOTSTRAP]
    with open(COMPILER_PROFILE) as f:
        bounds = json.load(f)
    expected = {
        "program": "the deep circuit of tests/test_dacapo.py over 2^15 slots, depth "
                   f"{DEPTH}, dacapo, waterline {WATERLINE}, compiler profile "
                   "profiled_TPU_n16_native.json (profiled_TPU_n16 with both level upper "
                   "bounds at 11); scripts/make_native_artifact.py:compile_deep",
        "profile": PROFILE,
        "compiler_profile": os.path.relpath(COMPILER_PROFILE, REPO),
        "level_upper_bound": bounds["levelUpperBound"],
        "bootstrap_level_upper_bound": bounds["bootstrapLevelUpperBound"],
        "depth": DEPTH,
        "waterline": WATERLINE,
        "input": f"numpy.random.default_rng({X_SEED}).uniform({X_RANGE[0]}, "
                 f"{X_RANGE[1]}, 32768)",
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
    expected.update(dry_plan(HEVMProgram.load(os.path.join(ART, "Deep.hevm")),
                             read_cst(os.path.join(ART, "Deep.cst"))))
    with open(os.path.join(ART, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")
    print(json.dumps(expected))


if __name__ == "__main__":
    main()
