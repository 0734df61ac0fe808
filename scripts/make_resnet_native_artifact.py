#!/usr/bin/env python3
"""Regenerate dacapo_tpu_torch/artifacts/resnet_dacapo40_tpu_n15b with the
JAX package (on the CPU): ResNet-20 served with native bootstraps.

    JAX_PLATFORMS=cpu python3 scripts/make_resnet_native_artifact.py [work_dir]

Traces ResNet-20 with the trained checkpoint (examples/benchmarks/ResNet.py:
trace, nt=2^14) into <work_dir>/traced, compiles it with
examples/common.py:compile_traced("ResNet", "dacapo", 40, "tpu_n15b") (about
13 minutes on an 8-core host; both are reused when work_dir has them), copies
the .hevm into the artifact directory and writes expected.json: the digests
of the JAX package's .cst, .eir.json (without source locations) and .hevm,
the program's counts, the distinct bootstrap signatures (input rows, scale,
target level) by the port executor's metadata walk
(scripts/native_resnet_plan.py:boot_signatures), the port runner's native
bootstrap configuration for tpu_n15b (radix 7; K 24 and degree 40, sized for
the h = 192 secret: crypto/bootstrap_native.sized_for_secret), and the golden logits of the
torch model on the reference test's input. The trace is the one
scripts/make_resnet_artifact.py makes for tpu_n15 (the .cst digests must
agree; this script does not rewrite the SiLU fit). work_dir defaults to
traced/resnet_jax_n15b (gitignored).
"""

import dataclasses
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15b")
N15 = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15")
NT = 2 ** 14
PROFILE = "tpu_n15b"


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def main(work_dir):
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    from dacapo_tpu.vm.hevm import HEVMProgram, OP_BOOTSTRAP, OP_ENCODE
    from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig, sized_for_secret
    from dacapo_tpu_torch.crypto.params import PROFILES
    from dacapo_tpu_torch.ir.serialize import function_digest
    from dacapo_tpu_torch.vm.hevm import HEVMProgram as PortProgram
    from examples.benchmarks.ResNet import trace, get_model
    from examples.common import compile_traced

    traced = os.path.join(work_dir, "traced")
    cst = os.path.join(traced, "_hecate_ResNet.cst")
    hevm = os.path.join(work_dir, "optimized", "dacapo", "ResNet.40._hecate_ResNet.hevm")
    model = get_model()
    if os.path.exists(cst) and os.path.exists(hevm):
        print(f"reusing the trace and program in {work_dir}", flush=True)
    else:
        t0 = time.perf_counter()
        if not os.path.exists(cst):
            trace(dirs=traced, nt=NT, model=model)
            print(f"trace: {time.perf_counter() - t0:.1f} s", flush=True)
        hevm = compile_traced("ResNet", "dacapo", 40, PROFILE, traced,
                              os.path.join(work_dir, "optimized"))
        print(f"trace and compile: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(N15, "expected.json")) as f:
        n15 = json.load(f)
    cst_sha = sha256_file(cst)
    if cst_sha != n15["cst_sha256"]:
        raise SystemExit(f"the trace differs from the tpu_n15 artifact's: {cst_sha}")
    os.makedirs(ART, exist_ok=True)
    out = os.path.join(ART, "ResNet.hevm")
    with open(hevm, "rb") as f, open(out, "wb") as g:
        g.write(f.read())

    prog = HEVMProgram._load_py(hevm)
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    with torch.no_grad():
        logits = model(x).numpy().ravel()
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from native_resnet_plan import boot_signatures
    from dacapo_tpu_torch.ir.serialize import read_cst
    sigs = boot_signatures(PortProgram.load(out), PROFILE, read_cst(cst))
    # the port runner's bootstrapper for this profile: radix 7 from 2^14
    # slots, K and degree sized for the secret's Hamming weight
    boot = sized_for_secret(BootstrapConfig(radix=7), PROFILES[PROFILE].secret_h,
                            PROFILES[PROFILE].n)
    expected = {
        "program": "ResNet-20 (examples/data/resnet20.silu.model), dacapo, "
                   "waterline 40, tpu_n15b (native bootstraps); traced by "
                   "examples/benchmarks/ResNet.py:trace and compiled by "
                   "examples/common.py:compile_traced",
        "nt": NT,
        "cst_bytes": os.path.getsize(cst),
        "cst_sha256": cst_sha,
        "eir_json_sha256_without_loc": function_digest(
            os.path.join(traced, "ResNet.eir.json")),
        "hevm_sha256": sha256_file(hevm),
        "instructions": len(prog.ops),
        "encodes": sum(op.opcode == OP_ENCODE for op in prog.ops),
        "bootstraps": sum(op.opcode == OP_BOOTSTRAP for op in prog.ops),
        "rotation_offsets": len({o for o in prog.rotation_offsets() if o != 0}),
        "boot_signatures": [[nl, sc, target] for nl, sc, target in sigs],
        "radix": boot.radix,
        "bootstrap_config": dataclasses.asdict(boot),
        "golden_input": "torch.randn(1, 3, 32, 32, dtype=torch.double, "
                        "generator=torch.Generator().manual_seed(100))",
        "golden_logits": [float(v) for v in logits],
        "postprocess": "models/cnn_he.resnet_postprocess(output[0]): "
                       "the first 10 slots times bb=32",
        "rms_bar": 9.5152e-4,
    }
    with open(os.path.join(ART, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in expected.items() if k != "golden_logits"}))


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                         else os.path.join(REPO, "traced", "resnet_jax_n15b")))
