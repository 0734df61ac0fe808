#!/usr/bin/env python3
"""Regenerate dacapo_tpu_torch/artifacts/resnet_dacapo40_tpu_n15 with the
JAX package (on the CPU):

    JAX_PLATFORMS=cpu python3 scripts/make_resnet_artifact.py [work_dir]

Traces ResNet-20 with the trained checkpoint (examples/benchmarks/ResNet.py:
trace, nt=2^14) into <work_dir>/traced, compiles it with
examples/common.py:compile_traced("ResNet", "dacapo", 40, "tpu_n15") (about
14 minutes on one core; both are reused when work_dir has them), copies the
.hevm into the artifact directory, writes the SiLU coefficients of this
machine's fit for the port's tracer (dacapo_tpu_torch/poly/_silu_cache.npz:
the fit's lstsq rounds differently on other LAPACK builds), and writes
expected.json: the digests of the JAX package's .cst, .eir.json
(without source locations) and .hevm, the program's counts, and the golden
logits of the torch model on the reference test's input
(examples/tests/ResNet.py:run). The 483 MB .cst stays in work_dir: the port
traces it itself. work_dir defaults to traced/resnet_jax (gitignored).
"""

import hashlib
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15")
NT = 2 ** 14


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
    import numpy as np
    import torch
    from dacapo_tpu.vm.hevm import HEVMProgram, OP_BOOTSTRAP, OP_ENCODE
    from dacapo_tpu_torch.ir.serialize import function_digest
    from dacapo_tpu_torch.poly import activations
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
        trace(dirs=traced, nt=NT, model=model)
        print(f"trace: {time.perf_counter() - t0:.1f} s", flush=True)
        hevm = compile_traced("ResNet", "dacapo", 40, "tpu_n15", traced,
                              os.path.join(work_dir, "optimized"))
    os.makedirs(ART, exist_ok=True)
    shutil.copyfile(hevm, os.path.join(ART, "ResNet.hevm"))
    # the port's tracer reads the SiLU coefficients of this machine's fit,
    # the one the JAX package's trace above used
    np.savez(activations._SILU_CACHE, **{activations.silu_cache_key(32.0, 127):
                                         activations.silu_fit(32.0, 127)})

    prog = HEVMProgram._load_py(hevm)
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    with torch.no_grad():
        logits = model(x).numpy().ravel()
    expected = {
        "program": "ResNet-20 (examples/data/resnet20.silu.model), dacapo, "
                   "waterline 40, tpu_n15; traced by examples/benchmarks/ResNet.py:"
                   "trace and compiled by examples/common.py:compile_traced",
        "nt": NT,
        "cst_bytes": os.path.getsize(cst),
        "cst_sha256": sha256_file(cst),
        "eir_json_sha256_without_loc": function_digest(
            os.path.join(traced, "ResNet.eir.json")),
        "hevm_sha256": sha256_file(hevm),
        "instructions": len(prog.ops),
        "encodes": sum(op.opcode == OP_ENCODE for op in prog.ops),
        "bootstraps": sum(op.opcode == OP_BOOTSTRAP for op in prog.ops),
        "rotation_offsets": len({o for o in prog.rotation_offsets() if o != 0}),
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
                         else os.path.join(REPO, "traced", "resnet_jax")))
