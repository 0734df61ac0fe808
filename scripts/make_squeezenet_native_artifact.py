#!/usr/bin/env python3
"""Regenerate dacapo_tpu_torch/artifacts/squeezenet_dacapo40_tpu_n15b on the
CPU: SqueezeNet `dacapo 40` served with native bootstraps on tpu_n15b.

    JAX_PLATFORMS=cpu python3 scripts/make_squeezenet_native_artifact.py [work_dir]

About 105 minutes on one core of an 8-core host, almost all of it the two
compiles, one after the other (2,950 s and 3,185 s in the run that wrote the
committed files), then about two minutes for the prefix and the dry plans:

* traces SqueezeNet (the deterministic-random weights of
  examples/benchmarks/SqueezeNet.py:get_model, nt = 2^14) with the JAX
  package into <work_dir>/jax/traced and compiles it with
  examples/common.py:compile_traced("SqueezeNet", "dacapo", 40, "tpu_n15b");
* traces it with the port (dacapo_tpu_torch/examples/benchmarks/
  SqueezeNet.py) into <work_dir>/port/traced and compiles it with the port's
  planner (runtime/harness.py:compile_traced); the two .cst files, the two
  .eir.json files without source locations and the two .hevm files must be
  equal;
* copies the .hevm into the artifact directory (the .cst, 607 MB, is not
  committed: the port's tracer writes it at use, checked by its SHA-256) and
  writes expected.json: the digests; the counts (instructions, encodes,
  bootstraps, rotation offsets); the bootstrap signatures by the port
  executor's walk (scripts/native_resnet_plan.py:boot_signatures); the port
  runner's bootstrap configuration (bootstrap_native.native_config: radix 7,
  K and degree sized for the h = 192 secret); the golden logits of the torch
  model on the example's input; the seconds of both compiles; the
  exact-float simulation of the .hevm (vm/simulate.py:simulate, steer
  "global": the executor's scale steering) with its logits and RMS against
  the torch model beside the unsteered one's; the RMS bar, which holds the
  decrypted logits to the simulation's; and the dry plan of the program on an
  NVIDIA H100 80GB HBM3 (scripts/native_resnet_plan.py:plan: keys of the
  program and of the bootstrap against the 55 % budget, plaintexts resident
  or compact, planes per signature, each path's plane bound with its
  re-encodes a request and its predicted device bytes).

Then the prefix chip_smoke.py serves (SqueezeNetPrefix.hevm and
expected.json's "prefix"): conv_1, avgpool_1 and the first PREFIX_FIRES
Fire modules at full width, traced by the port
(models/cnn_he.squeezenet_prefix_he_forward) and by the JAX package
(jax_prefix_body, its twin over the JAX package's modules) and compiled by
both planners, byte-equal; its exact-float simulation (a digest of every
output slot, its RMS against the torch model's activations packed by the
output shapes' OutPack) and its dry plan under the memory plan that puts
its keys past the key budget (hbm_bytes: its key bytes), as the whole
network's are on the card.

A work_dir that holds a trace and a program of either package is reused
(with the compile seconds it recorded in compile_seconds.json). work_dir
defaults to traced/squeezenet_n15b (gitignored).
"""

import dataclasses
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "squeezenet_dacapo40_tpu_n15b")
NT = 2 ** 14
PROFILE = "tpu_n15b"
NAME = "SqueezeNet"
# ResNet-20's published RMS, spent here on what encryption adds to the
# compiled program's own error: the decrypted logits against the simulation's
RMS_BAR = 9.5152e-4
PREFIX = "SqueezeNetPrefix"
PREFIX_FIRES = 1               # fire_2


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def golden(model):
    """The example's input (dacapo_tpu_torch/examples/tests/SqueezeNet.py)
    and the torch model's 10 logits on it."""
    import torch
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    with torch.no_grad():
        return x.numpy(), model(x).numpy().ravel()


def jax_prefix_body(model, fires, nt):
    """models/cnn_he.squeezenet_prefix_he_forward over the JAX package's
    tracer and MPCB functions, line for line: the JAX side of the prefix's
    trace."""
    from dacapo_tpu.ir import trace as hc
    from dacapo_tpu.models.cnn_he import _wrap
    from dacapo_tpu.poly.hefunc import HE_Avg, HE_Concat, HE_Conv, HE_ConvBN, HE_SiLU
    from dacapo_tpu.poly.mpcb import CascadeConcat, CascadeConv, CascadeMax, makeClose

    def body(ctxt):
        bs, act, bb = hc.bootstrap, HE_SiLU, 32
        out = _wrap(ctxt)
        block_in = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}
        cs = CascadeConv(block_in, model.conv_1.Conv2d)
        out = HE_ConvBN(makeClose(cs), out, model.conv_1.Conv2d, model.conv_1.bn)
        out = act(bs(out))
        block_in = cs
        ps = CascadeMax(block_in, model.avgpool_1)
        out = HE_Avg(makeClose(ps), out)
        block_in = ps
        for f in (model.fire_2, model.fire_3, model.fire_4)[:fires]:
            sq = CascadeConv(block_in, f.squeeze.Conv2d)
            out = HE_ConvBN(makeClose(sq), bs(out), f.squeeze.Conv2d, f.squeeze.bn)
            out = act(bs(out))
            e1 = CascadeConv(sq, f.expand1x1)
            out1 = HE_Conv(makeClose(e1), out, f.expand1x1)
            e3 = CascadeConv(sq, f.expand3x3)
            out2 = HE_Conv(makeClose(e3), out, f.expand3x3)
            block_in = CascadeConcat(e1, e3)
            out = HE_Concat(makeClose(block_in), out1, out2)
        return list(out)

    return body


def build_prefix(work, package, seconds, fires=PREFIX_FIRES):
    """The prefix traced and compiled with `package` into
    work/prefix<fires>_<package> (reused as build does). Returns (.cst,
    .eir.json, .hevm) paths."""
    key = f"prefix{fires}_{package}"
    d = os.path.join(work, key)
    traced, out = os.path.join(d, "traced"), os.path.join(d, "optimized")
    files = (os.path.join(traced, f"_hecate_{PREFIX}.cst"),
             os.path.join(traced, f"{PREFIX}.eir.json"),
             os.path.join(out, "dacapo", f"{PREFIX}.40._hecate_{PREFIX}.hevm"))
    if all(map(os.path.exists, files)) and key in seconds:
        print(f"reusing the {package} prefix in {d}", flush=True)
        return files
    if package == "jax":
        from examples.benchmarks.SqueezeNet import get_model
        from examples.common import compile_traced, trace_and_save
        trace_and_save(PREFIX, "c", jax_prefix_body(get_model(), fires, NT), traced)
    else:
        from dacapo_tpu_torch.examples.benchmarks.SqueezeNet import get_model
        from dacapo_tpu_torch.models import cnn_he
        from dacapo_tpu_torch.runtime.harness import compile_traced, trace_and_save
        model = get_model()
        trace_and_save(PREFIX, "c", lambda x: cnn_he.squeezenet_prefix_he_forward(
            x, model, fires=fires, nt=NT), traced)
    t0 = time.perf_counter()
    compile_traced(PREFIX, "dacapo", 40, PROFILE, traced, out)
    seconds[key] = time.perf_counter() - t0
    with open(os.path.join(work, "compile_seconds.json"), "w") as f:
        json.dump(seconds, f)
    return files


def prefix_entry(work, seconds):
    """expected.json's "prefix" (module docstring)."""
    import numpy as np
    import torch
    from dacapo_tpu_torch.crypto.bootstrap_native import native_config
    from dacapo_tpu_torch.crypto.params import PROFILES
    from dacapo_tpu_torch.examples.benchmarks.SqueezeNet import get_model
    from dacapo_tpu_torch.ir.serialize import function_digest, read_cst
    from dacapo_tpu_torch.models import cnn_he
    from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP, OP_ENCODE
    from dacapo_tpu_torch.vm.simulate import simulate
    from native_resnet_plan import boot_signatures, plan
    jcst, jeir, jhevm = build_prefix(work, "jax", seconds)
    cst, eir, hevm = build_prefix(work, "port", seconds)
    digests = dict(cst_sha256=(sha256_file(jcst), sha256_file(cst)),
                   eir_json_sha256_without_loc=(function_digest(jeir), function_digest(eir)),
                   hevm_sha256=(sha256_file(jhevm), sha256_file(hevm)))
    for k, (a, b) in digests.items():
        if a != b:
            raise SystemExit(f"prefix {k}: the JAX package's {a}, the port's {b}")
    out = os.path.join(ART, f"{PREFIX}.hevm")
    with open(hevm, "rb") as f, open(out, "wb") as g:
        g.write(f.read())
    prog = HEVMProgram.load(out)
    constants = read_cst(cst)
    model = get_model()
    x, _ = golden(model)
    packed = cnn_he.cnn_pack_input(x, model.conv_1.Conv2d, nt=NT)
    with torch.no_grad():
        act = cnn_he.squeezenet_prefix_torch(torch.from_numpy(x), model,
                                             fires=PREFIX_FIRES).numpy()
    want = np.concatenate(list(cnn_he.makeClose(cnn_he.squeezenet_prefix_shapes(
        model, fires=PREFIX_FIRES, nt=NT))["OP"](act)))
    res = simulate(prog, constants, [packed], PROFILE, steer="global")
    outs = [np.ascontiguousarray(v) for v, _ in res.outputs]
    # the memory plan: the prefix's key bytes, so they pass the 55 % budget
    hbm = plan(prog, constants, PROFILE, 1 << 62)["key_bytes"]
    return {
        "program": f"conv_1, avgpool_1 and the first {PREFIX_FIRES} Fire module(s) of "
                   "SqueezeNet at full width (models/cnn_he.squeezenet_prefix_he_forward), "
                   "dacapo, waterline 40, tpu_n15b; every ciphertext of the last Fire "
                   "module's concatenation",
        "fires": PREFIX_FIRES,
        "cst_bytes": os.path.getsize(cst),
        **{k: a for k, (a, _) in digests.items()},
        "instructions": len(prog.ops),
        "encodes": sum(op.opcode == OP_ENCODE for op in prog.ops),
        "bootstraps": sum(op.opcode == OP_BOOTSTRAP for op in prog.ops),
        "results": len(prog.res_dst),
        "rotation_offsets": len({o for o in prog.rotation_offsets() if o != 0}),
        "boot_signatures": [[nl, sc, t] for nl, sc, t in
                            boot_signatures(prog, PROFILE, constants)],
        "bootstrap_config": dataclasses.asdict(native_config(PROFILES[PROFILE])),
        "compile_seconds": {"jax": seconds[f"prefix{PREFIX_FIRES}_jax"],
                            "port": seconds[f"prefix{PREFIX_FIRES}_port"]},
        "golden": "the torch model's activations after the last Fire module "
                  "(models/cnn_he.squeezenet_prefix_torch) on the golden input, packed by "
                  "the output shapes' OutPack (mpcb 'OP'): values over bb = 32",
        "simulated_outputs_sha256": hashlib.sha256(
            b"".join(v.tobytes() for v in outs)).hexdigest(),
        "simulated_rms_vs_torch": float(np.sqrt(np.mean((np.concatenate(outs) - want) ** 2))),
        "rms_bar": RMS_BAR,
        "rms_bar_against": "the simulation's outputs and the torch model's activations",
        "hbm_bytes": hbm,
        "plan": plan(prog, constants, PROFILE, hbm),
    }


def build(work, package, seconds):
    """Trace and compile with `package` ("jax" or "port") into work/<package>,
    unless a trace and a program are there; the compile's seconds go into
    `seconds`. Returns (.cst, .eir.json, .hevm) paths."""
    d = os.path.join(work, package)
    traced, out = os.path.join(d, "traced"), os.path.join(d, "optimized")
    files = (os.path.join(traced, f"_hecate_{NAME}.cst"),
             os.path.join(traced, f"{NAME}.eir.json"),
             os.path.join(out, "dacapo", f"{NAME}.40._hecate_{NAME}.hevm"))
    if all(map(os.path.exists, files)) and package in seconds:
        print(f"reusing the {package} trace and program in {d}", flush=True)
        return files
    if package == "jax":
        from examples.benchmarks.SqueezeNet import trace, get_model
        from examples.common import compile_traced
    else:
        from dacapo_tpu_torch.examples.benchmarks.SqueezeNet import trace, get_model
        from dacapo_tpu_torch.runtime.harness import compile_traced
    t0 = time.perf_counter()
    trace(dirs=traced, nt=NT, model=get_model())
    print(f"{package} trace: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    compile_traced(NAME, "dacapo", 40, PROFILE, traced, out)
    seconds[package] = time.perf_counter() - t0
    with open(os.path.join(work, "compile_seconds.json"), "w") as f:
        json.dump(seconds, f)
    return files


def main(work):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram, OP_BOOTSTRAP, OP_ENCODE
    from dacapo_tpu_torch.crypto.bootstrap_native import native_config
    from dacapo_tpu_torch.crypto.params import PROFILES
    from dacapo_tpu_torch.examples.benchmarks.SqueezeNet import get_model
    from dacapo_tpu_torch.ir.serialize import function_digest, read_cst
    from dacapo_tpu_torch.models.cnn_he import cnn_pack_input, resnet_postprocess
    from dacapo_tpu_torch.vm.hevm import HEVMProgram
    from dacapo_tpu_torch.vm.simulate import simulate
    from native_resnet_plan import H100_BYTES, boot_signatures, plan

    os.makedirs(work, exist_ok=True)
    try:
        with open(os.path.join(work, "compile_seconds.json")) as f:
            seconds = json.load(f)
    except OSError:
        seconds = {}
    cst, eir, hevm = build(work, "jax", seconds)
    pcst, peir, phevm = build(work, "port", seconds)
    digests = dict(cst_sha256=(sha256_file(cst), sha256_file(pcst)),
                   eir_json_sha256_without_loc=(function_digest(eir), function_digest(peir)),
                   hevm_sha256=(sha256_file(hevm), sha256_file(phevm)))
    for k, (a, b) in digests.items():
        if a != b:
            raise SystemExit(f"{k}: the JAX package's {a}, the port's {b}")
    os.makedirs(ART, exist_ok=True)
    out = os.path.join(ART, f"{NAME}.hevm")
    with open(hevm, "rb") as f, open(out, "wb") as g:
        g.write(f.read())

    ref = RefProgram._load_py(hevm)
    prog = HEVMProgram.load(out)
    constants = read_cst(pcst)
    model = get_model()
    x, logits = golden(model)
    packed = cnn_pack_input(x, model.conv_1.Conv2d, nt=NT)
    sim, t0 = {}, time.perf_counter()
    for steer in (False, "global"):
        res = simulate(prog, constants, [packed], PROFILE, steer=steer)
        sim[steer] = resnet_postprocess(res.outputs[0][0])
    sim_s = (time.perf_counter() - t0) / 2
    rms = {k: float(np.sqrt(np.mean((v - logits) ** 2))) for k, v in sim.items()}
    cfg = PROFILES[PROFILE]
    t0 = time.perf_counter()
    dry = plan(prog, constants, PROFILE, H100_BYTES)
    plan_s = time.perf_counter() - t0
    expected = {
        "program": "SqueezeNet (deterministic-random weights with calibrated BN, "
                   "examples/benchmarks/SqueezeNet.py:get_model), dacapo, waterline 40, "
                   "tpu_n15b (native bootstraps); traced by examples/benchmarks/"
                   "SqueezeNet.py:trace and compiled by examples/common.py:compile_traced, "
                   "byte-equal to the port's trace and planner",
        "nt": NT,
        "cst_bytes": os.path.getsize(cst),
        **{k: a for k, (a, _) in digests.items()},
        "instructions": len(ref.ops),
        "encodes": sum(op.opcode == OP_ENCODE for op in ref.ops),
        "bootstraps": sum(op.opcode == OP_BOOTSTRAP for op in ref.ops),
        "bootstrap_target_levels": sorted({op.rhs for op in ref.ops
                                           if op.opcode == OP_BOOTSTRAP}),
        "rotation_offsets": len({o for o in ref.rotation_offsets() if o != 0}),
        "boot_signatures": [[nl, sc, t] for nl, sc, t in
                            boot_signatures(prog, PROFILE, constants)],
        "bootstrap_config": dataclasses.asdict(native_config(cfg)),
        "compile_seconds": {"jax": seconds["jax"], "port": seconds["port"],
                            "host": "one core of an 8-core x86-64 host (CPU)"},
        "golden_input": "torch.randn(1, 3, 32, 32, dtype=torch.double, "
                        "generator=torch.Generator().manual_seed(100))",
        "golden_logits": [float(v) for v in logits],
        "postprocess": "models/cnn_he.resnet_postprocess(output[0]): "
                       "the first 10 slots times bb=32",
        "simulation": "vm/simulate.py:simulate(prog, constants, [packed input], "
                      "'tpu_n15b', steer='global'): exact floats, the executor's "
                      "scale steering, no noise",
        "simulated_logits": [float(v) for v in sim["global"]],
        "simulated_rms_vs_torch": rms["global"],
        "simulated_rms_vs_torch_unsteered": rms[False],
        "simulation_seconds": sim_s,
        "rms_bar": RMS_BAR,
        "rms_bar_against": "simulated_logits",
        "plan_seconds": plan_s,
        "plan": dry,
        "prefix": prefix_entry(work, seconds),
    }
    with open(os.path.join(ART, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in expected.items()
                      if k not in ("golden_logits", "simulated_logits", "plan")}))


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                         else os.path.join(REPO, "traced", "squeezenet_n15b")))
