#!/usr/bin/env python3
"""ResNet-20 `dacapo 40` on the test images of seeds 100..103, in exact
floats (vm/simulate.py), on the CPU: no ring, no noise, no bootstrap error.

    python3 scripts/resnet_simulate_seeds.py [--seeds 100,101,102,103] [--json]

Each committed program, the oracle one (artifacts/resnet_dacapo40_tpu_n15)
and the native one (artifacts/resnet_dacapo40_tpu_n15b), runs through
vm/simulate.py:simulate with the executor's plaintext steering
(steer="global") on the port's trace of the trained checkpoint
(traced/resnet_torch/_hecate_ResNet.cst, traced when missing: about 5 s and
483 MB). Prints the RMS of the 10 logits against the torch model for each
program and image, beside the reference's bar (9.5152e-4). What a card's
request adds to these is encryption and bootstrap error: the split of a
request's RMS between the compiled program (its planner, its polynomial
activations) and the arithmetic that runs it. About 15 s.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "dacapo_tpu_torch", "artifacts")
PROGRAMS = (("tpu_n15", "resnet_dacapo40_tpu_n15"), ("tpu_n15b", "resnet_dacapo40_tpu_n15b"))
TRACE = os.path.join(REPO, "traced", "resnet_torch")     # gitignored
CKPT = os.path.join(REPO, "examples", "data", "resnet20.silu.model")
RMS_BAR = 9.5152e-4


def simulate_seeds(seeds):
    """{profile: {seed: RMS of the 10 simulated logits against the torch
    model}} for each committed ResNet-20 program."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    from dacapo_tpu_torch.ir.serialize import read_cst
    from dacapo_tpu_torch.models import cnn_he, resnet
    from dacapo_tpu_torch.vm.hevm import HEVMProgram
    from dacapo_tpu_torch.vm.simulate import simulate
    model = resnet.get_model(CKPT)
    cst = os.path.join(TRACE, "_hecate_ResNet.cst")
    if not os.path.exists(cst):
        cnn_he.trace_resnet(TRACE, model, nt=2 ** 14)
    constants = read_cst(cst)
    out = {}
    for profile, art in PROGRAMS:
        with open(os.path.join(ARTIFACTS, art, "expected.json")) as f:
            nt = json.load(f)["nt"]
        prog = HEVMProgram.load(os.path.join(ARTIFACTS, art, "ResNet.hevm"))
        rows = out[profile] = {}
        for seed in seeds:
            x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                            generator=torch.Generator().manual_seed(seed))
            with torch.no_grad():
                want = model(x).numpy().ravel()
            packed = cnn_he.resnet_pack_input(x.numpy(), model, nt=nt)
            res = simulate(prog, constants, [packed], profile, steer="global")
            logits = cnn_he.resnet_postprocess(res.outputs[0][0])
            rows[seed] = float(np.sqrt(np.mean((logits - want) ** 2)))
    return out


def main(argv):
    seeds = ([int(s) for s in argv[argv.index("--seeds") + 1].split(",")]
             if "--seeds" in argv else [100, 101, 102, 103])
    out = simulate_seeds(seeds)
    if "--json" in argv:
        print(json.dumps(out))
        return 0
    for profile, rows in out.items():
        for seed, rms in rows.items():
            print(f"{profile} image seed {seed}: simulated rms {rms:.4e} "
                  f"({'within' if rms <= RMS_BAR else 'past'} the bar {RMS_BAR})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
