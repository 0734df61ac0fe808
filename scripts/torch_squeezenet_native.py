#!/usr/bin/env python3
"""SqueezeNet `dacapo 40` served encrypted with native bootstraps on
tpu_n15b, on one NVIDIA card: chip_smoke.py's squeezenet_native phase alone.

    python3 scripts/torch_squeezenet_native.py

Builds the NTT kernel (csrc/ntt.cu) and the native artifact core, then runs
chip_smoke.serve_squeezenet_native with every check of the smoke (the
committed .hevm and the port's trace by SHA-256, a full HEVM("tpu_n15b",
save_keys=False) whose ~734 galois keys stream from pinned host slabs, a
timed segment request, one per op and one profiled, each held to the RMS
bar against the simulation's logits, the bootstrap count, no key made, no
plain NTT, outputs byte-equal; the NTT at every batch size launched,
bit-equal to the plain NTT). The whole network does not fit chip_smoke.py's
time limit beside its other phases, so the smoke serves its prefix (conv_1
and fire_2 under a memory plan that streams their keys). Prints the
phase's log and writes its numbers to chiprun_out/squeezenet_native.json.
9 to 11 minutes on an NVIDIA H100 80GB HBM3; the pinned keys take ~58 GB of
host memory (~80 GB resident at the peak).
"""

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_squeezenet_native: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.crypto import ntt as ntt_mod, params
    from dacapo_tpu_torch.crypto.cuda import ntt_kernel as nk
    from dacapo_tpu_torch.vm import native as hevm_core
    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    nk.build()
    hevm_core.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hevm_keys_squeezenet_") as keydir:
        out, launches, check = chip_smoke.serve_squeezenet_native(
            np, torch, HEVM, nk, ntt_mod, params, keydir)
    report = dict(card=card, build_s=build_s, phase_s=time.perf_counter() - t0,
                  squeezenet_native=out, ntt_launches=launches, ntt_check=check)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "squeezenet_native.json"), "w") as f:
        json.dump(report, f, indent=1)
    chip_smoke.log(f"[time] build {build_s:.1f} s, phase {report['phase_s']:.1f} s")
    chip_smoke.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
