#!/usr/bin/env python3
"""The spread of ResNet-20 `dacapo 40`'s RMS over the oracle's randomness,
on one card, for both oracle paths.

    python3 scripts/resnet_rms_spread.py [REQUESTS]

Serves the committed ResNet program (tpu_n15, trained checkpoint, the input
of chip_smoke.py) on a fresh keyset and runs REQUESTS (default 12) requests
on each oracle path in turns: the device path (the default: torch generator
on the card, one CUDA graph per cache key) and the host-RNG path
(`host_rng=True`: the key generator's numpy RNG, the JAX package's
DACAPO_TPU_ORACLE_JIT=0 path). The input is the same in every request; the
input's encryption and the bootstraps' fresh encryptions differ. Prints each
request's RMS of the 10 logits against the torch model, each path's
quartiles and the share above 9.5152e-4 (the reference's published RMS),
then the card's name and power limit, and writes resnet_rms_spread.json into
chiprun_out/. Imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15")
CKPT = os.path.join(REPO, "examples", "data", "resnet20.silu.model")
OUT_DIR = os.path.join(REPO, "chiprun_out")
RMS_BAR = 9.5152e-4


def main(n):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("resnet_rms_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.models import cnn_he, resnet
    with open(os.path.join(ART, "expected.json")) as f:
        expected = json.load(f)
    model = resnet.get_model(CKPT)
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    with torch.no_grad():
        want = model(x).numpy().ravel()
    packed = cnn_he.resnet_pack_input(x.numpy(), model, nt=expected["nt"])
    rms = {"device": [], "host": []}
    with tempfile.TemporaryDirectory() as tmp:
        cnn_he.trace_resnet(tmp, model, nt=expected["nt"])
        vm = HEVM("tpu_n15", keyset_dir=os.path.join(tmp, "keys"))
        vm.load(os.path.join(tmp, "_hecate_ResNet.cst"), os.path.join(ART, "ResNet.hevm"))
        bs = vm.executor.bootstrapper
        for i in range(n):
            for path in ("device", "host") if i % 2 == 0 else ("host", "device"):
                bs.host_rng = path == "host"
                t0 = time.perf_counter()
                vm.setInput(0, packed)
                vm.run()
                logits = cnn_he.resnet_postprocess(vm.getOutput()[0])
                torch.cuda.synchronize()
                r = float(np.sqrt(np.mean((logits - want) ** 2)))
                rms[path].append(r)
                print(f"[spread] request {i} {path}: rms {r:.4e} "
                      f"({time.perf_counter() - t0:.3f} s)", flush=True)
    summary = {}
    for path, v in rms.items():
        q = statistics.quantiles(v, n=4)
        summary[path] = dict(rms=v, median=statistics.median(v), q1=q[0], q3=q[2],
                             min=min(v), max=max(v),
                             above_bar=sum(r > RMS_BAR for r in v))
        print(f"[spread] {path}: median {summary[path]['median']:.4e}, quartiles "
              f"{q[0]:.4e}..{q[2]:.4e}, range {min(v):.4e}..{max(v):.4e}, above "
              f"{RMS_BAR}: {summary[path]['above_bar']} of {len(v)}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "resnet_rms_spread.json"), "w") as f:
        json.dump(dict(card=card, requests_per_path=n, bar=RMS_BAR, **summary), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 12))
