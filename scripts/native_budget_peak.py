#!/usr/bin/env python3
"""Peak device memory of the deep DaCapo program on tpu_n15b under the
16 GiB device-memory plan, checkout against checkout, on one card.

    python3 scripts/native_budget_peak.py [CHECKOUT ...]

Each CHECKOUT (the root of a checkout; by default this one) runs in a
process of its own, in the order given, with its own chip_smoke.py: the NTT
kernel and the native core built, the programs compiled (compile_programs),
the deep program served resident (serve_native), then loaded again under
the plan and served (serve_native_budget), as chip_smoke.py's native phase
does. Each prints one JSON line: the peak allocated bytes of the plan's
load and of each of its requests (torch.cuda.max_memory_allocated, reset
before each), the bytes allocated after the load and the request seconds.
All of them go to native_budget_peak.json in chip_smoke.py's output
directory, with the card's name and power limit. Imports no JAX.
"""

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root):
    """One checkout's 16 GiB phase; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, root)
    import chip_smoke as cs
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.crypto import ntt as ntt_mod, params
    from dacapo_tpu_torch.crypto.cuda import ntt_kernel as nk
    from dacapo_tpu_torch.vm import native as hevm_core

    nk.build()
    hevm_core.build()
    with tempfile.TemporaryDirectory(prefix="peak_") as work:
        files = cs.compile_programs(os.path.join(work, "compiled"))[0]
        keydir = os.path.join(work, "keys")
        os.makedirs(keydir)
        kept = cs.serve_native(np, torch, HEVM, nk, ntt_mod, params, keydir, files)[-1]
        out, _ = cs.serve_native_budget(np, torch, nk, ntt_mod, files, kept)
    print(json.dumps(dict(
        checkout=root, peak_load_bytes=out["peak_load_bytes"],
        after_load_bytes=out["after_load_bytes"],
        request_peak_bytes=[r["peak_bytes"] for r in out["requests"]],
        request_s=[r["request_s"] for r in out["requests"]])), flush=True)


def main(roots):
    import torch
    if not torch.cuda.is_available():
        print("native_budget_peak: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in roots] or [REPO]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    results = []
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             cwd=root, capture_output=True, text=True)
        sys.stderr.write(run.stdout + run.stderr[-4000:])     # the phases' log lines
        if run.returncode != 0:
            print(f"native_budget_peak: {root} exited {run.returncode}", file=sys.stderr)
            return 1
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    print(card)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "native_budget_peak.json"), "w") as f:
        json.dump(dict(card=card, results=results), f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
