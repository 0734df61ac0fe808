#!/usr/bin/env python3
"""Time this checkout's server requests of basic rows against another
checkout's, in turns, on one card.

    python3 scripts/torch_serve_ab.py OTHER [ROW ...] [--requests N]

OTHER is the root of another checkout (for example the parent commit
unpacked with `git archive` into the gitignored `_archive/`). ROWs are names
of the basic list (dacapo_tpu_torch/examples/tests/<Name>.py), by default
SobelFilter, HarrisCornerDetection and LinearRegression. Each side runs in a
process of its own that imports only its checkout's `dacapo_tpu_torch`, in
the order OTHER, this, this, OTHER. A process compiles each row with its
checkout's tracer and planner (pars/40 on the row's profile), loads it on a
full HEVM over a fresh keyset (the load captures the graphs), encrypts the
row's inputs, and times N requests of `executor.run_encrypted` (the work of
chip_smoke.py's server request) with the host clock around work that ends
in a synchronize, after one warm-up request. Prints each process's medians,
then the median of each side's per-process medians per row, then the card's
name and power limit; writes serve_ab.json into chip_smoke.py's output
directory. Needs one card; imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("SobelFilter", "HarrisCornerDetection", "LinearRegression")


def serve(root, rows, n):
    """One side: {row: [seconds of each timed request]} for the checkout at root."""
    sys.path.insert(0, root)
    import importlib
    import torch
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.runtime.harness import compile_traced
    out = {}
    with tempfile.TemporaryDirectory(prefix="serve_ab_") as work:
        for name in rows:
            bench = importlib.import_module(f"dacapo_tpu_torch.examples.benchmarks.{name}")
            test = importlib.import_module(f"dacapo_tpu_torch.examples.tests.{name}")
            traced = os.path.join(work, "traced")
            bench.trace(dirs=traced, nt=4096)
            hevm = compile_traced(name, "pars", 40, test.PROFILE, traced,
                                  os.path.join(work, "optimized"))
            vm = HEVM(test.PROFILE, keyset_dir=os.path.join(work, f"keys_{name}"))
            vm.load(os.path.join(traced, f"_hecate_{name}.cst"), hevm)
            inputs, _, _ = test.case(nt=4096)
            for i, x in enumerate(inputs):
                vm.setInput(i, x)
            args = [vm._arg_cts[i] for i in range(len(inputs))]
            vm.executor.run_encrypted(args)
            times = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vm.executor.run_encrypted(args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name] = times
            del vm
            torch.cuda.empty_cache()
    return out


def main(argv):
    if argv[:1] == ["--serve"]:
        root, rows, n = argv[1], argv[2].split(","), int(argv[3])
        print(json.dumps(serve(root, rows, n)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    n = 30
    if "--requests" in argv:
        i = argv.index("--requests")
        n = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other, rows = os.path.abspath(argv[0]), argv[1:] or list(ROWS)
    runs = []
    for side, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve", root,
                               ",".join(rows), str(n)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(side=side, root=root, times=times))
        print(f"[serve_ab] {side} ({root}): " + ", ".join(
            f"{r} median {statistics.median(t) * 1e3:.3f} ms" for r, t in times.items()),
            flush=True)
    summary = {r: {side: statistics.median(statistics.median(run["times"][r])
                                           for run in runs if run["side"] == side)
                   for side in ("other", "this")} for r in rows}
    for r, s in summary.items():
        print(f"[serve_ab] {r}: this {s['this'] * 1e3:.3f} ms, other {s['other'] * 1e3:.3f} ms "
              f"(this / other {s['this'] / s['other']:.4f})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "serve_ab.json"), "w") as f:
        json.dump(dict(card=card, requests=n, runs=runs, summary=summary), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
