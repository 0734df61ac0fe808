"""The native bootstrap on the secure N = 2^16 profile (tpu_n16) on the card:
scripts/torch_bootstrap_n16.py's run (Scheme("tpu_n16"), its ~400 galois
keys on the device, the radix-8 bootstrapper HEVM builds, uniform(-1, 1) at
nl = 2 and scale 2^28 bootstrapped to level 11) with one eager bootstrap
and one replay: the replayed CUDA graph's output is byte-equal to the eager
bootstraps', which decrypt within RMS 1e-5 of the decrypted input at level
11 (the input itself, encrypted at 2^28, is ~4.5e-4 RMS off its values).
The run takes ~50 GB of the card, so it runs in a process of its own, and
the card test command of README.md runs this file first: the other card
test files leave this process holding tens of GB. About 3 minutes on an
H100 (keygen and the first call's planes). Imports no JAX:
    python -m pytest tests/test_torch_native_n16_cuda.py -m cuda
Without a card the case skips (the NTT kernel has no CPU mode)."""

import gc
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RMS_BAR = 1e-5
RUN = ("import json, sys; sys.path.insert(0, 'scripts'); import torch_bootstrap_n16 as t; "
       "print(json.dumps(t.run(iters=1, emit=lambda d: None)))")


@pytest.mark.cuda
def test_tpu_n16_bootstrap_graph_equals_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NTT kernel has no CPU mode")
    gc.collect()
    torch.cuda.empty_cache()        # what this process's allocator holds, for the child
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=ROOT, capture_output=True,
                          text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    first = out["first_call"]
    assert first["level"] == 11
    assert first["rms_against_decrypted_input"] <= RMS_BAR, first
    assert out["setup"]["config"]["radix"] == 8 and out["setup"]["rows_left"] == 12
    assert out["eager"]["equals_first"]
    graph = out["graph"]
    assert graph["replays"] == 1 and graph["equals_eager"], graph
    assert min(graph["ntt"].values()) > 0
