#!/usr/bin/env python3
"""Time this checkout's CUDA NTT kernel against other checkouts', in turns,
on one card.

    python3 scripts/torch_ntt_ab.py OTHER [OTHER ...]

OTHER is the root of another checkout, or of a directory that holds a copy
of its `dacapo_tpu_torch/` package. Each kernel is built from its own
`csrc/ntt.cu` into its own `build/` and loaded on its own. At each shape of
chip_smoke.py's kernel table, both modes run on the same inputs and every
other kernel's output must be bit-equal to this checkout's; then the kernels
are timed in turns (others, this, this, others), each as chip_smoke.py times
it (CUDA events, L2 flushed before each run, median of 25). A kernel that
refuses a shape (ValueError: N outside its range) is recorded as refusing.
Prints one line per shape and mode, then the card's name and power limit,
and writes ntt_ab.json into chip_smoke.py's output directory. Needs one
card; imports no JAX.
"""

import importlib.util
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("tpu_n15", (2, 14, 56, 112, 2240)), ("test_n8", (9,)),
          ("tpu_n16", (2, 42, 126)))


def load_kernel(root, name):
    path = os.path.join(root, "dacapo_tpu_torch", "crypto", "cuda", "ntt_kernel.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def main(others):
    import torch
    if not torch.cuda.is_available():
        print("torch_ntt_ab: no CUDA device", file=sys.stderr)
        return 2
    if not others:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dacapo_tpu_torch.crypto import params
    from dacapo_tpu_torch.crypto.cuda import ntt_kernel as this

    this.build()
    names = [os.path.basename(os.path.normpath(r)) for r in others]
    kernels = {"this": this}
    kernels.update({nm: load_kernel(r, f"ntt_kernel_{i}")
                    for i, (nm, r) in enumerate(zip(names, others))})
    order = names + ["this", "this"] + names[::-1]
    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows_out = []
    for profile, batches in SHAPES:
        ctx = params.CKKSContext(params.PROFILES[profile], "cuda")
        tab = ctx.dev
        for b in batches:
            x, rows, _ = cs.make_planes(torch, tab, b, ctx.n, gen)
            n_primes = len(set(rows.tolist()))
            for inverse in (False, True):
                want = this.ntt_cuda(x, rows, tab, inverse)
                runs, refused = {}, []
                for nm, k in kernels.items():
                    try:
                        got = k.ntt_cuda(x, rows, tab, inverse)
                    except ValueError:
                        refused.append(nm)
                        continue
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{nm} != this at {profile} B={b} inverse={inverse}")
                    runs[nm] = lambda k=k: k.ntt_cuda(x, rows, tab, inverse)
                times = {nm: [] for nm in runs}
                for nm in order:
                    if nm in runs:
                        times[nm].append(cs.time_cuda(runs[nm], torch, flush))
                bound, by = cs.ntt_bound_ms(b, ctx.n, n_primes, inverse)
                ms = {nm: statistics.median(t) for nm, t in times.items()}
                rows_out.append(dict(profile=profile, b=b, inverse=inverse, ms=ms,
                                     turns=times, refused=refused, bound_ms=bound,
                                     bound_by=by))
                cs.log(f"[ab] {'inv' if inverse else 'fwd'} {profile} B={b:<5} "
                       + " ".join(f"{nm} {v:.4f}" for nm, v in ms.items())
                       + "".join(f" {nm} refused" for nm in refused)
                       + f" ms, bound {bound:.4f} ({by})")
            del x, rows, want
        del ctx, tab
        torch.cuda.empty_cache()
    card = cs.card_line()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "ntt_ab.json"), "w") as f:
        json.dump(dict(card=card, others=dict(zip(names, others)), rows=rows_out), f, indent=1)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
