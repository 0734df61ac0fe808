#!/usr/bin/env python3
"""The native bootstrap on the secure N = 2^16 profile (tpu_n16) on one
NVIDIA card: the port's counterpart of scripts/bootstrap_n16.py.

    python3 scripts/torch_bootstrap_n16.py [iters]

Scheme("tpu_n16") on the card with its galois keys on the device (no key
budget: the ~400 keys take ~35 GB), the native bootstrapper HEVM builds there
(bootstrap_native.native_config: radix 8, K 25 and degree 40 for the h = 192
secret), an input of uniform(-1, 1) encrypted at nl = 2 and scale 2^28 (the
profile's scale), bootstrapped to level 11, the highest radix 8 reaches
(rows_left: 12 of the chain's 42 rows). Prints one JSON line each:

* "setup": context, keygen (public and relinearization keys, then the
  bootstrap's rotation keys and the conjugation key) and bootstrapper-init
  seconds;
* "first_call": the first bootstrap's seconds (it encodes the diagonals and
  constants), its level, RMS and max |error| against the input values and
  against the decrypted input (the bootstrap's own error: at scale 2^28 and
  N = 2^16 a fresh encryption is itself ~4.5e-4 RMS off its values);
* "eager": `iters` more eager bootstraps, seconds each, output byte-equal to
  the first;
* "graph": the signature captured as a CUDA graph (NativeBootstrapper.capture:
  warm-up, recording, instantiation seconds, nodes, pool bytes), `iters`
  replays, seconds each, output byte-equal to the eager one;
* "memory": device peak bytes, key bytes (galois, conjugation,
  relinearization) and plane bytes (cached_planes);
* "keyset_write" (with write_keys): the keyset written as a full HEVM's
  load writes it (crypto/keys.save_keyset, under TMPDIR, removed after):
  seconds and bytes on disk;

then the card's name and power limit (nvidia-smi). The reference's figure
for its HEaaN bootstrap on another GPU is 253.7-474.0 ms (BASELINE.md).
tests/test_torch_native_n16_cuda.py runs `run` with fewer iterations.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE = "tpu_n16"
TARGET_LEVEL = 11
INPUT_NL = 2
INPUT_SEED = 3


def run(iters=3, device="cuda", emit=print, write_keys=False):
    """The measurements of the module docstring, each passed to `emit` as a
    dict; returns {name: dict}."""
    sys.path.insert(0, REPO)
    from dacapo_tpu_torch.crypto.bootstrap_native import native_config
    from dacapo_tpu_torch.crypto.scheme import Ciphertext, Scheme
    out = {}

    def put(name, **kw):
        out[name] = dict(kw)
        emit(dict(part=name, **kw))

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = sync()
    s = Scheme(PROFILE, device=device)
    t1 = sync()
    s.generate_keys()
    t2 = sync()
    bs = s.enable_native_bootstrap(native_config(s.ctx.config))
    t3 = sync()
    steps = bs.rotation_steps()
    s.ensure_galois(steps)
    t4 = sync()
    put("setup", profile=PROFILE, n=s.ctx.n, q_primes=len(s.ctx.q_primes),
        p_primes=len(s.ctx.p_primes), logqp=s.ctx.logqp, config=bs.cfg.__dict__,
        rows_left=bs.rows_left(), context_s=t1 - t0, keygen_s=t2 - t1,
        bootstrapper_init_s=t3 - t2, rotation_keys=len(steps), rotation_keygen_s=t4 - t3)

    n = s.ctx.config.n_slots
    vals = np.random.default_rng(INPUT_SEED).uniform(-1, 1, n)
    ct = s.encrypt(vals, scale=2.0 ** s.ctx.config.scale_bits, nl=INPUT_NL)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = sync()
    data, (nl2, sc2) = bs.bootstrap(ct.data, INPUT_NL, ct.scale, TARGET_LEVEL)
    first_s = sync() - t0
    got, din = s.decrypt(Ciphertext(data, sc2)), s.decrypt(ct)
    err, own = got - vals, got - din
    put("first_call", seconds=first_s, level=nl2 // s.ctx.config.rescale_rows - 1, rows=nl2,
        rms=float(np.sqrt(np.mean(err * err))), max_abs_err=float(np.abs(err).max()),
        rms_against_decrypted_input=float(np.sqrt(np.mean(own * own))),
        max_abs_err_against_decrypted_input=float(np.abs(own).max()),
        input_rms=float(np.sqrt(np.mean((din - vals) ** 2))),
        input_scale_bits=s.ctx.config.scale_bits, input_nl=INPUT_NL)

    eager_s, same = [], True
    for _ in range(iters):
        t0 = sync()
        again, _ = bs.bootstrap(ct.data, INPUT_NL, ct.scale, TARGET_LEVEL)
        eager_s.append(sync() - t0)
        same = same and bool(torch.equal(again, data))
    put("eager", seconds=eager_s, median_s=float(np.median(eager_s)) if eager_s else None,
        equals_first=same)

    if torch.device(device).type == "cuda":
        t0 = sync()
        rec = bs.capture(INPUT_NL, ct.scale, TARGET_LEVEL)
        capture_total = sync() - t0
        replay_s, same, replays0 = [], True, bs.replays
        for _ in range(iters):
            t0 = sync()
            rdata, _ = bs.bootstrap(ct.data, INPUT_NL, ct.scale, TARGET_LEVEL)
            replay_s.append(sync() - t0)
            same = same and bool(torch.equal(rdata, data))
        put("graph", capture_total_s=capture_total,
            **{k: rec[k] for k in ("warmup_s", "capture_s", "instantiate_s", "nodes",
                                   "pool_bytes", "ntt")},
            seconds=replay_s, median_s=float(np.median(replay_s)) if replay_s else None,
            replays=bs.replays - replays0, equals_eager=same)

    keys = s.keys
    key_bytes = dict(galois=len(keys.galois) * s.galois_key_bytes(),
                     conjugation=keys.conj.nbytes, relinearization=keys.rlk.nbytes)
    put("memory", peak_bytes=(torch.cuda.max_memory_allocated()
                              if torch.device(device).type == "cuda" else None),
        galois_keys=len(keys.galois), key_bytes=key_bytes,
        key_bytes_total=sum(key_bytes.values()), planes=bs.cached_planes())
    if write_keys:
        from dacapo_tpu_torch.crypto.keys import save_keyset
        with tempfile.TemporaryDirectory(prefix="keyset_n16_") as d:
            t0 = time.perf_counter()
            save_keyset(keys, d)
            put("keyset_write", seconds=time.perf_counter() - t0,
                bytes=sum(os.path.getsize(os.path.join(r, f))
                          for r, _, fs in os.walk(d) for f in fs))
    return out


def card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv):
    if not torch.cuda.is_available():
        print("torch_bootstrap_n16: no CUDA device", file=sys.stderr)
        return 2
    iters = int(argv[1]) if len(argv) > 1 else 3
    run(iters, emit=lambda d: print(json.dumps(d), flush=True), write_keys=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
