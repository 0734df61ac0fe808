#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dacapo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the environment (card, power limit, torch, CUDA, nvcc);
2. builds the hand-written CUDA NTT kernel (csrc/ntt.cu) from the checkout;
3. holds both kernel modes and the round trip against the plain PyTorch
   NTT on the card, bit for bit, at the shapes of the MLP path at tpu_n15
   (N=2^15), at N=2^11, at test_n8 (N=2^8), at the rescale / ModUp
   shapes of tpu_n16 (N=2^16), and at every batch size the basic phase's
   server requests give the kernel at tpu_n14 (N=2^14) and tpu_n15
   (BASIC_BATCHES) and the mesh's row subsets at tpu_n15
   (MESH_SHARD_BATCHES), and times them (device time by CUDA events, L2 flushed
   before each run, median of 25; at tpu_n14 B=8 and 58 only);
4. compiles, on the host, with the port's own tracer and planner
   (runtime/harness.py): the MLP (pars/40, tpu_n15) and the deep DaCapo
   circuit (dacapo/40, tpu_n15b, depth 20); each .hevm and .cst must equal
   the committed artifact byte for byte, and the MLP and native phases serve
   these files; logs the trace and compile seconds;
5. serves the MLP the port compiled through
   HEVM.load / setInput / run / getOutput for three requests on a freshly
   generated keyset, on the default segment path (load captures one CUDA
   graph per window), checks each RMS against the numpy model and the first
   output ciphertext against the JAX package's digest, and that the plain
   NTT never ran; then runs one ciphertext through executor.run_encrypted
   with jit="segment" and jit=False and requires bit-equal outputs, and
   times three requests per-op (jit=False) for the other median; at the
   phase's end the whole-program path (jit=True: one window, one graph,
   precompile_whole), the same ciphertext byte-equal to the segment
   request's, one graph launch, three timed requests held to the RMS bar;
6. profiles one more segmented request (device time by kernel, device
   kernels, kernels per graph launch, host launch calls, graph replays,
   idle share) with the NTT counts set to 0 just before it: both kernel
   modes must have run, counted on the device (the ntt_pass kernels in the
   trace, graph replays included: the wrapper counts only the launches it
   makes outside graphs); then one per-op request, where the trace's count
   must equal the wrapper's; and times the parts of load, graph capture
   included;
7. ResNet-20 `dacapo 40` (tpu_n15) with the trained checkpoint, full width
   and depth, on an HEVM(jit=True) (the oracle bootstrap keeps it on the
   segment path, as in the JAX package: each request must say
   ("segment", "oracle")): traces it with the port and checks its .cst (and
   its .eir.json without source locations) against the JAX package's
   digests, loads the
   committed .hevm on the MLP's keyset (only the missing rotation keys are
   generated; the load captures the device oracle's graphs, one per cache
   key, and the segment graphs), times keygen / galois keygen / pre-encode /
   oracle capture / capture and reports the plaintext and key bytes and the
   graphs' count; serves TIMED_REQUESTS timed segmented requests, checks the
   RMS of the 10 logits of each against the torch model (bar 9.5152e-4, the
   reference's), that 19 bootstraps ran in each, each one a replay of an
   oracle graph captured at load, and that the plain NTT never ran; reruns
   the last timed request per-op (jit=False, which replays the same oracle
   graphs) with both generators restored (the key generator's, which
   encrypts the input, and the oracle's on the card) and requires bit-equal
   output ciphertexts; reports peak device memory, times one request's
   windows by kind (a synchronize after each window: the boot windows'
   seconds) and profiles one more segmented request (oracle seconds, host
   launch calls, idle share, kernels per graph launch) in which both kernel
   modes must have run, counted on the device as in 6; then the batch part
   on the same HEVM (keys and plaintexts shared): precompile_batch(4)
   captures the batch graphs (the oracle's, one per cache key and B, and
   the segments'), TIMED_REQUESTS timed batch requests of the test images of seeds
   100-103 (setInputBatch, runBatch), every row's RMS held to the same bar,
   19 batched oracle graph replays and no plain NTT call in each, and one
   profiled batch request; seconds a batch and a ciphertext beside the B=1
   median, capture seconds and peak device memory; then, the resident VM
   freed, the streaming part: a second HEVM("tpu_n15") on the same keyset
   and the same traced files under a 10 GiB plan (DACAPO_TPU_HBM_BYTES =
   10 * 2^30), also jit=True (each request ("segment", "streaming")), must
   stream its plaintexts (the compact pool) and its galois
   keys (key budget 5,905,580,032 B: the load pins their host copies and
   makes the key arena); its load captures the segment graphs, each
   decoding its plaintexts in-graph and reading its keys from its arena
   slots, and one oracle graph; one timed request held to the same bar,
   19 oracle replays, no plain NTT and no capture, all 96 graphs
   replayed, the planned key copies and no LRU upload, device key bytes
   (arena and LRU) within the budget; the resident VM's timed request
   (argument and oracle draws restored) gives the resident VM's output
   ciphertexts on the segment path and per-op through the LRU; one request
   profiled (idle share, the key copies' device time), and the decode of
   one request profiled alone (device time, NTT and the rest apart); pool
   bytes against resident plaintext bytes, both VMs' peaks; the earlier
   phases' VMs must all stay resident (streaming: false);
8. runs Scheme("tpu_n16", seed=5) on the card: keygen, encrypt two vectors,
   mul (relinearise), rescale, decrypt; checks the RMS against a*b, the
   output ciphertext bit-equal to the same calls with device="cpu", and that
   both kernel modes ran and the plain NTT never did;
9. the native bootstrap (ModRaise, CoeffToSlot, EvalMod, SlotToCoeff):
   (a) the test_boot bootstrap of tests/test_bootstrap.py on the card, its
   output ciphertext's SHA-256 equal to the JAX package's committed digest;
   (c) HEVM("tpu_n15b") (native bootstraps, radix 7) loads the deep DaCapo
   program the port compiled in 4 (depth 20, 2 bootstraps to level 14, 2^14
   slots) on a fresh keyset, the load running each bootstrap once (its galois keys,
   conjugation key and diagonals are made there) and capturing the graphs,
   the segment windows' and then one per bootstrap signature;
   one timed segmented request (RMS against the plaintext model <= 1e-4,
   2 native bootstraps, both graph replays, the NTT kernel in both modes
   counted as the wrapper's launches plus the replayed graphs' records, the
   plain NTT never), rerun per-op with the input RNG restored (bit-equal;
   its 2 bootstraps eager, "per_op", which drops the bootstrap graphs), one
   request timed by window (it captures the bootstrap graphs again, then
   replays both) and one profiled (the NTT calls in its trace
   at most those the wrapper and the replayed graphs' records count); (b) on the
   same scheme, the standalone bootstrap of uniform(-1, 1) at scale 2^40
   and nl=2 to level 14 (RMS <= 1e-5), timed (TIMED_REQUESTS), one bootstrap
   profiled (idle share, kernels, NTT calls of each mode on the device);
   then its signature captured as a CUDA graph (warm-up, recording and
   instantiation seconds, pool bytes), TIMED_REQUESTS replays timed, byte-equal to
   the eager output, one replay profiled (idle share, NTT calls);
   (d) the same HEVM loads the program again under the JAX package's 16
   GiB plan (DACAPO_TPU_HBM_BYTES = 2^34): its galois keys pass the key
   budget, so it loads on the segment path with a key arena (the native
   bootstraps read theirs through the LRU from pinned host memory) and
   serves the request ciphertext of (c) again with jit=True, which takes the
   segment path for the galois-key budget (("segment", "key_budget")): RMS,
   2 bootstraps (timed; eager, "key_budget"), every graph replayed, the
   planned key copies, device key bytes within the budget, outputs
   bit-equal to (c)'s; one request profiled; the next request's bootstrap
   signature keeps its planes across requests (no re-encode at its start),
   and a request allocates no more than where they were encoded again
   (NATIVE_PLAN_REQUEST_PEAK_BYTES);
   (e) between (c) and (d), the whole-program path: the same HEVM set to
   jit=True loads the program again, which captures ONE CUDA graph of every
   window with both native bootstraps recorded inline (warm-up, recording
   and instantiation seconds, nodes, pool bytes), and serves (c)'s request
   again with the key generator's state restored: ("whole", None), 2
   bootstraps counted as replays inside the graph, one graph launch, output
   ciphertexts byte-equal to (c)'s segment request (and so to its per-op
   rerun), RMS; a profiled request (graph launches, idle share, NTT calls
   on the device); (f) in the native ResNet phase (13), before its server
   HEVM(jit=True), which holds no secret key, loads ResNet, it loads the
   deep program (its whole-program graph) and serves (e)'s argument blob:
   the same path and counts, the result blob byte-equal to the full VM's;
10. the basic phase: the five non-MLP rows of the basic list
    (SobelFilter, HarrisCornerDetection, LinearRegression, Multivariate on
    tpu_n14, PolynomialRegression on tpu_n15, pars/40, the inputs of
    dacapo_tpu_torch/examples/tests/<Name>.py), each compiled by the port
    (.hevm and .cst SHA-256 equal to artifacts/basic_pars40/expected.json,
    the JAX package's), its galois keys made by a full HEVM on a fresh
    keyset, its inputs encrypted and shipped by a client HEVM, served by a
    server HEVM that holds no secret key (three timed requests, one
    profiled: NTT calls on the device), its results shipped back and
    decrypted by the client (RMS against the numpy golden <= 2e-5), and the
    full HEVM's outputs on the same blobs bit-equal to the server's; a
    second server HEVM(jit=True) loads the row (one whole-program graph)
    and serves the same blobs three times, timed, one graph launch each,
    its result blobs byte-equal to the segment server's; then
    Multivariate as a batch of 8 input sets on its full HEVM (batch graphs
    captured, three timed batch requests and a profiled one): every row's
    output ciphertexts byte-equal to a single request's on the same argument
    ciphertexts, every row's RMS <= 2e-5, seconds a batch and a ciphertext
    beside the single requests' in the same run; then the same batch on a
    second HEVM under a 64 MiB plan (DACAPO_TPU_HBM_BYTES), which streams
    its plaintexts and budgets its galois keys: its batch graphs decode
    in-graph and read their keys from the arena, and its rows must equal
    the resident batch's byte for byte, one request profiled;
    then the mesh part (parallel/mesh.py): an in-process NCCL group of
    world size 1, and the same batch on the resident full HEVM through
    precompile_batch(8, mesh=make_mesh(1)) and runBatch's path over the
    mesh (its keys split at mp = 1, its batch graphs recording the mp
    all-gathers): three timed batches beside the mesh=None median, the
    graphs and the collectives of each batch (in the graphs, eager, dp),
    rows byte-equal to the mesh=None batch, runBatch(mesh=...)'s rows held
    to the RMS bar, one batch profiled (NTT calls on the device);
11. the NTT at every batch size the two batch paths launched (recorded by
    wrapping the Evaluator's kernel call over each batch capture and first
    request) and at every batch size the two streaming parts' plaintext
    decodes launched (recorded by wrapping the Evaluator's decode),
    bit-equal to the plain NTT in both modes, the largest timed against its
    bound (the mesh's shard arithmetic is scripts/mesh_shard_check.py's;
    3 holds the NTT at the batch sizes its row subsets launch,
    MESH_SHARD_BATCHES);
12. the profile phase: runtime/profiler.py's tpu_n14 latency table (CUDA
    events) into OUT_DIR, read back by ir/config.load_profile, every
    row positive and nondecreasing;
13. the native ResNet phase (serve_resnet_native): ResNet-20 `dacapo 40`
    on tpu_n15b with native bootstraps (radix 7; K 24 and degree 40 for its
    h = 192 secret, crypto/bootstrap_native.sized_for_secret), client to
    server: the committed
    artifacts/resnet_dacapo40_tpu_n15b (its .hevm and the trace of 7 by
    their SHA-256), a full HEVM on the keyset of 9 (c) makes ResNet's missing
    rotation keys without loading the program (HEVM.make_keys), the keyset
    is saved in halves (the server's without the secret key), every earlier
    VM is freed, a server HEVM loads the program (warming each of its
    bootstrap signatures, which must equal expected.json's, capturing the
    segment graphs and then one CUDA graph per bootstrap signature the
    plane bound leaves room to pin; no oracle graph), a client HEVM
    encrypts the golden input and ships it; the server runs it on the
    segment path (a jit=True request, ("segment", "streaming"): its
    plaintexts stream; timed, its bootstraps timed apart: every boot window a
    graph replay but those eager for a stated reason, EAGER_REASONS, as
    the executor's plan says): the
    request's result shipped back and decrypted by the client (RMS of the
    10 logits <= 9.5152e-4), 18 native bootstraps, no key made, no plain
    NTT, NTT calls in both modes (the wrapper's launches outside graphs
    plus what each replayed graph recorded at capture); since PR 17 no
    per-op rerun (57.8 s; the per-op path with native bootstraps is the
    deep program's rerun in 9 and the squeezenet phase's, each held byte
    for byte to its segment request); load seconds by part, device bytes (keys, pool,
    diagonals, peaks); then the NTT at every batch size the load and the
    requests gave it, bit-equal to the plain NTT in both modes;
14. the squeezenet_native phase (serve_squeezenet_native(prefix=True)),
    after every earlier VM is freed: SqueezeNet `dacapo 40` on tpu_n15b
    (deterministic-random weights), the first model of the deep list, cut
    to its prefix at full width: conv_1, avgpool_1 and fire_2 (the
    committed artifacts/squeezenet_dacapo40_tpu_n15b/SqueezeNetPrefix.hevm
    and the port's own trace, nt = 2^14, by SHA-256; one native bootstrap),
    under expected.json's memory plan (DACAPO_TPU_HBM_BYTES = its key
    bytes), which streams its keys as the card's plan streams the whole
    network's 57.7 GB; the host's memory read against the keyset before
    the first key; a full HEVM("tpu_n15b", save_keys=False) makes the keys
    into pinned host slabs (the graph windows' key arena, the native
    bootstraps through the LRU; nothing written) and warms each bootstrap
    signature under a plane bound of 0; the golden input encrypted once; a
    timed segment request (the plaintexts stream, every bootstrap eager for
    "key_budget"), a profiled one, a per-op one: RMS of every output slot
    against the exact-float simulation's and against the torch model's
    activations (OutPack) at most 9.5152e-4; expected.json's bootstrap
    count, each bootstrap's seconds, key uploads and planes encoded again;
    no key made, no plain NTT, the outputs byte-equal; then the NTT at
    every batch size the phase launched, bit-equal to the plain NTT. The
    whole network (734 keys, 14 bootstraps, ~9 minutes on the card) does
    not fit the smoke's time limit beside the other phases: it runs the
    same function (prefix=False), with the same checks against its
    logits, in scripts/torch_squeezenet_native.py, whose numbers PERF.md
    gives;
15. the native_n16 phase (serve_native_n16), after every earlier VM is
    freed: native bootstrapping on the 128-bit-secure tpu_n16 (N = 2^16),
    radix 8 (bootstrap_native.native_radix), K 25 and degree 40, the
    working scale EvalMod returns to and SlotToCoeff's first level on it
    (bootstrap_native.WIDE_SLOTS): HEVM("tpu_n16") on a fresh keyset loads
    the committed artifacts/deep_dacapo40_tpu_n16 (depth 6, one bootstrap
    to level 11; its .hevm and .cst by SHA-256, its signature, 398 keys and
    1,916 diagonals + 56 constants by expected.json's dry plan), its ~35 GB
    of keys kept in memory (HEVM(save_keys=False): the machine takes 45 GiB
    of writes a run); two timed segment requests, one profiled,
    one per op and one whole-program request (jit=True), the same
    ciphertext each: byte-equal, RMS <= 1e-4, one native bootstrap each
    (replayed, or eager "per_op"), no key made, no plain NTT; then the NTT
    at every batch size the phase launched, bit-equal to the plain NTT;
16. the native artifact core (vm/native.py, csrc/hevm_core.cpp), built
    with g++ before the first phase: every .hevm and .cst the phases read
    and write goes through it (its calls are counted and must be nonzero;
    its read time against the Python reader is
    scripts/hevm_read_timing.py's);
17. prints the kernel table as one JSON line (launches: the profiled
    ResNet request's, counted on the device; every path's under
    launches_by_path, and per ciphertext; the batch shapes' times), then
    the card's name and power limit, then {"ok": true, "device": {...}} as
    the last line.

The segment graphs and the native bootstrap's graphs record without an
eager warm-up where their device caches are full (a cache that would fill
under capture stops the recording, and that window warms up first); each
phase's time is logged as "[time] <phase>", the native phase's parts as
"[time]   <part>".

Any failed check raises, so the script exits non-zero and prints no result.
Without CUDA, or outside a checkout of the repository, it exits 2.
"""

import collections
import dataclasses
import gc
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "mlp_pars40_tpu_n15")
RESNET_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15")
RESNET_CKPT = os.path.join(REPO, "examples", "data", "resnet20.silu.model")
RESNET_TRACE = os.path.join(REPO, "traced", "resnet_torch")     # gitignored
NATIVE_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "deep_dacapo40_tpu_n15b")
RESNET_NATIVE_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts",
                                 "resnet_dacapo40_tpu_n15b")
TEST_BOOT_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "native_test_boot")
BASIC_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "basic_pars40")
OUT_DIR = os.path.join(REPO, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# H100 SXM 32-bit integer instructions a second: 64 INT32 lanes per SM (half
# the 128 FP32 lanes; Hopper architecture white paper) x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9
RMS_BAR = 1e-6
RMS_BAR_N16 = 1e-3
RMS_BAR_RESNET = 9.5152e-4     # the reference's published ResNet-20 RMS
RMS_BAR_NATIVE_BOOT = 1e-5     # the standalone tpu_n15b bootstrap (JAX on the TPU: 3.087e-6)
RMS_BAR_NATIVE_DEEP = 1e-4     # the deep DaCapo program on tpu_n15b
RMS_BAR_BASIC = 2e-5           # the basic rows (JAX on the TPU: 1.05e-7 to 6.49e-6)
N_TIMED = 25
# timed requests of the ResNet B=1 and B=4 paths, of the standalone native
# bootstrap (eager and replayed) and of the deep program's whole-program path
# (the second replays the same graphs: state carried between requests shows);
# the deep native VM, its 16 GiB plan and the 10 GiB streaming ResNet VM time
# one each since the native ResNet phase joined, to keep the run inside its
# time limit
TIMED_REQUESTS = 2
TIMED_REQUESTS_SHORT = 1
RESNET_BATCH = 4               # ciphertexts a ResNet batch request carries
BASIC_BATCH = 8                # and a Multivariate one
BASIC_BATCH_ROW = "Multivariate"
# device-memory plans (DACAPO_TPU_HBM_BYTES; vm/executor.py: galois keys
# past 55 % of it and plaintexts past 12 % stream). ResNet-20 at 10 GiB:
# key budget 5,905,580,032 B (about 160 of its 202 keys), plaintext budget
# 1,288,490,188 B, so both stream
STREAM_HBM_BYTES = 10 << 30
# the JAX package's 16 GiB assumption for a device without memory stats:
# the deep tpu_n15b program's 161 galois keys and conjugation key (78.6 MB
# each) pass its 9,448,928,051 B key budget
NATIVE_PLAN_BYTES = 16 << 30
# the most a request of that plan may allocate: its peak where every request
# dropped the next bootstrap signature's plane group at its start and encoded
# it again (scripts/native_budget_peak.py, on an H100 80GB HBM3); keeping the
# group across requests must not raise it
NATIVE_PLAN_REQUEST_PEAK_BYTES = 19_167_479_808
# Multivariate at tpu_n14: 12 % of 64 MiB is below its 8,257,536 B of
# resident plaintexts, and 55 % of it below its twelve 10.5 MB keys
BASIC_PLAN_BYTES = 64 << 20
KEY_BUDGET_FRAC = 0.55         # vm/executor.py HEVMExecutor.KEY_BUDGET_FRAC
# why a native boot window may run eagerly on the card (vm/executor.py
# boot_window_plan); any other eager bootstrap fails the run
EAGER_REASONS = {"per_op", "mesh", "key_budget", "dropped_group"}


def log(*a):
    print(*a, flush=True)


def sh(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"


def reset_counts(nk, ntt_mod):
    """Set the NTT kernel's launch counts and the plain NTT's call counts to 0."""
    for counts in (nk.LAUNCHES, ntt_mod.CALLS):
        for k in counts:
            counts[k] = 0


def card_line():
    return sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


def time_cuda(fn, torch, flush):
    """Median device milliseconds of fn() over N_TIMED runs, each timed with
    CUDA events after a write of 64 MB has flushed the 50 MB L2. A spin of
    ~4 ms queued first keeps the card busy while the host enqueues the run
    (well under 1 ms for every function timed here), so the time excludes
    host launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        torch.cuda._sleep(8_000_000)
        flush.add_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ntt_bound_ms(b, n, n_primes, inverse):
    """Least time for one call: bytes (plane in + out, value and Shoup
    twiddle rows of each distinct prime) over the memory rate, or the 32-bit
    integer operations over the INT32 rate, whichever is larger. Operations
    are counted as the algorithm needs them, not as the compiled code has
    them: 7 per butterfly (1 mul.hi, 2 mul.lo, ~4 add/compare) and 4 more
    per element for the inverse's N^-1."""
    logn = n.bit_length() - 1
    nbytes = 2 * b * n * 4 + n_primes * 2 * n * 4
    ops = b * logn * (n // 2) * 7 + (b * n * 4 if inverse else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def make_planes(torch, tab, b, n, gen):
    """b planes of random residues; rows: every prime, repeated and out of
    order (a permutation first), as int32 [b] on the card."""
    p = tab["q"].shape[0]
    perm = torch.randperm(p, generator=gen, device="cuda")
    extra = torch.randint(0, p, (max(0, b - p),), generator=gen, device="cuda")
    rows = torch.cat([perm, extra])[:b].to(torch.int32).contiguous()
    q = tab["q"][rows.long()].to(torch.int64)[:, None]
    x = (torch.randint(0, 1 << 62, (b, n), generator=gen, device="cuda",
                       dtype=torch.int64) % q).to(torch.int32)
    return x, rows, q


# NTT batch sizes of the basic phase's server requests, per profile: every
# (N, B) that Evaluator._ntt took in one request of each row, recorded on a
# CPU run of the same client/server flow (tpu_n14: SobelFilter,
# HarrisCornerDetection, LinearRegression, Multivariate; tpu_n15:
# PolynomialRegression). These are checked for equality only; tpu_n14 is
# also timed at BASIC_TIMED_N14 (B=58, its largest: ModUp at the top level;
# B=8, the commonest)
BASIC_BATCHES = {
    "tpu_n14": (2, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 32, 36, 58),
    "tpu_n15": (2, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36,
                53, 57),
}
BASIC_TIMED_N14 = (8, 58)
# NTT batch sizes of the mesh's row subsets at tpu_n15's top level (nl = 28)
# at mp = 2 and 4: what parallel.mesh.shard_check launched on the card
# (scripts/mesh_shard_check.py runs that check); checked here for equality
MESH_SHARD_BATCHES = (25, 28, 29, 54, 58, 112)


def kernel_checks(torch, params, ntt_mod, nk):
    """Both modes against the plain NTT at the shapes of every path."""
    results = {"fwd": {}, "inv": {}}
    max_err = {"fwd": 0, "inv": 0}
    # tpu_n15: the device oracle's shapes at ResNet's bootstraps are B=3 (the
    # inverse NTT of the decrypted message at its 3 base rows), 28 (m2) and
    # 84 (the three noise polynomials over 28 rows); tpu_n15b: ModDown /
    # mod_raise_pair (2 x 60 rows) and ModUp (4 digits x 60 targets) at
    # nl = 60, the native bootstrap's shapes
    timed_n15 = (2, 3, 14, 28, 56, 84, 112, 2240)
    checks = (("tpu_n15", timed_n15, timed_n15 + BASIC_BATCHES["tpu_n15"]
               + MESH_SHARD_BATCHES),
              ("tpu_n14", BASIC_TIMED_N14, BASIC_BATCHES["tpu_n14"]),
              ("test_n11", (2, 37), (2, 37)),
              ("test_n8", (2, 9), (2, 9)), ("tpu_n16", (2, 42, 126), (2, 42, 126)),
              ("tpu_n15b", (120, 240), (120, 240)))
    checked = {}
    for profile, timed, batches in checks:
        checked[profile] = check_shapes(torch, params, ntt_mod, nk, profile, batches, timed,
                                        results, max_err)
    log("[ntt] equal to the plain NTT, both modes and the round trip, at "
        + "; ".join(f"{p} B={','.join(map(str, bs))}" for p, bs in checked.items()))
    log("[ntt] library: no single PyTorch call computes a modular NTT "
        "(torch.fft is floating point): library_ms is null")
    return results, max_err


def check_shapes(torch, params, ntt_mod, nk, profile, batches, timed, results, max_err,
                 plain_up_to=480):
    """Both modes and the round trip bit-equal to the plain NTT at each batch
    size of `batches` on `profile`; the sizes in `timed` are also timed
    against the bound (device time by CUDA events, L2 flushed, median of
    N_TIMED) into results[mode][(profile, B)]. Returns the sizes checked."""
    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    ctx = params.CKKSContext(params.PROFILES[profile], "cuda")
    tab = ctx.dev
    for b in sorted(set(batches)):
        x, rows, q = make_planes(torch, tab, b, ctx.n, gen)
        idx = rows.long()
        plain = {
            "fwd": lambda: ntt_mod.ntt_fwd(x, tab["tw"][idx], q),
            "inv": lambda: ntt_mod.ntt_inv(x, tab["itw"][idx], q, tab["ninv"][idx][:, None]),
        }
        kern = {
            "fwd": lambda: nk.ntt_cuda(x, rows, tab, False),
            "inv": lambda: nk.ntt_cuda(x, rows, tab, True),
        }
        for mode in ("fwd", "inv"):
            got, want = kern[mode](), plain[mode]()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err[mode] = max(max_err[mode], err)
            if not torch.equal(got, want):
                raise AssertionError(f"{mode} kernel != plain at {profile} B={b}: max err {err}")
        back = nk.ntt_cuda(nk.ntt_cuda(x, rows, tab, False), rows, tab, True)
        if not torch.equal(back, x):
            raise AssertionError(f"roundtrip failed at {profile} B={b}")
        if b not in timed:
            del x, q
            continue
        n_primes = len(set(rows.tolist()))
        for mode in ("fwd", "inv"):
            k_ms = time_cuda(kern[mode], torch, flush)
            p_ms = (time_cuda(plain[mode], torch, flush)
                    if plain_up_to is None or b <= plain_up_to else None)
            bound, by = ntt_bound_ms(b, ctx.n, n_primes, mode == "inv")
            results[mode][(profile, b)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                               bound_by=by)
            log(f"[ntt] {mode} {profile} B={b:<5} equal=True kernel {k_ms:.4f} ms "
                f"plain {'-' if p_ms is None else f'{p_ms:.4f}'} ms "
                f"bound {bound:.4f} ms ({by})")
        del x, q
    del ctx, tab, flush
    torch.cuda.empty_cache()
    return sorted(set(batches))


class NttShapes:
    """The batch sizes of every NTT call the Evaluator makes (crypto/ops.py
    calls ntt_cuda by name) between start() and stop(), in graph captures
    and eager calls alike, in `sizes`. It wraps the call and counts nothing:
    the wrapper's launch counts are its own."""

    def __init__(self):
        from dacapo_tpu_torch.crypto import ops
        self.ops, self.kernel, self.sizes = ops, ops.ntt_cuda, set()

    def start(self):
        def recorded(x, rows, tables, inverse=False):
            self.sizes.add(int(x.shape[0]))
            return self.kernel(x, rows, tables, inverse)

        self.ops.ntt_cuda = recorded

    def stop(self):
        self.ops.ntt_cuda = self.kernel


def batch_kernel_checks(torch, params, ntt_mod, nk, profile, sizes, tag, plain_up_to=480):
    """The NTT at every batch size a batch path gave it (NttShapes),
    bit-equal to the plain NTT in both modes; the largest timed against its
    bound, and the plain NTT beside it up to plain_up_to (None: at every
    size). Returns {checked, largest, fwd, inv, max_abs_err}."""
    results = {"fwd": {}, "inv": {}}
    max_err = {"fwd": 0, "inv": 0}
    largest = max(sizes)
    checked = check_shapes(torch, params, ntt_mod, nk, profile, sizes, (largest,), results,
                           max_err, plain_up_to)
    log(f"[ntt] {tag}: equal to the plain NTT, both modes and the round trip, at every batch "
        f"size the path launched on {profile}: B={','.join(map(str, checked))}")
    return dict(checked=checked, largest=largest, max_abs_err=max_err,
                **{m: results[m][(profile, largest)] for m in results})


# CUDA API calls that launch work (cuda* runtime, cu* low-level), as torch.profiler names them
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                       "cuLaunchKernelEx")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
# traces of one request taken while each lost kernel records: a trace drops
# records now and then (scripts/trace_loss_probe.py: in 60 traces of one
# batch request, 1 held unequal NTT passes and 11 whole calls fewer than ran),
# and a loss tends to repeat within a run (all six traces of the streamed
# Multivariate batch in one run, of the Multivariate request and batch in
# another); after the last, the trace's NTT calls are kept as a lower bound
# of the counted ones
PROFILE_ATTEMPTS = 3


TraceRow = collections.namedtuple("TraceRow", "key device_type count self_device_time_total")


def trace_summary(prof):
    """One walk over a trace's raw events, in place of key_averages(),
    which first builds torch.profiler's FunctionEvent tree of every event
    (a ResNet request's trace holds ~555k device events), skipping the
    events it skips: rows in the shape of key_averages()'s,
    one per (name, device type) with its count and device microseconds
    (nk.launches_in_profile reads them), and the device kernels of each
    graph launch, in launch order: the kernels (copies and sets left out)
    that carry the CUPTI correlation id of a graph launch call, as every
    kernel node of a launched graph does; and the count of every name among
    the device ops of those launches."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    events = prof.profiler.kineto_results.events()
    rows = {}
    launch_ids, by_corr = [], collections.defaultdict(list)
    hidden = bool(events) and hasattr(events[0], "is_hidden_event")
    for e in events:
        name = e.name()
        # the events key_averages() leaves out: bookkeeping names, and the
        # hidden ones (records of kernels outside the profiled window)
        if _filter_name(name) or (hidden and e.is_hidden_event()):
            continue
        # the enum compared as it is (its str() cost a third of the walk)
        cuda = e.device_type() == DeviceType.CUDA
        r = rows.get((name, cuda))
        if r is None:
            r = rows[(name, cuda)] = [0, 0]
        r[0] += 1
        if cuda:
            r[1] += e.duration_ns()
            by_corr[e.correlation_id()].append(name)
        elif name in GRAPH_LAUNCH_CALLS:
            launch_ids.append(e.correlation_id())
    out = [TraceRow(name, "DeviceType.CUDA" if cuda else "DeviceType.CPU", n, ns / 1e3)
           for (name, cuda), (n, ns) in rows.items()]
    in_graphs = [name for c in set(launch_ids) for name in by_corr.get(c, ())]
    per_graph = [sum(1 for name in by_corr.get(c, ()) if not name.startswith(("Memcpy", "Memset")))
                 for c in launch_ids]
    names = collections.Counter(name[:100] for name in in_graphs).most_common()
    return out, per_graph, names


def graph_replays(executor):
    """Graph launches so far: the executor's (segment and whole-program
    graphs) and the bootstrapper's (the device oracle's, the native
    bootstrap's own graphs; not the native bootstraps replayed inside the
    whole-program graph, NativeBootstrapper.inlined)."""
    bs = getattr(executor, "bootstrapper", None)
    return executor.replays + getattr(bs, "replays", 0) - getattr(bs, "inlined", 0)


def graph_ntt(executor):
    """NTT calls the replayed graphs ran so far, as each graph recorded
    them at capture: the segment graphs' and the device oracle's."""
    out = dict.fromkeys(("ntt_fwd_cuda", "ntt_inv_cuda"), 0)
    for rec in (getattr(executor, "replayed_ntt", {}),
                getattr(getattr(executor, "bootstrapper", None), "replayed_ntt", {})):
        for k, v in rec.items():
            out[k] += v
    return out


def profile_request(torch, request, tag, executor, nk, ntt_mod, cpu=True, trace_loss_ok=False):
    """One request under torch.profiler, with the NTT counts set to 0 just
    before it and read just after: device time by kernel, the NTT kernel's
    share, and the device's idle share of the request's wall time. Device
    ops are the kernels (inside graphs or not) and copies the profiler saw
    run on the card; host launches are the launch calls it saw on the host:
    kernel launches outside graphs plus graph launches, the latter checked
    against the executor's and the oracle's replay counters. ntt_launches: the NTT calls the
    device ran (nk.launches_in_profile, graph replays included);
    ntt_wrapper_launches: the calls the wrapper launched itself, outside
    graphs. Without replays the two must be equal. cpu=False records
    device activity and the runtime calls only (lighter on a long request).
    trace_loss_ok: a trace that holds fewer NTT calls than the wrapper
    launched is reported (ntt_trace_short_by), not profiled again: the native
    bootstrap's traces drop a few kernel records (a standalone bootstrap's
    trace held one NTT call of each mode fewer than the wrapper launched, in
    two runs, and 69,890 device kernels and copies against 69,895 kernel
    launch calls).
    ntt_counted: the NTT calls the request ran, counted without the trace:
    the wrapper's launches plus what each replayed graph recorded at
    capture (graph_ntt); a trace that holds more is refused as one that lost
    records is, and the run fails if the last one does.
    A trace whose NTT passes are unequal (nk.TraceLossError: it lost a
    kernel record; a ResNet request's trace of ~555k device kernels once held
    one pass-A kernel fewer than pass-B), or, without trace_loss_ok, that
    holds fewer NTT calls than the wrapper launched (the streaming decode's
    trace once held 418 of 420, and 9,194 device kernels and copies against
    9,240 kernel launch calls), is refused: the request is profiled again,
    up to PROFILE_ATTEMPTS times. If every trace lost records, the last one
    gives the numbers, its NTT calls (each mode's larger pass count) a lower
    bound of ntt_counted (ntt_trace_short_by). `request` must be safe to
    repeat; plain NTT calls are summed over all attempts, and lossy_traces
    lists the refused ones."""
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    lossy, plain = [], {}
    for attempt in range(PROFILE_ATTEMPTS):
        replays0, graph_ntt0 = graph_replays(executor), graph_ntt(executor)
        torch.cuda.synchronize()
        reset_counts(nk, ntt_mod)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        wrapper = dict(nk.LAUNCHES)
        plain = {k: plain.get(k, 0) + v for k, v in ntt_mod.CALLS.items()}
        replays = graph_replays(executor) - replays0
        counted = {k: wrapper[k] + v - graph_ntt0[k] for k, v in graph_ntt(executor).items()}
        averages, per_graph, graph_names = trace_summary(prof)
        del prof
        trace_s = time.perf_counter() - t1
        passes = nk.passes_in_profile(averages)
        over = {k: ab for k, ab in passes.items() if max(ab) > counted[k]}
        try:
            if over:
                raise nk.TraceLossError(f"the trace holds more NTT passes {over} than the "
                                        f"wrapper and the graphs' records count {counted}")
            ntt_launches = nk.launches_in_profile(averages)
            short = {k: wrapper[k] - ntt_launches[k] for k in wrapper
                     if ntt_launches[k] < wrapper[k]}
            if short and not trace_loss_ok:
                raise nk.TraceLossError(f"the trace holds fewer NTT calls than the wrapper "
                                        f"launched: {ntt_launches} < {wrapper}")
            break
        except nk.TraceLossError as e:
            lossy.append(str(e))
            if attempt == PROFILE_ATTEMPTS - 1:
                if over:
                    raise AssertionError(f"[{tag}] every trace lost kernel records, the last "
                                         f"one held more than ran: {lossy}")
                ntt_launches = {k: max(ab) for k, ab in passes.items()}
                short = {k: counted[k] - v for k, v in ntt_launches.items() if v < counted[k]}
                log(f"[{tag}] all {PROFILE_ATTEMPTS} traces lost kernel records ({lossy}): "
                    f"the last one's numbers are kept, its NTT calls {ntt_launches} a lower "
                    f"bound of the {counted} counted")
            else:
                log(f"[{tag}] the trace lost kernel records ({e}): profiling the request "
                    "again")
                time.sleep(1.0)
    rows = []
    calls = {}
    for e in averages:
        if e.key in KERNEL_LAUNCH_CALLS + GRAPH_LAUNCH_CALLS:
            calls[e.key] = calls.get(e.key, 0) + e.count
        if not str(e.device_type).endswith("CUDA"):
            continue   # CPU ops repeat the device time of their kernels
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    ntt = sum(r[0] for r in rows if "ntt_pass" in r[2]) / 1e6
    eager = sum(calls.get(k, 0) for k in KERNEL_LAUNCH_CALLS)
    graph_calls = sum(calls.get(k, 0) for k in GRAPH_LAUNCH_CALLS)
    out = dict(wall_s=wall, trace_s=trace_s, device_busy_s=busy, ntt_kernel_s=ntt,
               device_ops=sum(r[1] for r in rows), replays=replays,
               eager_kernel_launches=eager, graph_launch_calls=graph_calls,
               host_launches=replays + eager, launch_calls=calls,
               ntt_launches=ntt_launches, ntt_wrapper_launches=wrapper, ntt_counted=counted,
               plain_ntt_calls=plain, lossy_traces=lossy,
               graph_kernels=dict(
                   launches=len(per_graph), total=sum(per_graph),
                   largest=max(per_graph, default=0), per_launch=per_graph,
                   device_ops_by_name=graph_names),
               idle_share=(1 - busy / wall) if busy else None,
               by_kernel=[dict(device_s=r[0] / 1e6, count=r[1], name=r[2][:120]) for r in rows])
    log(f"[{tag}] host launches {out['host_launches']} = {replays} graph replays (executor "
        f"and oracle) + "
        f"{eager} kernel launches outside graphs (profiler: {calls}); device kernels and "
        f"copies {out['device_ops']}")
    if graph_calls != replays:
        log(f"[{tag}] note: the profiler saw {graph_calls} graph launches, the executor "
            f"and the oracle counted {replays} replays")
    if per_graph:
        log(f"[{tag}] kernels in the {len(per_graph)} graph launches: {sum(per_graph)} "
            f"(largest {max(per_graph)})")
    log(f"[{tag}] NTT calls the device ran {ntt_launches}, counted {counted} (the wrapper "
        f"launched outside graphs {wrapper}), plain NTT calls {plain}")
    out["ntt_trace_short_by"] = short
    if short:
        log(f"[{tag}] the trace holds fewer NTT calls than were counted, short by "
            f"{short}: it dropped records (device kernels and copies {out['device_ops']}, "
            f"kernel launch calls {eager})")
    elif replays == 0 and ntt_launches != wrapper:
        raise AssertionError(f"without graphs the trace's NTT calls {ntt_launches} differ "
                             f"from the wrapper's {wrapper}")
    if busy:
        log(f"[{tag}] request (profiled) wall {wall:.4f} s, device busy {busy:.4f} s "
            f"(idle share {1 - busy / wall:.3f}), {out['device_ops']} device kernels and copies, "
            f"NTT kernel {ntt:.4f} s ({ntt / busy:.3f} of device time); the trace read in "
            f"{trace_s:.2f} s")
        for r in rows[:12]:
            log(f"[{tag}]   {r[0] / 1e3:9.3f} ms  x{r[1]:<6} {r[2][:90]}")
    else:
        log(f"[{tag}] no device time in the trace: device busy/idle share not measured")
    return out


def compile_programs(out_dir):
    """The compile phase: the port traces the MLP (pars/40, tpu_n15) and the
    deep DaCapo circuit (dacapo/40, tpu_n15b, its depth from expected.json)
    and compiles both with its own planner (runtime/harness.py:
    compile_traced), on the host. Each .hevm and .cst must equal the
    committed artifact byte for byte; the MLP and native phases serve these
    files. Returns ({name: (cst, hevm)}, results)."""
    from dacapo_tpu_torch.crypto.params import PROFILES
    from dacapo_tpu_torch.models import deep, mlp
    from dacapo_tpu_torch.runtime.harness import compile_traced, trace_and_save
    with open(os.path.join(NATIVE_ART, "expected.json")) as f:
        depth = json.load(f)["depth"]
    weights = mlp.gen_weights()
    jobs = (
        ("MLP", ARTIFACT, "pars", 40, "tpu_n15",
         lambda d: trace_and_save("MLP", "c", lambda x: mlp.mlp_forward(x, weights), d)),
        ("Deep", NATIVE_ART, "dacapo", 40, "tpu_n15b",
         lambda d: deep.trace_deep(d, PROFILES["tpu_n15b"].n_slots, depth)),
    )
    files, results = {}, {}
    for name, art, pipeline, waterline, profile, trace in jobs:
        traced = os.path.join(out_dir, "traced")
        t0 = time.perf_counter()
        trace(traced)
        t1 = time.perf_counter()
        hevm = compile_traced(name, pipeline, waterline, profile, traced_dir=traced,
                              out_dir=os.path.join(out_dir, "optimized"))
        t2 = time.perf_counter()
        cst = os.path.join(traced, f"_hecate_{name}.cst")
        r = results[name] = dict(
            pipeline=pipeline, waterline=waterline, profile=profile,
            trace_s=t1 - t0, compile_s=t2 - t1, hevm_sha256=sha256_file(hevm),
            cst_sha256=sha256_file(cst),
            hevm_equal=sha256_file(hevm) == sha256_file(os.path.join(art, f"{name}.hevm")),
            cst_equal=sha256_file(cst) == sha256_file(os.path.join(art, f"{name}.cst")))
        log(f"[compile] {name} ({pipeline}/{waterline}, {profile}): trace {r['trace_s']:.3f} s, "
            f"compile {r['compile_s']:.3f} s; .hevm sha256 {r['hevm_sha256']} equal to the "
            f"committed file: {r['hevm_equal']}; .cst equal: {r['cst_equal']}")
        if not (r["hevm_equal"] and r["cst_equal"]):
            raise AssertionError(f"the port's {name} program differs from {art}")
        files[name] = (cst, hevm)
    return files, results


def serve_mlp(np, torch, HEVM, mlp, nk, ntt_mod, params, keydir, files):
    """The MLP on a keyset generated afresh into keydir."""
    with open(os.path.join(ARTIFACT, "expected.json")) as f:
        expected = json.load(f)
    weights = mlp.gen_weights()
    phases = {}
    reset_counts(nk, ntt_mod)

    def mark(name, t0):
        torch.cuda.synchronize()
        phases[name] = dict(seconds=time.perf_counter() - t0, **nk.LAUNCHES)
        for k in nk.LAUNCHES:
            nk.LAUNCHES[k] = 0

    t0 = time.perf_counter()
    vm = HEVM("tpu_n15", keyset_dir=keydir)
    mark("keygen", t0)
    t0 = time.perf_counter()
    vm.load(*files["MLP"])
    mark("load", t0)
    ex = vm.executor
    cap = ex.capture_stats
    phases["streaming"] = ex.streaming
    if ex.streaming:
        raise AssertionError("the MLP streams its plaintexts under the card's default budget")
    log(f"[mlp] load captured {cap['graphs']} graphs of {cap['windows']} windows in "
        f"{vm.load_seconds['capture']:.3f} s (warm-up {cap['warmup_s']:.3f}, capture and "
        f"instantiate {cap['capture_s']:.3f} s)")
    rms_all = []
    for seed in (0, 1, 2):
        x = mlp.make_input(seed)
        t0 = time.perf_counter()
        vm.setInput(0, x)
        vm.run()
        out = vm.getOutput()[0][:10]
        mark(f"request{seed}", t0)
        if out.shape != (10,) or not np.isfinite(out).all():
            raise AssertionError(f"bad output {out!r}")
        rms = float(((out - mlp.mlp_plain(x, weights)) ** 2).mean() ** 0.5)
        rms_all.append(rms)
        ph = phases[f"request{seed}"]
        ph["rms"] = rms
        log(f"[mlp] request seed={seed} (segment): {ph['seconds']:.4f} s "
            f"rms {rms:.3e}, NTT launches outside graphs fwd {ph['ntt_fwd_cuda']} "
            f"inv {ph['ntt_inv_cuda']}")
        if not rms <= RMS_BAR:
            raise AssertionError(f"MLP rms {rms} > {RMS_BAR}")
        if seed == 0:
            digest = hashlib.sha256()
            for ct in ex._last_outputs[0]:
                digest.update(params.to_host(ct).astype("<u4").tobytes())
            phases["digest_match"] = digest.hexdigest() == expected["output_ct_sha256"]
            log(f"[mlp] output ciphertext sha256 {digest.hexdigest()} "
                f"(JAX package: {expected['output_ct_sha256']}) "
                f"match={phases['digest_match']}")
            if not phases["digest_match"]:
                raise AssertionError("output ciphertext differs from the JAX package's")
    plain_calls = dict(ntt_mod.CALLS)

    # one ciphertext through both paths of the executor: bit-equal outputs
    vm.setInput(0, mlp.make_input(4))
    args = [vm._arg_cts[0]]
    seg, _ = ex.run_encrypted(args, jit="segment")
    per_op, _ = ex.run_encrypted(args, jit=False)
    torch.cuda.synchronize()
    phases["segment_equals_per_op"] = all(torch.equal(a, b) for a, b in zip(seg, per_op))
    log(f"[mlp] segment and per-op output ciphertexts bit-equal: "
        f"{phases['segment_equals_per_op']}")
    if not phases["segment_equals_per_op"]:
        raise AssertionError("the MLP's segment and per-op outputs differ")
    vm.jit = False
    for seed in (0, 1, 2):
        t0 = time.perf_counter()
        vm.setInput(0, mlp.make_input(seed))
        vm.run()
        vm.getOutput()
        torch.cuda.synchronize()
        phases[f"per_op_request{seed}"] = dict(seconds=time.perf_counter() - t0)
    vm.jit = "auto"
    medians = {mode: statistics.median(phases[f"{pre}request{i}"]["seconds"] for i in range(3))
               for mode, pre in (("segment", ""), ("per_op", "per_op_"))}
    phases["request_median_s"] = medians
    log(f"[mlp] request median of 3: segment {medians['segment']:.4f} s, per-op "
        f"{medians['per_op']:.4f} s")

    def request():
        vm.setInput(0, mlp.make_input(3))
        vm.run()

    # the main path's NTT calls, counted on the device; then the same request
    # per-op, where the trace's count must equal the wrapper's
    profiled = profile_request(torch, request, "profile", ex, nk, ntt_mod)
    vm.jit = False
    per_op = profile_request(torch, request, "profile per-op", ex, nk, ntt_mod)
    vm.jit = "auto"
    phases["breakdown"] = dict(profiled_request=profiled, profiled_per_op_request=per_op,
                               load_parts_s=vm.load_seconds, capture=cap)
    log("[mlp] parts of load: " + ", ".join(f"{k} {v:.3f} s"
                                            for k, v in vm.load_seconds.items()))
    for name in ("keygen", "load"):
        log(f"[mlp] {name}: {phases[name]['seconds']:.3f} s, NTT launches outside graphs "
            f"fwd {phases[name]['ntt_fwd_cuda']} inv {phases[name]['ntt_inv_cuda']}")
    launches = profiled["ntt_launches"]
    plain_calls = {k: v + profiled["plain_ntt_calls"][k] + per_op["plain_ntt_calls"][k]
                   for k, v in plain_calls.items()}
    log(f"[mlp] main path NTT calls (device) {launches}, plain NTT calls {plain_calls}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    if any(plain_calls.values()):
        raise AssertionError(f"the plain NTT ran on the main path: {plain_calls}")

    # the whole-program path (jit=True): the MLP is one window, so its one
    # graph records what its segment graph does; captured before the first
    # request (the segment graph dropped), then the ciphertext of the
    # segment / per-op comparison again, byte-equal, and three timed requests
    vm.jit = True
    t0 = time.perf_counter()
    ex.precompile_whole()
    torch.cuda.synchronize()
    wcap = dict(ex.capture_stats["whole"], capture_total_s=time.perf_counter() - t0)
    replays0 = ex.replays
    whole, _ = ex.run_encrypted(args, jit=True)
    torch.cuda.synchronize()
    w = phases["whole"] = dict(capture=wcap, path=list(ex.last_path),
                               graph_launches=ex.replays - replays0,
                               equals_segment=all(torch.equal(a, b) for a, b in zip(whole, seg)))
    times = []
    for seed in (0, 1, 2):
        t0 = time.perf_counter()
        vm.setInput(0, mlp.make_input(seed))
        vm.run()
        out = vm.getOutput()[0][:10]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rms = float(((out - mlp.mlp_plain(mlp.make_input(seed), weights)) ** 2).mean() ** 0.5)
        if not rms <= RMS_BAR:
            raise AssertionError(f"MLP rms {rms} > {RMS_BAR} on the whole-program path")
    vm.jit = "auto"
    w.update(request_s=times, request_median_s=statistics.median(times))
    log(f"[mlp] whole-program graph ({wcap['windows']} window, {wcap['nodes']} nodes) captured "
        f"in {wcap['capture_total_s']:.3f} s (warm-up {wcap['warmup_s']:.3f}, recording "
        f"{wcap['capture_s']:.3f}, instantiation {wcap['instantiate_s']:.3f}); path "
        f"{w['path']}, {w['graph_launches']} graph launch, output ciphertexts byte-equal to the "
        f"segment request's: {w['equals_segment']}; requests "
        + ", ".join(f"{t:.4f}" for t in times)
        + f" s (median {w['request_median_s']:.4f}; segment {medians['segment']:.4f})")
    if (w["path"] != ["whole", None] or w["graph_launches"] != 1 or not w["equals_segment"]
            or wcap["windows"] != 1):
        raise AssertionError(f"the MLP's whole-program path: {w}")
    return phases, launches, rms_all


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def serve_resnet(np, torch, HEVM, nk, ntt_mod, keydir):
    """ResNet-20 `dacapo 40` on tpu_n15 with the trained checkpoint, at full
    width and depth: the port traces it (its .cst must equal the JAX
    package's byte for byte), HEVM loads the committed .hevm on the keyset
    the MLP phase wrote (only the missing rotation keys are generated) and
    captures the graphs, TIMED_REQUESTS timed segmented requests are held to
    the reference's RMS bar, the last is rerun per-op with the same randomness
    and must give the same ciphertexts, and two more requests are timed by
    window and profiled."""
    from dacapo_tpu_torch.crypto.bootstrap import EmulatedBootstrapper
    from dacapo_tpu_torch.ir.serialize import function_digest
    from dacapo_tpu_torch.models import cnn_he, resnet
    with open(os.path.join(RESNET_ART, "expected.json")) as f:
        expected = json.load(f)
    out = {}
    model = resnet.get_model(RESNET_CKPT)
    t0 = time.perf_counter()
    cnn_he.trace_resnet(RESNET_TRACE, model, nt=expected["nt"])
    out["trace_s"] = time.perf_counter() - t0
    cst = os.path.join(RESNET_TRACE, "_hecate_ResNet.cst")
    out["cst_bytes"] = os.path.getsize(cst)
    out["cst_sha256"] = sha256_file(cst)
    out["eir_sha256_without_loc"] = function_digest(os.path.join(RESNET_TRACE, "ResNet.eir.json"))
    log(f"[resnet] trace {out['trace_s']:.2f} s: .cst {out['cst_bytes']} bytes sha256 "
        f"{out['cst_sha256']} (JAX package: {expected['cst_sha256']}); .eir.json "
        f"without locations {out['eir_sha256_without_loc']} "
        f"(JAX package: {expected['eir_json_sha256_without_loc']})")
    if out["cst_sha256"] != expected["cst_sha256"]:
        raise AssertionError("the port's ResNet .cst differs from the JAX package's")
    if out["eir_sha256_without_loc"] != expected["eir_json_sha256_without_loc"]:
        raise AssertionError("the port's ResNet .eir.json differs from the JAX package's")

    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    with torch.no_grad():
        want = model(x).numpy().ravel()
    if not np.allclose(want, expected["golden_logits"], rtol=0, atol=1e-9):
        raise AssertionError(f"torch model logits {want} differ from expected.json's")
    packed = cnn_he.resnet_pack_input(x.numpy(), model, nt=expected["nt"])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vm = HEVM("tpu_n15", keyset_dir=keydir, jit=True)
    torch.cuda.synchronize()
    out["keyset_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vm.load(cst, os.path.join(RESNET_ART, "ResNet.hevm"))
    out["load_s"] = time.perf_counter() - t0
    out["load_parts_s"] = vm.load_seconds
    ex = vm.executor
    if ex.streaming:
        raise AssertionError("ResNet streams its plaintexts under the card's default budget")
    out.update(instructions=len(vm.prog.ops), unique_plaintexts=ex.n_plains,
               streaming=ex.streaming, plaintext_bytes=ex.plain_bytes, galois_keys=ex.n_keys,
               galois_key_bytes=ex.key_bytes,
               after_load_bytes=torch.cuda.memory_allocated())
    cap = out["capture"] = ex.capture_stats
    out["peak_load_bytes"] = torch.cuda.max_memory_allocated()
    # the device oracle: one CUDA graph per cache key, captured by the load
    bs = ex.bootstrapper
    if not isinstance(bs, EmulatedBootstrapper) or bs.host_rng:
        raise AssertionError(f"ResNet does not bootstrap on the device oracle: {bs!r}")
    oracle = out["oracle"] = dict(graphs=len(bs._graphs), capture_s=bs.capture_s,
                                  keys=[list(k) for k in bs._graphs],
                                  load_part_s=vm.load_seconds.get("oracle_capture"))
    log(f"[resnet] device oracle: {oracle['graphs']} graphs (one per cache key "
        f"(nl, base rows, nl2): {list(bs._graphs)}), captured in {bs.capture_s:.3f} s by "
        f"the load")
    if not oracle["graphs"] or oracle["load_part_s"] is None:
        raise AssertionError("the load captured no oracle graph")
    log(f"[resnet] keyset load {out['keyset_load_s']:.3f} s; load {out['load_s']:.3f} s "
        + ", ".join(f"{k} {v:.3f} s" for k, v in vm.load_seconds.items()))
    log(f"[resnet] {out['instructions']} instructions, {ex.n_plains} unique plaintexts "
        f"{ex.plain_bytes} bytes, {ex.n_keys} galois keys {ex.key_bytes} bytes, "
        f"{out['after_load_bytes']} bytes allocated after load")
    log(f"[resnet] {cap['graphs']} graphs of {cap['windows']} windows: warm-up "
        f"{cap['warmup_s']:.3f} s, capture and instantiate {cap['capture_s']:.3f} s; peak "
        f"during load {out['peak_load_bytes']} bytes")

    # TIMED_REQUESTS timed segmented requests; the state of both generators
    # before the last one (the key generator's, which encrypts the input,
    # and the oracle's on the card) and its outputs are kept for the per-op rerun
    rng = vm.scheme.keygen.rng.bit_generator
    requests = []
    for i in range(TIMED_REQUESTS):
        reset_counts(nk, ntt_mod)
        bs.calls = 0
        replays0 = bs.replays
        torch.cuda.reset_peak_memory_stats()
        state = rng.state, bs.gen.get_state()
        t0 = time.perf_counter()
        vm.setInput(0, packed)
        vm.run()
        res = vm.getOutput()
        torch.cuda.synchronize()
        r = dict(request_s=time.perf_counter() - t0, eager_ntt_launches=dict(nk.LAUNCHES),
                 plain_ntt_calls=dict(ntt_mod.CALLS), bootstraps=bs.calls,
                 oracle_replays=bs.replays - replays0, oracle_graphs=len(bs._graphs),
                 path=list(ex.last_path), peak_bytes=torch.cuda.max_memory_allocated())
        logits = cnn_he.resnet_postprocess(res[0])
        r["rms"] = float(np.sqrt(np.mean((logits - want) ** 2)))
        r["logits"] = logits.tolist()
        requests.append(r)
        log(f"[resnet] request {i} (jit=True: {r['path']}) {r['request_s']:.3f} s: rms "
            f"{r['rms']:.4e} "
            f"(bar {RMS_BAR_RESNET}), {r['bootstraps']} bootstraps ({r['oracle_replays']} "
            f"oracle graph replays), NTT launches outside "
            f"graphs {r['eager_ntt_launches']}, plain NTT calls {r['plain_ntt_calls']}, peak "
            f"{r['peak_bytes']} bytes allocated")
        if logits.shape != (10,) or not np.isfinite(logits).all():
            raise AssertionError(f"bad ResNet output {logits!r}")
        if not r["rms"] <= RMS_BAR_RESNET:
            raise AssertionError(f"ResNet rms {r['rms']} > {RMS_BAR_RESNET}")
        if not r["bootstraps"] == r["oracle_replays"] == expected["bootstraps"]:
            raise AssertionError(f"{r['bootstraps']} bootstraps ran ({r['oracle_replays']} "
                                 f"oracle replays), the program has {expected['bootstraps']}")
        if r["oracle_graphs"] != oracle["graphs"]:
            raise AssertionError("a request captured an oracle graph the load did not")
        if r["path"] != ["segment", "oracle"]:
            raise AssertionError(f"a jit=True ResNet request took {r['path']}, not the "
                                 "segment path of the oracle bootstrap")
        if any(r["plain_ntt_calls"].values()):
            raise AssertionError(f"the plain NTT ran on the ResNet path: {r}")
        if i == TIMED_REQUESTS - 1:
            kept_state, kept_outs = state, ex._last_outputs[0]
            kept_args = [vm._arg_cts[0]]
    out["requests"] = requests
    out["request_median_s"] = statistics.median(r["request_s"] for r in requests)

    # the last timed request again per-op, with both generators restored: the
    # per-op path replays the same oracle graphs
    rng.state = kept_state[0]
    bs.gen.set_state(kept_state[1])
    vm.jit = False
    t0 = time.perf_counter()
    vm.setInput(0, packed)
    vm.run()
    vm.getOutput()
    torch.cuda.synchronize()
    vm.jit = True
    out["per_op_request_s"] = time.perf_counter() - t0
    out["segment_equals_per_op"] = all(
        torch.equal(a, b) for a, b in zip(ex._last_outputs[0], kept_outs))
    log(f"[resnet] request median of {TIMED_REQUESTS} (segment) "
        f"{out['request_median_s']:.3f} s; the "
        f"last timed request per-op {out['per_op_request_s']:.3f} s, output ciphertexts "
        f"bit-equal to the segment run: {out['segment_equals_per_op']}")
    if not out["segment_equals_per_op"]:
        raise AssertionError("ResNet segment and per-op output ciphertexts differ")

    # windows by kind: a synchronize after each window
    ex.set_profiling(True)
    vm.setInput(0, packed)
    vm.run()
    ex.set_profiling(False)
    out["windows_by_kind"] = ex.seg_report(sys.stdout)
    boot = out["windows_by_kind"].get("boot", {})
    log(f"[resnet] boot windows (oracle graph replays, a synchronize after each): "
        f"{boot.get('seconds', 0.0):.4f} s for {boot.get('windows', 0)}")

    # the profiled request also times each oracle bootstrap on the host
    # clock, between synchronizes (input copy, graph replay, output copy)
    boot_s = []
    oracle_bootstrap = bs.bootstrap

    def timed_bootstrap(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = oracle_bootstrap(*args)
        torch.cuda.synchronize()
        boot_s.append(time.perf_counter() - t0)
        return res

    def request():
        boot_s.clear()          # a lossy trace's attempt is profiled again
        vm.setInput(0, packed)
        vm.run()

    bs.bootstrap = timed_bootstrap
    try:
        prof = out["profiled_request"] = profile_request(torch, request, "resnet", ex, nk,
                                                         ntt_mod, cpu=False)
    finally:
        del bs.bootstrap
    prof["bootstrap_s"] = boot_s
    log(f"[resnet] the profiled request's {len(boot_s)} bootstraps: {sum(boot_s):.3f} s "
        f"(min {min(boot_s):.4f}, max {max(boot_s):.4f} s each)")
    launches = prof["ntt_launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel mode never ran on the ResNet path: {launches}")
    if any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the plain NTT ran on the ResNet path: {prof['plain_ntt_calls']}")
    out["batch"] = resnet_batch(np, torch, vm, model, cnn_he, expected, nk, ntt_mod,
                                out["request_median_s"])
    # what the streaming part holds its VM to: the timed request's argument,
    # oracle draws and outputs, and the resident VM's numbers
    resident = dict(cst=cst, args=kept_args, oracle_state=kept_state[1], outs=kept_outs,
                    packed=packed, want=want, expected=expected, graphs=cap["graphs"],
                    oracle_graphs=oracle["graphs"], plaintext_bytes=ex.plain_bytes,
                    request_median_s=out["request_median_s"],
                    peak_bytes=max(r["peak_bytes"] for r in requests),
                    peak_load_bytes=out["peak_load_bytes"],
                    busy_s=prof["device_busy_s"])
    return out, launches, resident


def resnet_batch(np, torch, vm, model, cnn_he, expected, nk, ntt_mod, single_median_s):
    """The batch part of the ResNet phase, on the same loaded HEVM (keys and
    plaintexts shared): precompile_batch(RESNET_BATCH) captures the batch
    graphs (the oracle's, one per cache key and B, and the segments'), then
    two timed batch requests (setInputBatch of the test images of seeds
    100.., runBatch, which decrypts) and a profiled one. Every row's RMS
    against the torch model is held to the reference's bar, a request must
    make one batched oracle graph replay per bootstrap and no plain NTT
    call. Returns the results, with the NTT batch sizes the path launched
    (NttShapes over the capture and the first request)."""
    ex, bs, nb = vm.executor, vm.executor.bootstrapper, RESNET_BATCH
    xs = [torch.randn(1, 3, 32, 32, dtype=torch.double,
                      generator=torch.Generator().manual_seed(100 + i)) for i in range(nb)]
    with torch.no_grad():
        wants = [model(x).numpy().ravel() for x in xs]
    packed = np.stack([cnn_he.resnet_pack_input(x.numpy(), model, nt=expected["nt"])
                       for x in xs])
    out = dict(batch=nb, single_request_median_s=single_median_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oracle0 = len(bs._graphs)
    shapes = NttShapes()
    shapes.start()
    try:
        t0 = time.perf_counter()
        graphs = vm.precompile_batch(nb)
        out["capture_s"] = time.perf_counter() - t0
        out.update(graphs=graphs, capture=ex.batch_capture_stats,
                   oracle_graphs=len(bs._graphs) - oracle0,
                   load_parts_s={k: vm.load_seconds.get(k) for k in
                                 ("batch_oracle_capture", "batch_capture")},
                   after_capture_bytes=torch.cuda.memory_allocated())
        log(f"[resnet batch] B={nb}: captured {graphs} segment graphs and "
            f"{out['oracle_graphs']} oracle graphs in {out['capture_s']:.3f} s "
            f"({out['load_parts_s']}; warm-up {ex.batch_capture_stats['warmup_s']:.3f} s, "
            f"capture and instantiate {ex.batch_capture_stats['capture_s']:.3f} s); "
            f"{out['after_capture_bytes']} bytes allocated")
        if not graphs or not out["oracle_graphs"]:
            raise AssertionError("the batch capture made no graph")
        requests = []
        for i in range(TIMED_REQUESTS):
            reset_counts(nk, ntt_mod)
            calls0, replays0, oracle_n = bs.calls, bs.replays, len(bs._graphs)
            t0 = time.perf_counter()
            vm.setInputBatch(0, packed)
            res = vm.runBatch()
            torch.cuda.synchronize()
            r = dict(batch_s=time.perf_counter() - t0, eager_ntt_launches=dict(nk.LAUNCHES),
                     plain_ntt_calls=dict(ntt_mod.CALLS), bootstraps=bs.calls - calls0,
                     oracle_replays=bs.replays - replays0)
            r["per_ciphertext_s"] = r["batch_s"] / nb
            logits = [cnn_he.resnet_postprocess(res[b]) for b in range(nb)]
            r["rms"] = [float(np.sqrt(np.mean((lg - w) ** 2))) for lg, w in zip(logits, wants)]
            requests.append(r)
            shapes.stop()       # recorded: the capture and the first request
            log(f"[resnet batch] request {i}: {r['batch_s']:.3f} s a batch of {nb}, "
                f"{r['per_ciphertext_s']:.3f} s a ciphertext; rms per row "
                + ", ".join(f"{v:.4e}" for v in r["rms"])
                + f" (bar {RMS_BAR_RESNET}); {r['bootstraps']} batched bootstraps, "
                f"{r['oracle_replays']} oracle graph replays; NTT launches outside graphs "
                f"{r['eager_ntt_launches']}, plain NTT calls {r['plain_ntt_calls']}")
            if any(lg.shape != (10,) or not np.isfinite(lg).all() for lg in logits):
                raise AssertionError("bad ResNet batch output")
            if not max(r["rms"]) <= RMS_BAR_RESNET:
                raise AssertionError(f"ResNet batch rms {r['rms']} > {RMS_BAR_RESNET}")
            if not r["bootstraps"] == r["oracle_replays"] == expected["bootstraps"]:
                raise AssertionError(f"{r['bootstraps']} batched bootstraps ran "
                                     f"({r['oracle_replays']} oracle replays), the program "
                                     f"has {expected['bootstraps']}")
            if len(bs._graphs) != oracle_n:
                raise AssertionError("a batch request captured an oracle graph")
            if any(r["plain_ntt_calls"].values()):
                raise AssertionError(f"the plain NTT ran on the ResNet batch path: {r}")
    finally:
        shapes.stop()
    out["ntt_batch_sizes"] = sorted(shapes.sizes)
    out["requests"] = requests
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["batch_median_s"] = statistics.median(r["batch_s"] for r in requests)
    out["per_ciphertext_median_s"] = out["batch_median_s"] / nb
    out["single_over_per_ciphertext"] = single_median_s / out["per_ciphertext_median_s"]

    def request():
        vm.setInputBatch(0, packed)
        vm.runBatch()

    prof = out["profiled_request"] = profile_request(torch, request, "resnet batch", ex, nk,
                                                     ntt_mod, cpu=False)
    log(f"[resnet batch] median {out['batch_median_s']:.3f} s a batch of {nb}, "
        f"{out['per_ciphertext_median_s']:.3f} s a ciphertext, against {single_median_s:.3f} s "
        f"a single request in this run ({out['single_over_per_ciphertext']:.2f}x); capture "
        f"{out['capture_s']:.3f} s; peak {out['peak_bytes']} bytes allocated; NTT batch sizes "
        f"{out['ntt_batch_sizes']}")
    if min(prof["ntt_launches"].values()) <= 0 or any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the profiled ResNet batch: NTT {prof['ntt_launches']}, plain "
                             f"{prof['plain_ntt_calls']}")
    return out


class DecodeShapes:
    """The NTT batch sizes (plaintexts x rows) of every plaintext decode one
    Evaluator runs between start() and stop(), the graphs' warm-ups and the
    LRU's eager decodes alike, in `sizes`. It wraps the Evaluator's
    _decode_plain and counts nothing."""

    def __init__(self, ev):
        self.ev, self.sizes = ev, set()

    def start(self):
        decode = type(self.ev)._decode_plain

        def recorded(lohi, rows):
            self.sizes.add(int(lohi.shape[0]) * len(rows))
            return decode(self.ev, lohi, rows)

        self.ev._decode_plain = recorded

    def stop(self):
        self.ev.__dict__.pop("_decode_plain", None)


def serve_resnet_streaming(np, torch, HEVM, nk, ntt_mod, keydir, resident):
    """ResNet-20 under a 10 GiB memory plan: a second HEVM("tpu_n15") on the
    same keyset, built with DACAPO_TPU_HBM_BYTES = STREAM_HBM_BYTES, loads
    the same traced .cst and .hevm after the resident VM is gone. Its
    plaintexts must stream (the compact pool) and so must its galois keys:
    the load pins their host copies and makes the key arena, and captures
    the segment graphs, each decoding its plaintexts in-graph and reading
    its keys from its arena slots, and one oracle graph. A timed request
    is held to the RMS bar, 19 oracle replays, no plain NTT and no
    capture each, every graph window replayed, the planned key copies and
    no LRU upload (no key read outside the arena), the device key bytes
    (arena and LRU) within the key budget; the resident VM's timed request
    (argument and oracle draws restored) must give the same ciphertexts on
    the segment path and per-op through the LRU; one request is profiled
    (the staging copies' device time apart), and the decode of every graph
    window of one request is profiled alone (its device time, NTT and the
    rest apart). Returns (results, NTT calls of the profiled request, the
    NTT batch sizes the decodes launched)."""
    from dacapo_tpu_torch.models import cnn_he
    expected, want, packed = resident["expected"], resident["want"], resident["packed"]
    out = dict(hbm_bytes=STREAM_HBM_BYTES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["allocated_before_bytes"] = torch.cuda.memory_allocated()
    os.environ["DACAPO_TPU_HBM_BYTES"] = str(STREAM_HBM_BYTES)
    try:
        t0 = time.perf_counter()
        vm = HEVM("tpu_n15", keyset_dir=keydir, jit=True)
        torch.cuda.synchronize()
        out["keyset_load_s"] = time.perf_counter() - t0
        shapes = DecodeShapes(vm.scheme.ev)
        shapes.start()
        t0 = time.perf_counter()
        vm.load(resident["cst"], os.path.join(RESNET_ART, "ResNet.hevm"))
        out["load_s"] = time.perf_counter() - t0
    finally:
        del os.environ["DACAPO_TPU_HBM_BYTES"]
    ex, bs = vm.executor, vm.executor.bootstrapper
    galois = vm.scheme.keys.galois
    cap = out["capture"] = ex.capture_stats
    out.update(load_parts_s=vm.load_seconds, streaming=ex.streaming, pool_bytes=ex.pool_bytes,
               plain_bytes=ex.plain_bytes, plaintext_budget_bytes=ex._pt_budget,
               resident_plaintext_bytes=resident["plaintext_bytes"],
               galois_key_bytes=ex.key_bytes, key_budget=vm.scheme.keys.galois.budget,
               oracle_graphs=len(bs._graphs), after_load_bytes=torch.cuda.memory_allocated(),
               peak_load_bytes=torch.cuda.max_memory_allocated())
    log(f"[resnet stream] DACAPO_TPU_HBM_BYTES={STREAM_HBM_BYTES}: streaming {ex.streaming}, "
        f"compact pool {ex.pool_bytes} bytes for {ex.n_plains} plaintexts (resident planes "
        f"{resident['plaintext_bytes']} bytes in the resident VM, budget {ex._pt_budget}); "
        f"galois keys {ex.key_bytes} bytes, key budget {out['key_budget']}; keyset load "
        f"{out['keyset_load_s']:.3f} s, load {out['load_s']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in vm.load_seconds.items())
        + f"); {cap['graphs']} graphs of {cap['windows']} windows decode {cap['decode_rows']} "
        f"rows a request in-graph (largest window {cap['decode_max_bytes']} bytes), "
        f"{out['oracle_graphs']} oracle graphs; {out['after_load_bytes']} bytes allocated "
        f"after load, peak {out['peak_load_bytes']}")
    out["key_arena"] = dict(slots=cap["key_slots"], bytes=cap["key_arena_bytes"],
                            copies_planned=cap["key_copies_planned"],
                            copies_lru=cap["key_copies_lru"], pinned_slabs=len(galois._slabs),
                            pinned_bytes=sum(t.nbytes for t in galois._slabs))
    log(f"[resnet stream] galois keys under the budget {out['key_budget']}: arena "
        f"{cap['key_slots']} slots ({cap['key_arena_bytes']} bytes), key copies a request "
        f"planned {cap['key_copies_planned']} (a plain LRU of as many slots: "
        f"{cap['key_copies_lru']}); host copies in {len(galois._slabs)} pinned slabs "
        f"({out['key_arena']['pinned_bytes']} bytes); key pin "
        f"{vm.load_seconds.get('key_pin', 0):.3f} s, key arena "
        f"{vm.load_seconds.get('key_arena', 0):.3f} s")
    if not ex.streaming or "compact_encode" not in vm.load_seconds:
        raise AssertionError("ResNet did not stream its plaintexts under the 10 GiB plan")
    if (out["key_budget"] != int(KEY_BUDGET_FRAC * STREAM_HBM_BYTES) or not cap["key_slots"]
            or not {"key_pin", "key_arena"} <= set(vm.load_seconds)):
        raise AssertionError(f"the 10 GiB plan did not stream ResNet's galois keys: budget "
                             f"{out['key_budget']}, {cap}")
    if cap["graphs"] != resident["graphs"] or out["oracle_graphs"] != resident["oracle_graphs"]:
        raise AssertionError(f"the streaming load captured {cap['graphs']} segment and "
                             f"{out['oracle_graphs']} oracle graphs, the resident one "
                             f"{resident['graphs']} and {resident['oracle_graphs']}")

    requests = []
    graphs = ex._captured
    for i in range(TIMED_REQUESTS_SHORT):
        reset_counts(nk, ntt_mod)
        bs.calls = 0
        replays0, seg0 = bs.replays, ex.replays
        staged0, uploads0 = dict(ex.key_staging), galois.uploads
        galois.peak_bytes = galois.device_bytes
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vm.setInput(0, packed)
        vm.run()
        res = vm.getOutput()
        torch.cuda.synchronize()
        r = dict(request_s=time.perf_counter() - t0, eager_ntt_launches=dict(nk.LAUNCHES),
                 plain_ntt_calls=dict(ntt_mod.CALLS), bootstraps=bs.calls,
                 oracle_replays=bs.replays - replays0, graph_replays=ex.replays - seg0,
                 key_copies={k: ex.key_staging[k] - staged0[k] for k in staged0},
                 lru_uploads=galois.uploads - uploads0, key_device_peak_bytes=galois.peak_bytes,
                 path=list(ex.last_path), peak_bytes=torch.cuda.max_memory_allocated())
        logits = cnn_he.resnet_postprocess(res[0])
        r["rms"] = float(np.sqrt(np.mean((logits - want) ** 2)))
        requests.append(r)
        kc = r["key_copies"]
        log(f"[resnet stream] request {i} (jit=True: {r['path']}) {r['request_s']:.3f} s: rms "
            f"{r['rms']:.4e} "
            f"(bar {RMS_BAR_RESNET}), {r['bootstraps']} bootstraps ({r['oracle_replays']} "
            f"oracle graph replays), {r['graph_replays']} segment graph replays, NTT launches "
            f"outside graphs {r['eager_ntt_launches']}, plain NTT calls "
            f"{r['plain_ntt_calls']}, peak {r['peak_bytes']} bytes; keys copied into the arena: "
            f"{kc['host']} from the host ({kc['host_bytes']} bytes), {kc['device']} from the "
            f"LRU ({kc['device_bytes']} bytes); LRU uploads {r['lru_uploads']}; device key "
            f"bytes at their peak {r['key_device_peak_bytes']} (budget {out['key_budget']})")
        if r["graph_replays"] != cap["graphs"] or r["lru_uploads"]:
            raise AssertionError(f"a streaming request left the graphs or read a key outside "
                                 f"the arena: {r['graph_replays']} of {cap['graphs']} graphs "
                                 f"replayed, {r['lru_uploads']} LRU uploads")
        if kc["host"] + kc["device"] != cap["key_copies_planned"]:
            raise AssertionError(f"a request copied {kc} keys, {cap['key_copies_planned']} "
                                 "planned")
        if r["key_device_peak_bytes"] > out["key_budget"]:
            raise AssertionError(f"device key bytes {r['key_device_peak_bytes']} passed the "
                                 f"budget {out['key_budget']}")
        if logits.shape != (10,) or not np.isfinite(logits).all():
            raise AssertionError(f"bad ResNet output {logits!r}")
        if not r["rms"] <= RMS_BAR_RESNET:
            raise AssertionError(f"streaming ResNet rms {r['rms']} > {RMS_BAR_RESNET}")
        if not r["bootstraps"] == r["oracle_replays"] == expected["bootstraps"]:
            raise AssertionError(f"{r['bootstraps']} bootstraps ran ({r['oracle_replays']} "
                                 f"oracle replays), the program has {expected['bootstraps']}")
        if any(r["plain_ntt_calls"].values()):
            raise AssertionError(f"the plain NTT ran on the streaming ResNet path: {r}")
        if ex._captured is not graphs or len(bs._graphs) != out["oracle_graphs"]:
            raise AssertionError("a streaming request captured graphs the load did not")
        if r["path"] != ["segment", "streaming"]:
            raise AssertionError(f"a jit=True streaming ResNet request took {r['path']}")
    out["requests"] = requests
    out["request_median_s"] = statistics.median(r["request_s"] for r in requests)
    out["key_h2d_bytes_per_request"] = requests[-1]["key_copies"]["host_bytes"]
    out["resident_request_median_s"] = resident["request_median_s"]
    out["peak_bytes"] = max(r["peak_bytes"] for r in requests)
    out["resident_peak_bytes"] = resident["peak_bytes"]
    out["resident_peak_load_bytes"] = resident["peak_load_bytes"]

    def rerun(path, jit):
        """The resident VM's timed request, its argument and oracle draws
        restored, on `path`."""
        bs.gen.set_state(resident["oracle_state"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = ex.run_encrypted(resident["args"], jit=jit)
        torch.cuda.synchronize()
        out[f"{path}_rerun_s"] = time.perf_counter() - t0
        out[f"{path}_equals_resident"] = all(
            torch.equal(a, b) for a, b in zip(got, resident["outs"]))
        log(f"[resnet stream] the resident VM's timed request, {path} "
            f"{out[f'{path}_rerun_s']:.3f} s: output ciphertexts bit-equal to the resident "
            f"VM's {out[f'{path}_equals_resident']}")
        if not out[f"{path}_equals_resident"]:
            raise AssertionError(f"the streaming VM's {path} outputs differ from the "
                                 "resident VM's")

    # the segment path (in-graph decode); per-op (the LRU) comes last: with
    # streaming plaintexts it drops the graphs (vm/executor.py _use_path)
    rerun("segment", "auto")

    def request():
        vm.setInput(0, packed)
        vm.run()

    prof = out["profiled_request"] = profile_request(torch, request, "resnet stream", ex, nk,
                                                     ntt_mod, cpu=False)
    launches = prof["ntt_launches"]
    if min(launches.values()) <= 0 or any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the profiled streaming request: NTT {launches}, plain "
                             f"{prof['plain_ntt_calls']}")
    out["resident_busy_s"] = resident["busy_s"]
    # the key copies into the arena, from pinned host memory
    staging = [k for k in prof["by_kernel"] if k["name"].startswith("Memcpy HtoD (Pinned")]
    out["key_staging_device_s"] = sum(k["device_s"] for k in staging)
    log(f"[resnet stream] profiled request: idle share {prof['idle_share']}, key copies "
        f"from pinned host memory {sum(k['count'] for k in staging)} taking "
        f"{out['key_staging_device_s']:.4f} s of device time")

    # the decode of one request alone: every graph window's groups, as the
    # graphs run them
    def decode_all():
        for wi in sorted(ex._captured[-1]):
            for rows, _, idx in ex._pt_groups[wi]:
                ex.ev._decode_plain(ex._pt_pool[idx], rows)

    dec = profile_request(torch, decode_all, "resnet decode", ex, nk, ntt_mod, cpu=False)
    out["decode"] = dict(
        rows=cap["decode_rows"], device_busy_s=dec["device_busy_s"],
        ntt_s=dec["ntt_kernel_s"], other_s=dec["device_busy_s"] - dec["ntt_kernel_s"],
        ntt_launches=dec["ntt_launches"], wall_s=dec["wall_s"], by_kernel=dec["by_kernel"][:12])
    rerun("per_op", False)
    out["lru"] = dict(entries=len(ex._pt_dev), device_bytes=ex._pt_dev_bytes,
                      budget=ex._pt_budget)
    out["key_device_peak_bytes"] = galois.peak_bytes
    log(f"[resnet stream] device key bytes at their peak over the phase, per-op rerun "
        f"included: {galois.peak_bytes} (budget {out['key_budget']})")
    if galois.peak_bytes > out["key_budget"]:
        raise AssertionError(f"device key bytes {galois.peak_bytes} passed the budget")
    shapes.stop()
    log(f"[resnet stream] median {out['request_median_s']:.3f} s against the resident "
        f"{resident['request_median_s']:.3f} s; device busy {prof['device_busy_s']:.4f} s "
        f"against {resident['busy_s']:.4f} s; the decode of one request alone "
        f"({cap['decode_rows']} rows): {dec['device_busy_s']:.4f} s of device time, NTT "
        f"{dec['ntt_kernel_s']:.4f} s, the rest (gathers, int64 elementwise, orbit order) "
        f"{out['decode']['other_s']:.4f} s; peak {out['peak_bytes']} bytes against the "
        f"resident {resident['peak_bytes']}; decode NTT sizes {sorted(shapes.sizes)}")
    return out, launches, sorted(shapes.sizes)


def scheme_n16(np, torch, Scheme, nk, ntt_mod, params):
    """The N=2^16 kernel on a real entry point: Scheme("tpu_n16", seed=5),
    keygen, encrypt two uniform vectors, mul (relinearise), rescale,
    decrypt; first with device="cpu", then on the card with the counts set
    to 0 just before and read just after. Keys and noise come from host
    numpy, so both runs draw the same and their ciphertexts must be equal."""
    rng = np.random.default_rng(5)
    n_slots = params.PROFILES["tpu_n16"].n_slots
    a, b = rng.uniform(-1, 1, n_slots), rng.uniform(-1, 1, n_slots)

    def run(device):
        t = {}
        t0 = time.perf_counter()
        s = Scheme("tpu_n16", seed=5, device=device)
        s.generate_keys()
        torch.cuda.synchronize()
        t["keygen_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ca, cb = s.encrypt(a), s.encrypt(b)
        c = s.rescale(s.mul(ca, cb))
        out = s.decrypt(c)
        torch.cuda.synchronize()
        t["encrypt_mul_rescale_decrypt_s"] = time.perf_counter() - t0
        return params.to_host(c.data), out, t

    ct_cpu, _, t_cpu = run("cpu")
    reset_counts(nk, ntt_mod)
    ct_gpu, out, t_gpu = run("cuda")
    launches, plain_calls = dict(nk.LAUNCHES), dict(ntt_mod.CALLS)
    rms = float(np.sqrt(np.mean((out - a * b) ** 2)))
    equal = ct_gpu.shape == ct_cpu.shape and bool((ct_gpu == ct_cpu).all())
    log(f"[n16] Scheme tpu_n16 card: keygen {t_gpu['keygen_s']:.3f} s, encrypt+mul+"
        f"rescale+decrypt {t_gpu['encrypt_mul_rescale_decrypt_s']:.3f} s; cpu: keygen "
        f"{t_cpu['keygen_s']:.3f} s, rest {t_cpu['encrypt_mul_rescale_decrypt_s']:.3f} s")
    log(f"[n16] rms {rms:.3e} (bar {RMS_BAR_N16}), ciphertext {ct_gpu.shape} equal to "
        f"the cpu run: {equal}, launches {launches}, plain NTT calls {plain_calls}")
    if not rms <= RMS_BAR_N16:
        raise AssertionError(f"tpu_n16 rms {rms} > {RMS_BAR_N16}")
    if not equal:
        raise AssertionError("tpu_n16 ciphertext on the card differs from the cpu run")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel mode never ran in the tpu_n16 phase: {launches}")
    if any(plain_calls.values()):
        raise AssertionError(f"the plain NTT ran in the tpu_n16 phase: {plain_calls}")
    return dict(rms=rms, ct_equal=equal, launches=launches, card=t_gpu, cpu=t_cpu)

def native_test_boot(np, Scheme, Ciphertext, BootstrapConfig, params):
    """(a) The test_boot bootstrap on the card (tests/test_bootstrap.py's
    call, the seed of tests/test_torch_bootstrap_native.py): its output
    ciphertext must hash to the JAX package's committed digest."""
    with open(os.path.join(TEST_BOOT_ART, "expected.json")) as f:
        expected = json.load(f)
    t0 = time.perf_counter()
    s = Scheme("test_boot", seed=6)
    s.generate_keys()
    bs = s.enable_native_bootstrap(BootstrapConfig(K=16, r=3, degree=36, baby=8))
    vals = np.random.default_rng(3).uniform(-1, 1, s.ctx.config.n_slots)
    ct = s.encrypt(vals, scale=2.0 ** 25, nl=2)
    data, (_, scale) = bs.bootstrap(ct.data, 2, ct.scale, 1)
    digest = hashlib.sha256(params.to_host(data).astype("<u4").tobytes()).hexdigest()
    rms = float(np.sqrt(np.mean((s.decrypt(Ciphertext(data, scale)) - vals) ** 2)))
    res = dict(seconds=time.perf_counter() - t0, sha256=digest, rms=rms,
               match=digest == expected["output_ct_sha256"])
    log(f"[native] test_boot bootstrap on the card: sha256 {digest} (JAX package: "
        f"{expected['output_ct_sha256']}) match={res['match']}, rms {rms:.3e}, "
        f"{res['seconds']:.2f} s")
    if not res["match"]:
        raise AssertionError("the test_boot bootstrap differs from the JAX package's")
    return res


def serve_native(np, torch, HEVM, nk, ntt_mod, params, keydir, files):
    """(c) HEVM("tpu_n15b") serves the committed deep DaCapo program with
    native bootstraps, then (b) the standalone bootstrap on the same scheme.
    Returns (results, the NTT calls of the profiled request on the device,
    those of the profiled standalone bootstrap)."""
    from types import SimpleNamespace
    from dacapo_tpu_torch.crypto.bootstrap_native import NativeBootstrapper, native_radix
    from dacapo_tpu_torch.crypto.scheme import Ciphertext
    from dacapo_tpu_torch.models.deep import deep_golden
    with open(os.path.join(NATIVE_ART, "expected.json")) as f:
        expected = json.load(f)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vm = HEVM("tpu_n15b", keyset_dir=keydir)
    torch.cuda.synchronize()
    out["keygen_s"] = time.perf_counter() - t0
    bs = vm.scheme._native_bs
    radix = native_radix(vm.scheme.ctx.config.n_slots)                # the runner's rule
    if not isinstance(bs, NativeBootstrapper) or bs.cfg.radix != radix:
        raise AssertionError(f"HEVM('tpu_n15b') built {bs!r}, not the radix-{radix} "
                             "native bootstrapper")
    t0 = time.perf_counter()
    vm.load(*files["Deep"])
    out["load_s"] = time.perf_counter() - t0
    out["load_parts_s"] = vm.load_seconds
    ex = vm.executor
    if ex.bootstrapper is not bs:
        raise AssertionError("the executor does not run the native bootstrapper")
    keys = vm.scheme.keys
    out.update(instructions=len(vm.prog.ops), galois_keys_counted=ex.n_keys,
               key_bytes_counted=ex.key_bytes, galois_keys_made=len(keys.galois),
               bootstrap_rotation_keys=len(bs.rotation_steps()),
               conj_key=keys.conj is not None, capture=ex.capture_stats,
               streaming=ex.streaming, after_load_bytes=torch.cuda.memory_allocated(),
               peak_load_bytes=torch.cuda.max_memory_allocated())
    if ex.streaming:
        raise AssertionError("the deep program streams its plaintexts under the card's "
                             "default budget")
    log(f"[native] keygen {out['keygen_s']:.3f} s; load {out['load_s']:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in vm.load_seconds.items()))
    log(f"[native] {out['instructions']} instructions; galois keys {len(keys.galois)} made "
        f"({ex.n_keys} counted, {out['bootstrap_rotation_keys']} of them the bootstrap's) + "
        f"conjugation key, {ex.key_bytes} bytes; graphs {ex.capture_stats}; "
        f"{out['after_load_bytes']} bytes allocated "
        f"after load, peak {out['peak_load_bytes']}")
    if "bootstrap_warmup" not in vm.load_seconds or len(keys.galois) != ex.n_keys:
        raise AssertionError("the load did not make the bootstrap's keys")
    out["boot_plan"] = [[wi, list(sig), why] for wi, sig, why in ex.boot_plan()]
    out["boot_capture"] = ex.capture_stats.get("boot")
    log(f"[native] bootstrap graphs captured at load: {out['boot_capture']}; boot windows "
        f"(window, signature, why eager) {out['boot_plan']}")
    if ("boot_capture" not in vm.load_seconds or not out["boot_capture"]
            or any(why is not None for *_, why in out["boot_plan"])):
        raise AssertionError("the deep program's bootstraps are not all graphs: "
                             f"{out['boot_plan']}, {vm.load_seconds}")

    x = np.random.default_rng(expected["input_seed"]).uniform(
        *expected["input_range"], vm.scheme.ctx.config.n_slots)
    want = deep_golden(x, expected["depth"])
    rng = vm.scheme.keygen.rng.bit_generator
    requests = []
    kept = dict(vm=vm, x=x, want=want, graphs=ex.capture_stats["graphs"], requests=[],
                request_median_s=None)
    for i in range(TIMED_REQUESTS_SHORT):
        reset_counts(nk, ntt_mod)
        calls0, n_keys0, ntt0 = bs.calls, len(keys.galois), graph_ntt(ex)
        torch.cuda.reset_peak_memory_stats()
        state = rng.state
        t0 = time.perf_counter()
        vm.setInput(0, x)
        vm.run()
        res = vm.getOutput()[0]
        torch.cuda.synchronize()
        r = dict(request_s=time.perf_counter() - t0, eager_ntt_launches=dict(nk.LAUNCHES),
                 ntt_launches={k: nk.LAUNCHES[k] + v - ntt0[k]
                               for k, v in graph_ntt(ex).items()},
                 plain_ntt_calls=dict(ntt_mod.CALLS), bootstraps=bs.calls - calls0,
                 boots=ex.last_bootstraps, keys_made=len(keys.galois) - n_keys0,
                 peak_bytes=torch.cuda.max_memory_allocated())
        r["rms"] = float(np.sqrt(np.mean((res - want) ** 2)))
        r["min_max"] = [float(want.min()), float(want.max())]
        requests.append(r)
        kept["requests"].append((vm._arg_cts[0], ex._last_outputs[0]))
        log(f"[native] request {i} (segment) {r['request_s']:.3f} s: rms {r['rms']:.4e} "
            f"(bar {RMS_BAR_NATIVE_DEEP}), {r['bootstraps']} native bootstraps "
            f"({r['boots']}), NTT calls {r['ntt_launches']} (launched outside graphs "
            f"{r['eager_ntt_launches']}), plain NTT calls {r['plain_ntt_calls']}, keys made "
            f"{r['keys_made']}, peak {r['peak_bytes']} bytes")
        if res.shape != x.shape or not np.isfinite(res).all():
            raise AssertionError("bad output of the deep program")
        if not r["rms"] <= RMS_BAR_NATIVE_DEEP:
            raise AssertionError(f"deep program rms {r['rms']} > {RMS_BAR_NATIVE_DEEP}")
        if r["bootstraps"] != expected["bootstraps"] or expected["bootstraps"] < 2:
            raise AssertionError(f"{r['bootstraps']} native bootstraps ran, the program "
                                 f"has {expected['bootstraps']}")
        if r["boots"] != dict(replayed=expected["bootstraps"], eager={}):
            raise AssertionError(f"the deep request's bootstraps were not all replays: "
                                 f"{r['boots']}")
        if min(r["ntt_launches"].values()) <= 0 or any(r["plain_ntt_calls"].values()):
            raise AssertionError(f"the NTT kernel did not carry the request: {r}")
        if r["keys_made"]:
            raise AssertionError("a request made keys the load should have made")
        if i == TIMED_REQUESTS_SHORT - 1:
            kept_state, kept_outs = state, ex._last_outputs[0]
    out["requests"] = requests
    out["request_median_s"] = statistics.median(r["request_s"] for r in requests)
    kept.update(state=kept_state, seg_outs=kept_outs, request_median_s=out["request_median_s"])

    rng.state = kept_state
    vm.jit = False
    t0 = time.perf_counter()
    vm.setInput(0, x)
    vm.run()
    torch.cuda.synchronize()
    vm.jit = "auto"
    out["per_op_request_s"] = time.perf_counter() - t0
    out["per_op_boots"] = ex.last_bootstraps
    out["segment_equals_per_op"] = all(
        torch.equal(a, b) for a, b in zip(ex._last_outputs[0], kept_outs))
    log(f"[native] request median of {TIMED_REQUESTS_SHORT} (segment) "
        f"{out['request_median_s']:.3f} s; the "
        f"last per-op {out['per_op_request_s']:.3f} s ({out['per_op_boots']}), output "
        f"ciphertexts bit-equal: {out['segment_equals_per_op']}")
    if not out["segment_equals_per_op"]:
        raise AssertionError("the deep program's segment and per-op outputs differ")
    if out["per_op_boots"] != dict(replayed=0, eager={"per_op": expected["bootstraps"]}):
        raise AssertionError(f"the per-op request's bootstraps: {out['per_op_boots']}")

    # the per-op request dropped the bootstrap graphs: this request captures
    # them again before its first window
    ex.set_profiling(True)
    t0 = time.perf_counter()
    vm.setInput(0, x)
    vm.run()
    torch.cuda.synchronize()
    ex.set_profiling(False)
    out["recapture_request_s"] = time.perf_counter() - t0
    out["windows_by_kind"] = ex.seg_report(sys.stdout)
    out["boot_recapture"] = ex.capture_stats.get("boot")
    log(f"[native] the segment request after the per-op one {out['recapture_request_s']:.3f} s "
        f"(windows timed apart), its bootstraps {ex.last_bootstraps}, graphs captured again "
        f"{out['boot_recapture']}")
    if ex.last_bootstraps != dict(replayed=expected["bootstraps"], eager={}):
        raise AssertionError(f"after the per-op request: {ex.last_bootstraps}")

    boot_s = []
    native = bs.bootstrap

    def timed_bootstrap(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = native(*args)
        torch.cuda.synchronize()
        boot_s.append(time.perf_counter() - t0)
        return res

    def request():
        boot_s.clear()          # a lossy trace's attempt is profiled again
        vm.setInput(0, x)
        vm.run()

    bs.bootstrap = timed_bootstrap
    try:
        prof = out["profiled_request"] = profile_request(torch, request, "native", ex, nk,
                                                         ntt_mod, cpu=False,
                                                         trace_loss_ok=True)
    finally:
        del bs.bootstrap
    prof["bootstrap_s"] = boot_s
    # the NTT calls as the native ResNet phase counts them, without a trace
    # (profile_request's ntt_counted, which the trace may not pass)
    log(f"[native] NTT calls counted by the wrapper and the graphs' records "
        f"{prof['ntt_counted']}, in the trace {prof['ntt_launches']}")
    req_launches = prof["ntt_launches"]
    if min(req_launches.values()) <= 0 or any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the profiled deep request: NTT {req_launches}, plain "
                             f"{prof['plain_ntt_calls']}")

    # (b) the standalone bootstrap on the same scheme
    torch.cuda.reset_peak_memory_stats()
    s = vm.scheme
    vals = np.random.default_rng(3).uniform(-1, 1, s.ctx.config.n_slots)
    ct = s.encrypt(vals, scale=2.0 ** s.ctx.config.scale_bits, nl=2)
    sb = out["standalone"] = {}
    times = []
    for i in range(1 + TIMED_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data, (nl2, scale) = bs.bootstrap(ct.data, 2, ct.scale, 14)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sb["first_call_s"], sb["seconds"] = times[0], times[1:]
    sb["median_s"] = statistics.median(times[1:])
    err = s.decrypt(Ciphertext(data, scale)) - vals
    sb.update(level=nl2 // s.ctx.config.rescale_rows - 1, rows=nl2,
              rms=float(np.sqrt(np.mean(err * err))), max_abs_err=float(np.abs(err).max()))
    prof_b = sb["profiled"] = profile_request(
        torch, lambda: bs.bootstrap(ct.data, 2, ct.scale, 14), "native bootstrap",
        SimpleNamespace(replays=0), nk, ntt_mod, cpu=False, trace_loss_ok=True)
    boot_launches = prof_b["ntt_launches"]
    sb.update(rotation_keys=len(bs.rotation_steps()), conjugation_key=keys.conj is not None,
              peak_bytes=torch.cuda.max_memory_allocated())
    # the same signature as a CUDA graph: capture, replays, one profiled
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    rec = bs.capture(2, ct.scale, 14)
    torch.cuda.synchronize()
    sg = sb["graph"] = dict(capture_total_s=time.perf_counter() - t0,
                            reserved_growth_bytes=torch.cuda.memory_reserved() - reserved,
                            **{k: rec[k] for k in ("warmup_s", "capture_s", "instantiate_s",
                                                   "pool_bytes", "ntt")})
    replay_s, replays0 = [], bs.replays
    for i in range(TIMED_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rdata, _ = bs.bootstrap(ct.data, 2, ct.scale, 14)
        torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t0)
    sg.update(seconds=replay_s, median_s=statistics.median(replay_s),
              replays=bs.replays - replays0, equals_eager=bool(torch.equal(rdata, data)))
    prof_g = sg["profiled"] = profile_request(
        torch, lambda: bs.bootstrap(ct.data, 2, ct.scale, 14), "native bootstrap graph",
        SimpleNamespace(replays=0, bootstrapper=bs), nk, ntt_mod, cpu=False,
        trace_loss_ok=True)
    log(f"[native] the standalone bootstrap as a CUDA graph: captured in "
        f"{sg['capture_total_s']:.3f} s (warm-up {sg['warmup_s']:.3f}, recording "
        f"{sg['capture_s']:.3f}, instantiation {sg['instantiate_s']:.3f}; pool "
        f"{sg['pool_bytes']} bytes, {sg['ntt']} NTT calls recorded), replays "
        f"{', '.join(f'{t:.3f}' for t in replay_s)} s against eager "
        f"{', '.join(f'{t:.3f}' for t in times[1:])} s; profiled replay: device busy "
        f"{prof_g['device_busy_s']} s of {prof_g['wall_s']:.4f} s (idle share "
        f"{prof_g['idle_share']}), eager: {prof_b['device_busy_s']} s of "
        f"{prof_b['wall_s']:.4f} s (idle share {prof_b['idle_share']}); byte-equal to the "
        f"eager output: {sg['equals_eager']}")
    if (not sg["equals_eager"] or sg["replays"] != TIMED_REQUESTS
            or min(prof_g["ntt_launches"].values()) <= 0
            or any(prof_g["plain_ntt_calls"].values())):
        raise AssertionError(f"the standalone bootstrap's graph: {sg}")
    log(f"[native] standalone bootstrap tpu_n15b nl=2 scale 2^{s.ctx.config.scale_bits} -> "
        f"level {sb['level']}: "
        f"rms {sb['rms']:.4e} (bar {RMS_BAR_NATIVE_BOOT}), max |err| {sb['max_abs_err']:.3e}; "
        f"first call {times[0]:.3f} s, then {', '.join(f'{t:.3f}' for t in times[1:])} s "
        f"(median {sb['median_s']:.3f}); NTT calls on the device {boot_launches}, device "
        f"kernels {prof_b['device_ops']}, idle share {prof_b['idle_share']}; "
        f"{sb['rotation_keys']} rotation keys + conjugation key; peak {sb['peak_bytes']} bytes")
    if sb["level"] != 14 or not sb["rms"] <= RMS_BAR_NATIVE_BOOT:
        raise AssertionError(f"standalone bootstrap: level {sb['level']}, rms {sb['rms']}")
    if min(boot_launches.values()) <= 0 or any(prof_b["plain_ntt_calls"].values()):
        raise AssertionError(f"the standalone bootstrap: NTT {boot_launches}, plain "
                             f"{prof_b['plain_ntt_calls']}")
    out["peak_bytes"] = max([out["peak_load_bytes"], sb["peak_bytes"]]
                            + [r["peak_bytes"] for r in requests])
    return out, req_launches, (boot_launches, prof_g["ntt_launches"]), kept


def serve_native_whole(np, torch, nk, ntt_mod, files, resident):
    """(e) the deep program on the whole-program path: the resident native VM
    set to jit=True loads it again (its bootstrapper keeps the planes it
    encoded), which captures one CUDA graph holding every window and both
    native bootstraps and no segment graph. The segment request of (c)
    again, its key generator state restored, through setInput / run /
    getOutput: the path ("whole", None), 2 bootstraps counted as replays
    inside the graph, one graph launch, output ciphertexts byte-equal to
    the segment request's (and so to its per-op rerun's), RMS; a second
    timed request, one profiled (graph launches, idle share, NTT calls on
    the device). Returns (results, the profiled request's NTT calls on the
    device, (the argument blob, the output blob) for the server of (f))."""
    from dacapo_tpu_torch.runtime.runner import serialize_ct
    out = {}
    vm, x, want = resident["vm"], resident["x"], resident["want"]
    rng = vm.scheme.keygen.rng.bit_generator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vm.jit = True
    t0 = time.perf_counter()
    vm.load(*files["Deep"])
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    ex, bs = vm.executor, vm.executor.bootstrapper
    cap = out["capture"] = ex.capture_stats["whole"]
    out.update(load_parts_s=vm.load_seconds, path_at_load=list(ex.whole_path()),
               after_load_bytes=torch.cuda.memory_allocated(),
               peak_load_bytes=torch.cuda.max_memory_allocated())
    log(f"[native whole] HEVM(jit=True) load {out['load_s']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in vm.load_seconds.items())
        + f"): one graph of {cap['windows']} windows and {cap['bootstraps']} bootstraps "
        f"(signatures {cap['signatures']}), {cap['nodes']} nodes; warm-up "
        f"{cap['warmup_s']:.3f} s, recording {cap['capture_s']:.3f} s, instantiation "
        f"{cap['instantiate_s']:.3f} s; pool {cap['pool_bytes']} bytes; NTT calls recorded "
        f"{cap['ntt_in_graphs']}; {out['after_load_bytes']} bytes allocated, peak "
        f"{out['peak_load_bytes']}")
    if ("whole_capture" not in vm.load_seconds or "capture" in vm.load_seconds
            or ex._captured[0][0] != "whole" or bs._graphs or cap["bootstraps"] != 2):
        raise AssertionError(f"the deep program's whole-program load: {vm.load_seconds}, "
                             f"{cap}")
    requests = []
    for i in range(TIMED_REQUESTS):
        if i == 0:
            rng.state = resident["state"]
        reset_counts(nk, ntt_mod)
        before = (bs.calls, bs.replays, bs.inlined, ex.replays, graph_ntt(ex))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vm.setInput(0, x)
        vm.run()
        res = vm.getOutput()[0]
        torch.cuda.synchronize()
        r = dict(request_s=time.perf_counter() - t0, path=list(ex.last_path),
                 boots=ex.last_bootstraps, bootstraps=bs.calls - before[0],
                 bootstrap_replays=bs.replays - before[1], inline=bs.inlined - before[2],
                 graph_launches=ex.replays - before[3],
                 ntt_launches={k: nk.LAUNCHES[k] + v - before[4][k]
                               for k, v in graph_ntt(ex).items()},
                 plain_ntt_calls=dict(ntt_mod.CALLS),
                 peak_bytes=torch.cuda.max_memory_allocated())
        r["rms"] = float(np.sqrt(np.mean((res - want) ** 2)))
        if i == 0:
            r["equals_segment"] = all(torch.equal(a, b) for a, b in
                                      zip(ex._last_outputs[0], resident["seg_outs"]))
            blobs = (vm.getCtxt(0), serialize_ct(ex._last_outputs[0][0],
                                                 *ex._last_outputs[1][0]))
        requests.append(r)
        log(f"[native whole] request {i} {r['request_s']:.3f} s: path {r['path']}, "
            f"{r['bootstraps']} bootstraps ({r['boots']}; {r['inline']} replayed inside the "
            f"graph), {r['graph_launches']} graph launch, NTT calls {r['ntt_launches']}, plain "
            f"NTT calls {r['plain_ntt_calls']}, rms {r['rms']:.4e}, peak {r['peak_bytes']} "
            f"bytes" + (f"; output ciphertexts byte-equal to the segment request's (and its "
                        f"per-op rerun's): {r['equals_segment']}" if i == 0 else ""))
        if (r["path"] != ["whole", None] or r["boots"] != dict(replayed=2, eager={})
                or (r["bootstraps"], r["bootstrap_replays"], r["inline"],
                    r["graph_launches"]) != (2, 2, 2, 1)):
            raise AssertionError(f"the deep whole-program request: {r}")
        if res.shape != x.shape or not np.isfinite(res).all() or not r["rms"] <= \
                RMS_BAR_NATIVE_DEEP:
            raise AssertionError(f"the deep whole-program request's output: rms {r['rms']}")
        if any(r["plain_ntt_calls"].values()) or min(r["ntt_launches"].values()) <= 0:
            raise AssertionError(f"the NTT kernel did not carry the request: {r}")
        if i == 0 and not r["equals_segment"]:
            raise AssertionError("the deep whole-program output differs from the segment "
                                 "request's")
    out["requests"] = requests
    out["request_median_s"] = statistics.median(r["request_s"] for r in requests)
    out["segment_request_median_s"] = resident["request_median_s"]

    def request():
        vm.setInput(0, x)
        vm.run()

    prof = out["profiled_request"] = profile_request(torch, request, "native whole", ex, nk,
                                                     ntt_mod, cpu=False, trace_loss_ok=True)
    log(f"[native whole] median of {TIMED_REQUESTS} {out['request_median_s']:.3f} s (segment "
        f"{resident['request_median_s']:.3f} s); profiled: {prof['graph_launch_calls']} graph "
        f"launch calls, {prof['eager_kernel_launches']} kernel launches outside graphs (the "
        f"encryption's), device busy {prof['device_busy_s']} s of {prof['wall_s']:.4f} s "
        f"(idle share {prof['idle_share']}), NTT calls on the device {prof['ntt_launches']}")
    # the counters' launches; the trace's may miss a record (profile_request)
    if (prof["replays"] != 1 or prof["graph_launch_calls"] > 1
            or min(prof["ntt_launches"].values()) <= 0
            or any(prof["plain_ntt_calls"].values())):
        raise AssertionError(f"the profiled deep whole-program request: {prof['launch_calls']}, "
                             f"NTT {prof['ntt_launches']}")
    out["peak_bytes"] = max([out["peak_load_bytes"]] + [r["peak_bytes"] for r in requests])
    return out, prof["ntt_launches"], blobs


def serve_native_whole_server(torch, server, files, blobs):
    """(f) the deep program's whole-program path in server mode, on the
    native ResNet phase's server HEVM(jit=True) (the keyset's public and
    evaluation half: it holds the deep program's keys too) before it loads
    ResNet: it loads the deep program (the warm-up of its bootstrap
    signature, the whole-program graph), receives the argument blob of
    (e)'s first request and serves it: ("whole", None), 2 inline bootstrap
    replays, one graph launch, the result blob byte-equal to the full VM's
    of (e). The executor is released before the server loads ResNet."""
    arg_blob, want_blob = blobs
    t0 = time.perf_counter()
    server.load(*files["Deep"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ex = server.executor
    bs = ex.bootstrapper
    out = dict(load_s=t1 - t0, load_parts_s=server.load_seconds,
               capture=ex.capture_stats.get("whole"))
    server.setCtxt(0, arg_blob)
    replays0, inline0 = ex.replays, bs.inlined
    t0 = time.perf_counter()
    ret = server.run()
    torch.cuda.synchronize()
    out.update(request_s=time.perf_counter() - t0, path=list(ex.last_path),
               boots=ex.last_bootstraps, graph_launches=ex.replays - replays0,
               inline=bs.inlined - inline0,
               equals_full=server.getOutputCtxt(0) == want_blob)
    log(f"[native whole server] the deep program on the ResNet phase's server (no secret "
        f"key): load {out['load_s']:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in server.load_seconds.items())
        + f"); request {out['request_s']:.3f} s: path {out['path']}, {out['boots']}, "
        f"{out['graph_launches']} graph launch; result blob byte-equal to the full VM's: "
        f"{out['equals_full']}")
    if (ret is not None or "whole_capture" not in server.load_seconds
            or out["path"] != ["whole", None] or out["boots"] != dict(replayed=2, eager={})
            or out["graph_launches"] != 1 or out["inline"] != 2 or not out["equals_full"]):
        raise AssertionError(f"the deep program's whole-program server: {out}")
    del ex, bs
    server.executor = None
    server._arg_cts.clear()
    return out


def serve_native_budget(np, torch, nk, ntt_mod, files, resident):
    """(d) the deep program under the 16 GiB plan: the resident native VM
    loads it again under DACAPO_TPU_HBM_BYTES = NATIVE_PLAN_BYTES (its
    bootstrapper, with the diagonals it encoded, is the scheme's, so the
    warm-up makes nothing new). The new executor puts the galois keys under
    a budget (their device copies go to the host), the load pins their host
    copies and makes the key arena of the graph windows; the native
    bootstraps now read their keys through the key store's LRU from pinned
    host memory. The resident VM's request ciphertext is served again
    (run_encrypted): RMS, 2 native bootstraps, every graph window
    replayed, the planned key copies, device key bytes within the budget,
    the request's peak within NATIVE_PLAN_REQUEST_PEAK_BYTES, outputs
    bit-equal to the resident executor's; the bootstraps are timed; one
    request profiled. Returns (results, the NTT calls of the profiled
    request on the device)."""
    out = dict(hbm_bytes=NATIVE_PLAN_BYTES)
    vm = resident["vm"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    os.environ["DACAPO_TPU_HBM_BYTES"] = str(NATIVE_PLAN_BYTES)
    try:
        t0 = time.perf_counter()
        vm.load(*files["Deep"])
        out["load_s"] = time.perf_counter() - t0
    finally:
        del os.environ["DACAPO_TPU_HBM_BYTES"]
    ex, bs, galois = vm.executor, vm.executor.bootstrapper, vm.scheme.keys.galois
    cap = ex.capture_stats
    out.update(load_parts_s=vm.load_seconds, key_budget=galois.budget,
               key_bytes_counted=ex.key_bytes, galois_keys=len(galois), capture=cap,
               pinned_bytes=sum(t.nbytes for t in galois._slabs or ()),
               after_load_bytes=torch.cuda.memory_allocated(),
               peak_load_bytes=torch.cuda.max_memory_allocated())
    log(f"[native budget] DACAPO_TPU_HBM_BYTES={NATIVE_PLAN_BYTES}: galois keys counted "
        f"{ex.key_bytes} bytes, key budget {galois.budget}; load {out['load_s']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in vm.load_seconds.items())
        + f"); {cap['graphs']} graphs, arena {cap['key_slots']} slots "
        f"({cap['key_arena_bytes']} bytes), {cap['key_copies_planned']} key copies a request "
        f"planned; pinned host keys {out['pinned_bytes']} bytes; {out['after_load_bytes']} "
        f"bytes allocated after load, peak {out['peak_load_bytes']}")
    if (galois.budget != int(KEY_BUDGET_FRAC * NATIVE_PLAN_BYTES) or not cap["key_slots"]
            or cap["graphs"] != resident["graphs"] or "capture" not in vm.load_seconds):
        raise AssertionError(f"the deep program under the 16 GiB plan: key budget "
                             f"{galois.budget}, {cap}, resident graphs {resident['graphs']}")

    boot_s = []
    native = bs.bootstrap

    def timed_bootstrap(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = native(*args)
        torch.cuda.synchronize()
        boot_s.append(time.perf_counter() - t0)
        return res

    bs.bootstrap = timed_bootstrap
    requests = []
    try:
        for i, (args, want_outs) in enumerate(resident["requests"]):
            reset_counts(nk, ntt_mod)
            calls0, replays0 = bs.calls, ex.replays
            staged0, uploads0 = dict(ex.key_staging), galois.uploads
            galois.peak_bytes = galois.device_bytes
            boot_s.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs, _ = ex.run_encrypted([args], jit=True)
            torch.cuda.synchronize()
            r = dict(request_s=time.perf_counter() - t0, bootstrap_s=list(boot_s),
                     path=list(ex.last_path),
                     bootstraps=bs.calls - calls0, graph_replays=ex.replays - replays0,
                     ntt_launches=dict(nk.LAUNCHES), plain_ntt_calls=dict(ntt_mod.CALLS),
                     key_copies={k: ex.key_staging[k] - staged0[k] for k in staged0},
                     lru_uploads=galois.uploads - uploads0,
                     lru_upload_bytes=(galois.uploads - uploads0) * vm.scheme.galois_key_bytes(),
                     key_device_peak_bytes=galois.peak_bytes,
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     equals_resident=all(torch.equal(a, b) for a, b in zip(outs, want_outs)))
            res = ex.decrypt_outputs()[0]
            r["rms"] = float(np.sqrt(np.mean((res - resident["want"]) ** 2)))
            requests.append(r)
            kc = r["key_copies"]
            log(f"[native budget] request {i} {r['request_s']:.3f} s: rms {r['rms']:.4e} (bar "
                f"{RMS_BAR_NATIVE_DEEP}), {r['bootstraps']} native bootstraps of "
                + ", ".join(f"{t:.3f}" for t in r["bootstrap_s"])
                + f" s, {r['graph_replays']} graph replays, keys copied into the arena "
                f"{kc['host'] + kc['device']}, LRU uploads {r['lru_uploads']} "
                f"({r['lru_upload_bytes']} bytes), device key bytes at their peak "
                f"{r['key_device_peak_bytes']}, peak {r['peak_bytes']} bytes; outputs bit-equal "
                f"to the resident VM's: {r['equals_resident']}; jit=True took {r['path']}")
            if res.shape != resident["x"].shape or not np.isfinite(res).all():
                raise AssertionError("bad output of the deep program under the budget")
            if not r["rms"] <= RMS_BAR_NATIVE_DEEP or not r["equals_resident"]:
                raise AssertionError(f"the deep program under the budget: rms {r['rms']}, "
                                     f"bit-equal to the resident VM {r['equals_resident']}")
            r["boots"] = ex.last_bootstraps
            if (r["bootstraps"] != 2 or r["graph_replays"] != cap["graphs"]
                    or r["path"] != ["segment", "key_budget"]
                    or r["boots"] != dict(replayed=0, eager={"key_budget": 2})
                    or kc["host"] + kc["device"] != cap["key_copies_planned"]):
                raise AssertionError(f"the deep program under the budget: {r}")
            if r["key_device_peak_bytes"] > galois.budget:
                raise AssertionError(f"device key bytes {r['key_device_peak_bytes']} passed "
                                     f"the budget {galois.budget}")
            if r["peak_bytes"] > NATIVE_PLAN_REQUEST_PEAK_BYTES:
                raise AssertionError(f"the request's peak {r['peak_bytes']} bytes passed "
                                     f"{NATIVE_PLAN_REQUEST_PEAK_BYTES}")
            if min(r["ntt_launches"].values()) <= 0 or any(r["plain_ntt_calls"].values()):
                raise AssertionError(f"the NTT kernel did not carry the request: {r}")
    finally:
        del bs.bootstrap
    out["requests"] = requests
    out["request_median_s"] = statistics.median(r["request_s"] for r in requests)
    out["bootstrap_median_s"] = statistics.median(t for r in requests for t in r["bootstrap_s"])
    args = resident["requests"][0][0]
    prof = out["profiled_request"] = profile_request(
        torch, lambda: ex.run_encrypted([args], jit=True), "native budget", ex, nk, ntt_mod,
        cpu=False,
        trace_loss_ok=True)
    staging = [k for k in prof["by_kernel"] if k["name"].startswith("Memcpy HtoD (Pinned")]
    out["key_upload_device_s"] = sum(k["device_s"] for k in staging)
    log(f"[native budget] median {out['request_median_s']:.3f} s, bootstrap median "
        f"{out['bootstrap_median_s']:.3f} s; profiled request: idle share "
        f"{prof['idle_share']}, key uploads from pinned host memory "
        f"{sum(k['count'] for k in staging)} taking {out['key_upload_device_s']:.4f} s of "
        "device time")
    if min(prof["ntt_launches"].values()) <= 0 or any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the profiled deep request under the budget: NTT "
                             f"{prof['ntt_launches']}, plain {prof['plain_ntt_calls']}")
    return out, prof["ntt_launches"]


def release_host_cache(torch):
    """Return the pinned host blocks PyTorch's caching host allocator keeps
    after their tensors are gone (a key budget's slabs), where this PyTorch
    has the call."""
    for name in ("_accelerator_emptyHostCache", "_host_emptyCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return True
    return False


def serve_resnet_native(np, torch, HEVM, nk, ntt_mod, params, keydir, work, deep):
    """ResNet-20 `dacapo 40` on tpu_n15b with native bootstraps, client to
    server, from the committed artifacts/resnet_dacapo40_tpu_n15b (the
    .hevm's SHA-256 and the trace's .cst, the one the ResNet phase traced,
    checked against its expected.json). A full HEVM("tpu_n15b") on the
    native phase's keyset (which holds the bootstrap's 157 rotation keys
    and the conjugation key) makes the program's missing rotation keys
    without loading it (HEVM.make_keys); the keyset is saved in two halves,
    the server's without the secret (save_keyset(parts=...); the key files
    the native phase wrote are hard-linked into it, not written again). With every VM
    of the earlier phases and the full VM freed, a server HEVM loads the
    program (no s_ntt; the load warms each bootstrap signature, which makes
    the diagonals, captures the segment graphs and the bootstrap graphs of
    the signatures whose planes the bound leaves pinned) and a client HEVM
    encrypts the golden input and ships it. The server runs the shipped
    ciphertext on the segment path, timed (its bootstraps timed apart, a
    synchronize around each, replays and eager ones apart; the per-op
    rerun of earlier PRs is gone to keep the smoke inside its time limit:
    the deep program's and SqueezeNet's per-op requests drive that path):
    the client decrypts the shipped result (RMS of the 10 logits <=
    9.5152e-4), all 18 bootstraps ran natively (the executor's bootstrapper
    is the native one, the load captured no oracle graph), the replays and
    the eager bootstraps by reason are the executor's plan (boot_plan), no
    key was made, no plain NTT ran, and the NTT calls (the wrapper's
    launches outside graphs plus what each replayed graph recorded at
    capture) are positive in both modes. Then the NTT is held to its plain version at every batch
    size the load and the requests gave it. Before the server loads ResNet
    it serves the deep program's whole-program request (deep: the compiled
    files and (e)'s blobs; serve_native_whole_server). Returns (results, the
    NTT calls of the timed request, the NTT check)."""
    from dacapo_tpu_torch.crypto import keys as keymod
    from dacapo_tpu_torch.crypto.bootstrap_native import NativeBootstrapper
    from dacapo_tpu_torch.models import cnn_he, resnet
    with open(os.path.join(RESNET_NATIVE_ART, "expected.json")) as f:
        expected = json.load(f)
    hevm = os.path.join(RESNET_NATIVE_ART, "ResNet.hevm")
    cst = os.path.join(RESNET_TRACE, "_hecate_ResNet.cst")
    out = dict(hevm_sha256=sha256_file(hevm), cst_sha256=sha256_file(cst))
    if (out["hevm_sha256"] != expected["hevm_sha256"]
            or out["cst_sha256"] != expected["cst_sha256"]):
        raise AssertionError(f"the native ResNet program or its trace differs from "
                             f"expected.json: {out}")
    model = resnet.get_model(RESNET_CKPT)
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    with torch.no_grad():
        want = model(x).numpy().ravel()
    if not np.allclose(want, expected["golden_logits"], rtol=0, atol=1e-9):
        raise AssertionError(f"torch model logits {want} differ from expected.json's")
    packed = cnn_he.resnet_pack_input(x.numpy(), model, nt=expected["nt"])

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    # the keys: the native phase's keyset, extended by a full VM
    t0 = sync()
    full = HEVM("tpu_n15b", keyset_dir=keydir)
    t1 = sync()
    made = full.make_keys(hevm)
    t2 = sync()
    halves = {}
    for half, parts in (("server", ("public", "eval")), ("client", ("secret", "public"))):
        d = halves[half] = os.path.join(work, f"resnet_n15b_{half}")
        if half == "server":
            # the keys the native phase wrote are linked, not written again
            # (the machine takes 45 GiB of writes a run); save_keyset writes
            # the rest
            os.makedirs(os.path.join(d, "galois"))
            for f in os.listdir(os.path.join(keydir, "galois")):
                os.link(os.path.join(keydir, "galois", f), os.path.join(d, "galois", f))
        keymod.save_keyset(full.scheme.keys, d, parts=parts, skip_existing=True)
        shutil.copyfile(os.path.join(keydir, "params.json"), os.path.join(d, "params.json"))
    t3 = sync()
    keys = out["keys"] = dict(
        keyset_load_s=t1 - t0, keygen_s=t2 - t1, save_s=t3 - t2, galois_keys_made=made,
        galois_keys=len(full.scheme.keys.galois), conj_key=full.scheme.keys.conj is not None,
        server_keyset_bytes=sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                                os.walk(halves["server"]) for f in fs))
    log(f"[resnet native] keys: the native phase's keyset read in {keys['keyset_load_s']:.3f} s, "
        f"{made} rotation keys made in {keys['keygen_s']:.3f} s ({keys['galois_keys']} in all "
        f"+ conjugation key), the halves saved in {keys['save_s']:.3f} s (server "
        f"{keys['server_keyset_bytes']} bytes, no secret key)")
    del full
    gc.collect()
    torch.cuda.empty_cache()
    keys["host_cache_released"] = release_host_cache(torch)
    shutil.rmtree(os.path.join(keydir, "galois"))       # the server's half holds them now

    # the server: every VM of the earlier phases and the full VM are gone
    torch.cuda.reset_peak_memory_stats()
    out["allocated_at_load_start_bytes"] = torch.cuda.memory_allocated()
    log(f"[resnet native] {out['allocated_at_load_start_bytes']} bytes allocated on the card "
        "as the server's load starts")
    t0 = sync()
    server = HEVM("tpu_n15b", keyset_dir=halves["server"], mode="server", jit=True)
    t1 = sync()
    if server.scheme.keys.s_ntt is not None:
        raise AssertionError("the server's keyset holds the secret key")
    keyset_load_s = t1 - t0
    out["deep_whole_server"] = serve_native_whole_server(torch, server, *deep)
    gc.collect()
    torch.cuda.empty_cache()
    shapes = NttShapes()        # stopped after the requests
    shapes.start()
    t1 = sync()
    server.load(cst, hevm)
    t2 = sync()
    ex = server.executor
    bs, galois = ex.bootstrapper, server.scheme.keys.galois
    planes = bs.cached_planes() if isinstance(bs, NativeBootstrapper) else {}
    conj_bytes = server.scheme.keys.conj.nbytes if server.scheme.keys.conj is not None else 0
    out.update(keyset_load_s=keyset_load_s, load_s=t2 - t1, load_parts_s=server.load_seconds,
               instructions=len(server.prog.ops), capture=ex.capture_stats,
               warmup=ex.bootstrap_stats, streaming=ex.streaming, pool_bytes=ex.pool_bytes,
               plain_bytes=ex.plain_bytes, plaintext_budget_bytes=ex._pt_budget,
               unique_plaintexts=ex.n_plains, galois_keys=len(galois),
               galois_key_bytes_counted=ex.key_bytes, key_budget=galois.budget,
               key_device_bytes=galois.device_bytes + conj_bytes, planes=planes,
               plane_budget=bs.plane_budget if isinstance(bs, NativeBootstrapper) else None,
               after_load_bytes=torch.cuda.memory_allocated(),
               peak_load_bytes=torch.cuda.max_memory_allocated())
    log(f"[resnet native] server keyset read {out['keyset_load_s']:.3f} s; load "
        f"{out['load_s']:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in
                                             server.load_seconds.items())
        + f"); {out['instructions']} instructions; {ex.n_plains} unique plaintexts, streaming "
        f"{ex.streaming} (pool {ex.pool_bytes} bytes, resident {ex.plain_bytes}, budget "
        f"{ex._pt_budget}); {len(galois)} galois keys + conjugation key, device key bytes "
        f"{out['key_device_bytes']} (counted {ex.key_bytes}, budget {galois.budget}); "
        f"bootstrap signatures warmed {ex.bootstrap_stats and ex.bootstrap_stats['signatures']}"
        f", diagonals and constants held {planes} under a bound of {out['plane_budget']} bytes "
        f"(the warm-up dropped {ex.bootstrap_stats and ex.bootstrap_stats['evictions']} "
        f"signature groups); graphs {ex.capture_stats}; "
        f"{out['after_load_bytes']} bytes allocated after load, peak {out['peak_load_bytes']}")
    if (not isinstance(bs, NativeBootstrapper)
            or dataclasses.asdict(bs.cfg) != expected["bootstrap_config"]):
        raise AssertionError(f"the server does not bootstrap natively with "
                             f"{expected['bootstrap_config']}: {bs!r}")
    if ("bootstrap_warmup" not in server.load_seconds or "capture" not in server.load_seconds
            or "oracle_capture" in server.load_seconds):
        raise AssertionError(f"the server's load: {server.load_seconds}")
    if ex.bootstrap_stats["signatures"] != expected["boot_signatures"]:
        raise AssertionError(f"the load warmed {ex.bootstrap_stats['signatures']}, "
                             f"expected.json has {expected['boot_signatures']}")
    # which boot windows replay a CUDA graph, and why each other one is eager
    plan = [[wi, list(sig), why] for wi, sig, why in ex.boot_plan()]
    planned = dict(replayed=sum(why is None for *_, why in plan), eager={})
    for *_, why in plan:
        if why is not None:
            planned["eager"][why] = planned["eager"].get(why, 0) + 1
    out.update(boot_plan=plan, boot_planned=planned, boot_capture=ex.capture_stats.get("boot"),
               planes_pinned_bytes=sum(p[2] for p in bs._pinned.values()))
    log(f"[resnet native] bootstrap graphs captured at load {out['boot_capture']}; pinned "
        f"planes {out['planes_pinned_bytes']} bytes; boot windows planned {planned}")
    if ("boot_capture" not in server.load_seconds or not planned["replayed"]
            or set(planned["eager"]) - EAGER_REASONS):
        raise AssertionError(f"the native ResNet's bootstrap graphs: {plan}")

    client = HEVM("tpu_n15b", keyset_dir=halves["client"], mode="client")
    client.loadClient(hevm)
    t0 = sync()
    client.setInput(0, packed)
    blob = client.getCtxt(0)
    out["client_encrypt_s"] = sync() - t0
    out["blob_bytes"] = len(blob)
    server.setCtxt(0, blob)

    boot_s = []
    native = bs.bootstrap

    def timed_bootstrap(*args):
        replays = bs.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = native(*args)
        torch.cuda.synchronize()
        boot_s.append((time.perf_counter() - t0, bs.replays > replays))
        return res

    bs.bootstrap = timed_bootstrap
    requests = {}
    try:
        # the segment request, on the graphs the load captured
        for kind, jit in (("timed", True),):
            reset_counts(nk, ntt_mod)
            calls0, replays0, n_keys0 = bs.calls, graph_replays(ex), len(galois)
            replayed0 = graph_ntt(ex)
            evictions0, reencodes0 = bs.evictions, bs.reencodes
            boot_s.clear()
            torch.cuda.reset_peak_memory_stats()
            server.jit = jit
            t0 = sync()
            ret = server.run()
            request_s = sync() - t0
            blobs = [server.getOutputCtxt(j) for j in range(server.prog.res_length)]
            replayed = {k: v - replayed0[k] for k, v in graph_ntt(ex).items()}
            replay_s = [t for t, rep in boot_s if rep]
            eager_s = [t for t, rep in boot_s if not rep]
            r = requests[kind] = dict(
                request_s=request_s, path=list(ex.last_path), bootstrap_s=[t for t, _ in boot_s],
                bootstrap_replayed=[rep for _, rep in boot_s],
                bootstraps_total_s=sum(t for t, _ in boot_s), replayed_s=sum(replay_s),
                eager_s=sum(eager_s), boots=ex.last_bootstraps,
                segments_and_rest_s=request_s - sum(t for t, _ in boot_s),
                bootstraps=bs.calls - calls0,
                graph_replays=graph_replays(ex) - replays0, eager_ntt_launches=dict(nk.LAUNCHES),
                graph_ntt_launches=replayed,
                ntt_launches={k: nk.LAUNCHES[k] + replayed[k] for k in replayed},
                plain_ntt_calls=dict(ntt_mod.CALLS), keys_made=len(galois) - n_keys0,
                peak_bytes=torch.cuda.max_memory_allocated(),
                key_device_bytes=galois.device_bytes + conj_bytes,
                plane_groups_dropped=bs.evictions - evictions0,
                planes_reencoded=bs.reencodes - reencodes0, planes_held=bs.cached_planes())
            t0 = sync()
            logits = cnn_he.resnet_postprocess(client.decrypt_result(blobs[0]))
            r["client_decrypt_s"] = sync() - t0
            r["rms"] = float(np.sqrt(np.mean((logits - want) ** 2)))
            r["logits"] = logits.tolist()
            span = lambda ts: f"{min(ts):.3f}-{max(ts):.3f}" if ts else "none"
            log(f"[resnet native] {kind} request (jit={jit}: {r['path']}) "
                f"{request_s:.3f} s: {r['bootstraps']} native bootstraps "
                f"{r['bootstraps_total_s']:.3f} s ({r['boots']}; replays {len(replay_s)} "
                f"{r['replayed_s']:.3f} s, each {span(replay_s)} s; eager {len(eager_s)} "
                f"{r['eager_s']:.3f} s, each {span(eager_s)} s), "
                f"the rest {r['segments_and_rest_s']:.3f} s, {r['graph_replays']} graph "
                f"replays; signature plane groups dropped {r['plane_groups_dropped']}, planes "
                f"encoded again {r['planes_reencoded']}; NTT calls {r['ntt_launches']} "
                f"({r['eager_ntt_launches']} launched "
                f"outside graphs), plain NTT calls {r['plain_ntt_calls']}; keys made "
                f"{r['keys_made']}; peak {r['peak_bytes']} bytes; client decrypt "
                f"{r['client_decrypt_s']:.3f} s, rms {r['rms']:.4e} (bar {RMS_BAR_RESNET})")
            if ret is not None:
                raise AssertionError("the server returned decrypted outputs")
            if logits.shape != (10,) or not np.isfinite(logits).all():
                raise AssertionError(f"bad native ResNet output {logits!r}")
            if not r["rms"] <= RMS_BAR_RESNET:
                raise AssertionError(f"native ResNet rms {r['rms']} > {RMS_BAR_RESNET}")
            if r["bootstraps"] != expected["bootstraps"] or len(boot_s) != r["bootstraps"]:
                raise AssertionError(f"{r['bootstraps']} native bootstraps ran, the program "
                                     f"has {expected['bootstraps']}")
            if (any(r["plain_ntt_calls"].values()) or min(r["ntt_launches"].values()) <= 0
                    or r["keys_made"]):
                raise AssertionError(f"the native ResNet request: {r}")
            if r["path"] != ["segment", "streaming"]:
                raise AssertionError(f"the {kind} request took {r['path']}")
            if r["boots"] != planned or len(replay_s) != r["boots"]["replayed"]:
                raise AssertionError(f"the {kind} request's bootstraps {r['boots']}, "
                                     f"planned {planned}")
    finally:
        del bs.bootstrap
        server.jit = True
        shapes.stop()
    out["requests"] = requests
    out["request_s"] = requests["timed"]["request_s"]
    out["peak_bytes"] = max([out["peak_load_bytes"]]
                            + [r["peak_bytes"] for r in requests.values()])
    check = batch_kernel_checks(torch, params, ntt_mod, nk, "tpu_n15b", sorted(shapes.sizes),
                                "ResNet native")
    log(f"[resnet native] timed request {out['request_s']:.3f} s (bootstraps "
        f"{requests['timed']['bootstraps_total_s']:.3f} s: {requests['timed']['boots']}, the "
        f"rest {requests['timed']['segments_and_rest_s']:.3f} s); peak "
        f"{out['peak_bytes']} bytes")
    del server, client
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(RESNET_TRACE)
    return out, requests["timed"]["ntt_launches"], check


def serve_basic(np, torch, HEVM, nk, ntt_mod, work):
    """The basic phase: the five non-MLP rows of the basic list, each served
    from a client to a server that holds no secret key and back. Per row:
    the port traces and compiles it (pars/40; the .hevm and .cst must equal
    the JAX package's digests in artifacts/basic_pars40/expected.json); a
    full HEVM on a fresh keyset directory loads it (making and persisting
    its galois keys); a client HEVM encrypts the inputs of
    examples/tests/<Name>.py and ships them; a server HEVM on the same
    directory (no s_ntt) loads the program (capturing its graphs), receives
    them and serves three timed requests and a profiled one (NTT calls
    counted on the device); the client decrypts the shipped results (RMS
    against the numpy golden <= RMS_BAR_BASIC); the full HEVM runs the same
    blobs and its result blobs must equal the server's byte for byte.
    Returns (results, NTT calls of the profiled server requests, summed)."""
    import importlib
    from dacapo_tpu_torch.runtime.harness import compile_traced
    with open(os.path.join(BASIC_ART, "expected.json")) as f:
        expected = json.load(f)["rows"]
    out = {}
    launches = {"ntt_fwd_cuda": 0, "ntt_inv_cuda": 0}
    plain_calls = {k: 0 for k in ntt_mod.CALLS}
    batch_launches = None

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    for name, row in expected.items():
        bench = importlib.import_module(f"dacapo_tpu_torch.examples.benchmarks.{name}")
        test = importlib.import_module(f"dacapo_tpu_torch.examples.tests.{name}")
        profile = row["profile"]
        if test.PROFILE != profile:
            raise AssertionError(f"{name} runs on {test.PROFILE}, expected.json says {profile}")
        r = out[name] = dict(profile=profile, pipeline=row["pipeline"],
                             waterline=row["waterline"], nt=row["nt"])
        traced = os.path.join(work, "traced")
        t0 = time.perf_counter()
        bench.trace(dirs=traced, nt=row["nt"])
        t1 = time.perf_counter()
        hevm = compile_traced(name, row["pipeline"], row["waterline"], profile, traced,
                              os.path.join(work, "optimized"))
        cst = os.path.join(traced, f"_hecate_{name}.cst")
        r.update(trace_s=t1 - t0, compile_s=time.perf_counter() - t1,
                 hevm_sha256=sha256_file(hevm), cst_sha256=sha256_file(cst))
        if r["hevm_sha256"] != row["hevm_sha256"] or r["cst_sha256"] != row["cst_sha256"]:
            raise AssertionError(f"the port's {name} program differs from the JAX "
                                 f"package's: {r}")
        inputs, golden, post = test.case(nt=row["nt"])
        keydir = tempfile.mkdtemp(prefix=f"keys_{name}_", dir=work)
        torch.cuda.reset_peak_memory_stats()

        t0 = sync()
        full = HEVM(profile, keyset_dir=keydir)
        t1 = sync()
        full.load(cst, hevm)
        t2 = sync()
        r.update(keygen_s=t1 - t0, full_load_s=t2 - t1, full_load_parts_s=full.load_seconds)

        client = HEVM(profile, keyset_dir=keydir, mode="client")
        client.loadClient(hevm)
        t0 = sync()
        for i, x in enumerate(inputs):
            client.setInput(i, x)
        blobs = [client.getCtxt(i) for i in range(len(inputs))]
        r["client_encrypt_s"] = sync() - t0
        r["blob_bytes"] = [len(b) for b in blobs]

        t0 = sync()
        server = HEVM(profile, keyset_dir=keydir, mode="server")
        t1 = sync()
        if server.scheme.keys.s_ntt is not None:
            raise AssertionError("the server's keyset holds the secret key")
        server.load(cst, hevm)
        t2 = sync()
        r.update(server_keyset_load_s=t1 - t0, server_load_s=t2 - t1,
                 server_load_parts_s=server.load_seconds,
                 graphs=server.executor.capture_stats, galois_keys=len(server.scheme.keys.galois))
        if "capture" not in server.load_seconds:
            raise AssertionError("the server's load captured no graphs")
        for i, b in enumerate(blobs):
            server.setCtxt(i, b)
        times = []
        for _ in range(3):
            reset_counts(nk, ntt_mod)
            t0 = sync()
            if server.run() is not None:
                raise AssertionError("a server returned decrypted outputs")
            times.append(sync() - t0)
            plain_calls = {k: v + ntt_mod.CALLS[k] for k, v in plain_calls.items()}
        r["request_s"] = times
        r["request_median_s"] = statistics.median(times)
        prof = r["profiled_request"] = profile_request(
            torch, server.run, f"basic {name}", server.executor, nk, ntt_mod, cpu=False)
        for k in launches:
            launches[k] += prof["ntt_launches"][k]
        plain_calls = {k: v + prof["plain_ntt_calls"][k] for k, v in plain_calls.items()}
        if min(prof["ntt_launches"].values()) <= 0:
            raise AssertionError(f"{name}: an NTT mode never ran in the server's request")
        res_blobs = [server.getOutputCtxt(j) for j in range(server.prog.res_length)]

        # the whole-program path: a server HEVM(jit=True) on the same keys,
        # whose load captures one graph; the same blobs, three timed requests
        t0 = sync()
        wserver = HEVM(profile, keyset_dir=keydir, mode="server", jit=True)
        wserver.load(cst, hevm)
        t1 = sync()
        wex = wserver.executor
        for i, b in enumerate(blobs):
            wserver.setCtxt(i, b)
        wtimes, replays0 = [], wex.replays
        for _ in range(3):
            t2 = sync()
            wserver.run()
            wtimes.append(sync() - t2)
        plain_calls = {k: v + ntt_mod.CALLS[k] for k, v in plain_calls.items()}
        w = r["whole"] = dict(
            load_s=t1 - t0, load_parts_s=wserver.load_seconds,
            capture=wex.capture_stats.get("whole"), path=list(wex.last_path),
            graph_launches=wex.replays - replays0, request_s=wtimes,
            request_median_s=statistics.median(wtimes),
            equals_segment=[wserver.getOutputCtxt(j) for j in range(
                wserver.prog.res_length)] == res_blobs)
        if (w["path"] != ["whole", None] or w["graph_launches"] != 3
                or "whole_capture" not in wserver.load_seconds or not w["equals_segment"]):
            raise AssertionError(f"{name}: the whole-program server {w}")
        del wserver, wex

        t0 = sync()
        dec = np.stack([client.decrypt_result(b) for b in res_blobs])
        r["client_decrypt_s"] = sync() - t0
        got = np.asarray(post(dec), np.float64).ravel()
        want = np.asarray(golden, np.float64).ravel()
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: bad output of shape {got.shape}")
        r["rms"] = float(np.sqrt(np.mean((got - want) ** 2)))

        for i, b in enumerate(blobs):
            full.setCtxt(i, b)
        full.run()
        r["full_equals_server"] = [full.getOutputCtxt(j) for j in range(
            full.prog.res_length)] == res_blobs
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["streaming"] = full.executor.streaming or server.executor.streaming
        if r["streaming"]:
            raise AssertionError(f"{name} streams its plaintexts under the card's default budget")
        if name == BASIC_BATCH_ROW:
            r["batch"] = basic_batch(np, torch, HEVM, full, test, row["nt"], nk, ntt_mod,
                                     keydir, cst, hevm)
            batch_launches = r["batch"]["profiled_request"]["ntt_launches"]
        log(f"[basic] {name} ({profile}, {row['pipeline']}/{row['waterline']}): .hevm "
            f"{r['hevm_sha256'][:16]}... equal to the JAX package's; keygen "
            f"{r['keygen_s']:.3f} s, full load {r['full_load_s']:.3f} s, client encrypt "
            f"{r['client_encrypt_s']:.4f} s ({sum(r['blob_bytes'])} bytes shipped), server "
            f"load {r['server_load_s']:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in server.load_seconds.items())
            + f"), {r['galois_keys']} galois keys, no secret key; requests "
            + ", ".join(f"{t:.4f}" for t in times)
            + f" s (median {r['request_median_s']:.4f}), idle share "
            f"{prof['idle_share']}, NTT calls on the device {prof['ntt_launches']}; whole-program "
            f"server (jit=True: load {w['load_s']:.3f} s, one graph of "
            f"{w['capture']['windows']} windows, {w['capture']['nodes']} nodes) requests "
            + ", ".join(f"{t:.4f}" for t in w["request_s"])
            + f" s (median {w['request_median_s']:.4f}), byte-equal: {w['equals_segment']}; client "
            f"decrypt {r['client_decrypt_s']:.4f} s, rms {r['rms']:.3e} (bar {RMS_BAR_BASIC}); "
            f"full VM on the same blobs bit-equal: {r['full_equals_server']}; peak "
            f"{r['peak_bytes']} bytes")
        if not r["rms"] <= RMS_BAR_BASIC:
            raise AssertionError(f"{name} rms {r['rms']} > {RMS_BAR_BASIC}")
        if not r["full_equals_server"]:
            raise AssertionError(f"{name}: the server's outputs differ from the full VM's")
        del full, client, server
        gc.collect()
        torch.cuda.empty_cache()
    if any(plain_calls.values()):
        raise AssertionError(f"the plain NTT ran on the basic path: {plain_calls}")
    log(f"[basic] NTT calls of the five profiled server requests, on the device: {launches}")
    if batch_launches is None:
        raise AssertionError(f"the basic phase did not serve {BASIC_BATCH_ROW} as a batch")
    return out, launches, batch_launches


def basic_batch(np, torch, HEVM, full, test, nt, nk, ntt_mod, keydir, cst, hevm):
    """The batch part of the basic phase, on the row's full HEVM (loaded,
    its keys made): BASIC_BATCH input sets (examples/tests/<Name>.py's case
    with seeds 100.., so row 0 is the phase's own input) encrypted by
    setInputBatch; precompile_batch captures the batch graphs; three timed
    batch requests and a profiled one (executor.run_encrypted_batch, the
    server's work); every row's output ciphertexts must equal a single
    request's on the same argument ciphertexts byte for byte, and runBatch's
    decrypted rows the numpy golden (RMS <= RMS_BAR_BASIC). The singles are
    timed too, for the comparison in the same run. Then the same batch on a
    streaming HEVM (`basic_batch_streamed`)."""
    ex, nb = full.executor, BASIC_BATCH
    cases = [test.case(nt=nt, seed=100 + b) for b in range(nb)]
    for i in range(len(cases[0][0])):
        full.setInputBatch(i, np.stack([c[0][i] for c in cases]))
    args = [full._arg_cts_batch[i] for i in range(len(cases[0][0]))]
    out = dict(batch=nb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shapes = NttShapes()
    shapes.start()
    try:
        t0 = time.perf_counter()
        out["graphs"] = full.precompile_batch(nb)
        out["capture_s"] = time.perf_counter() - t0
        out["capture"] = ex.batch_capture_stats
        times = []
        for i in range(3):
            reset_counts(nk, ntt_mod)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs, meta = ex.run_encrypted_batch(args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            shapes.stop()       # recorded: the capture and the first request
            if any(ntt_mod.CALLS.values()):
                raise AssertionError(f"the plain NTT ran on the basic batch path: {ntt_mod.CALLS}")
    finally:
        shapes.stop()
    outs = [o.clone() for o in outs]
    singles, equal = [], True
    for b in range(nb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one, one_meta = ex.run_encrypted([(data[b], nl, sc) for data, nl, sc in args])
        torch.cuda.synchronize()
        singles.append(time.perf_counter() - t0)
        equal &= one_meta == meta and all(torch.equal(o[b], x) for o, x in zip(outs, one))
    dec = full.runBatch()
    rms = [float(np.sqrt(np.mean((np.asarray(post(dec[b]), np.float64).ravel()
                                  - np.asarray(golden, np.float64).ravel()) ** 2)))
           for b, (_, golden, post) in enumerate(cases)]
    out.update(batch_s=times, batch_median_s=statistics.median(times), single_s=singles,
               single_median_s=statistics.median(singles), rows_equal_singles=equal, rms=rms,
               ntt_batch_sizes=sorted(shapes.sizes), peak_bytes=torch.cuda.max_memory_allocated())
    out["per_ciphertext_median_s"] = out["batch_median_s"] / nb
    out["single_over_per_ciphertext"] = out["single_median_s"] / out["per_ciphertext_median_s"]
    prof = out["profiled_request"] = profile_request(
        torch, lambda: ex.run_encrypted_batch(args), f"basic {BASIC_BATCH_ROW} batch", ex, nk,
        ntt_mod, cpu=False)
    log(f"[basic batch] {BASIC_BATCH_ROW} B={nb}: capture {out['capture_s']:.3f} s "
        f"({out['graphs']} graphs); batches " + ", ".join(f"{t:.4f}" for t in times)
        + f" s (median {out['batch_median_s']:.4f}, {out['per_ciphertext_median_s']:.4f} s a "
        f"ciphertext) against single requests of median {out['single_median_s']:.4f} s "
        f"({out['single_over_per_ciphertext']:.2f}x); rows byte-equal to the singles: {equal}; "
        f"rms per row " + ", ".join(f"{v:.3e}" for v in rms)
        + f" (bar {RMS_BAR_BASIC}); idle share {prof['idle_share']}, NTT calls on the device "
        f"{prof['ntt_launches']}; peak {out['peak_bytes']} bytes; NTT batch sizes "
        f"{out['ntt_batch_sizes']}")
    if not equal:
        raise AssertionError(f"{BASIC_BATCH_ROW}: a batch row differs from its single request")
    if not max(rms) <= RMS_BAR_BASIC or dec.shape[0] != nb:
        raise AssertionError(f"{BASIC_BATCH_ROW} batch rms {rms} > {RMS_BAR_BASIC}")
    if min(prof["ntt_launches"].values()) <= 0 or any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the profiled basic batch: NTT {prof['ntt_launches']}, plain "
                             f"{prof['plain_ntt_calls']}")
    out["streamed"] = basic_batch_streamed(torch, HEVM, full.profile, keydir, cst, hevm, args,
                                           outs, meta, nk, ntt_mod, full.executor.plain_bytes)
    # last: the mesh splits this VM's keys
    t0 = time.perf_counter()
    out["mesh"] = basic_batch_mesh(np, torch, full, cases, args, outs, meta,
                                   out["batch_median_s"], nk, ntt_mod)
    out["mesh"]["seconds"] = time.perf_counter() - t0
    return out


def basic_batch_mesh(np, torch, full, cases, args, outs, meta, none_median_s, nk, ntt_mod):
    """The basic batch over a mesh of world size 1 (parallel/mesh.py): an
    in-process NCCL group, make_mesh(1), and the row's resident full HEVM
    captures the batch graphs over it (precompile_batch(mesh=...): its keys
    split at mp = 1, every key switch's all-gather recorded into its
    window's graph); three timed batches beside the mesh=None median of this
    run, with the collectives each issued (mp all-gathers replayed in the
    graphs and eager, dp all-gathers), rows byte-equal to the mesh=None
    batch; runBatch(mesh=...)'s decrypted rows held to the RMS bar; one
    batch profiled (NTT calls on the device). The group is destroyed
    before it returns."""
    import torch.distributed as dist
    from dacapo_tpu_torch.parallel import mesh as mesh_mod
    ex, nb = full.executor, BASIC_BATCH
    key_bytes_whole = ex.key_bytes
    work = tempfile.mkdtemp(prefix="nccl_")
    t0 = time.perf_counter()
    mesh_mod.init_world(0, 1, "file://" + os.path.join(work, "init"), "cuda:0")
    try:
        mesh = mesh_mod.make_mesh(1)
        init_s = time.perf_counter() - t0
        shapes = NttShapes()
        shapes.start()
        try:
            t0 = time.perf_counter()
            graphs = full.precompile_batch(nb, mesh=mesh)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            capture = dict(ex.batch_capture_stats)
            shard = full.scheme.ev.shard
            times, collectives = [], []
            for _ in range(3):
                reset_counts(nk, ntt_mod)
                counts0 = (ex.mesh_collectives, shard.gathers, mesh.dp_gathers)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, got_meta = ex.run_encrypted_batch(args, mesh=mesh)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                collectives.append(dict(zip(
                    ("mp_in_graphs", "mp_eager", "dp"),
                    (b - a for a, b in zip(counts0, (ex.mesh_collectives, shard.gathers,
                                                     mesh.dp_gathers))))))
                shapes.stop()
                if any(ntt_mod.CALLS.values()):
                    raise AssertionError(f"the plain NTT ran on the mesh batch: {ntt_mod.CALLS}")
        finally:
            shapes.stop()
        equal = got_meta == meta and all(torch.equal(a, b) for a, b in zip(got, outs))
        dec = full.runBatch(mesh=mesh)
        rms = [float(np.sqrt(np.mean((np.asarray(post(dec[b]), np.float64).ravel()
                                      - np.asarray(golden, np.float64).ravel()) ** 2)))
               for b, (_, golden, post) in enumerate(cases)]
        prof = profile_request(torch, lambda: ex.run_encrypted_batch(args, mesh=mesh),
                               f"basic {BASIC_BATCH_ROW} mesh batch", ex, nk, ntt_mod, cpu=False)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    out = dict(world=1, dp=mesh.dp, mp=mesh.mp, init_s=init_s, graphs=graphs,
               capture_s=capture_s, capture=capture, batch_s=times,
               batch_median_s=statistics.median(times), mesh_none_median_s=none_median_s,
               collectives=collectives, collectives_in_graphs=capture["collectives"],
               rows_equal_mesh_none=equal, rms=rms, key_shard=full.scheme.keys.shard,
               key_bytes_whole=key_bytes_whole, key_bytes_rank=ex.key_bytes,
               ntt_batch_sizes=sorted(shapes.sizes), profiled_request=prof)
    out["over_mesh_none"] = out["batch_median_s"] / none_median_s
    log(f"[mesh] {BASIC_BATCH_ROW} B={nb} over make_mesh(1) (NCCL, dp {mesh.dp} x mp "
        f"{mesh.mp}, group {init_s:.3f} s): capture {capture_s:.3f} s ({graphs} graphs "
        f"recording {capture['collectives']} mp all-gathers); batches "
        + ", ".join(f"{t:.4f}" for t in times)
        + f" s (median {out['batch_median_s']:.4f} s, {out['over_mesh_none']:.3f}x the "
        f"mesh=None median {none_median_s:.4f} s); collectives a batch {collectives}; rows "
        f"byte-equal to mesh=None: {equal}; rms per row " + ", ".join(f"{v:.3e}" for v in rms)
        + f"; key bytes a rank {ex.key_bytes} (whole {key_bytes_whole}); idle share "
        f"{prof['idle_share']}, NTT calls on the device {prof['ntt_launches']}")
    if not equal:
        raise AssertionError("the mesh batch differs from the mesh=None batch")
    if not max(rms) <= RMS_BAR_BASIC or dec.shape[0] != nb:
        raise AssertionError(f"mesh batch rms {rms} > {RMS_BAR_BASIC}")
    if not graphs or capture["collectives"] <= 0 or any(
            c["mp_in_graphs"] != capture["collectives"] or c["dp"] != len(outs)
            for c in collectives):
        raise AssertionError(f"the mesh batch: {graphs} graphs, {capture['collectives']} "
                             f"all-gathers captured, collectives a batch {collectives}")
    if min(prof["ntt_launches"].values()) <= 0 or any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the profiled mesh batch: NTT {prof['ntt_launches']}, plain "
                             f"{prof['plain_ntt_calls']}")
    return out


def native_core(native):
    """The native artifact core after the phases: built from the checkout's
    source (or found built from it), and every .hevm and .cst the phases
    read and wrote went through it (its calls counted). Its read time
    against the pure-Python reader is scripts/hevm_read_timing.py's."""
    out = dict(build=dict(native.BUILD_INFO), calls=dict(native.CALLS))
    log(f"[native core] built {native.BUILD_INFO['built']} in "
        f"{native.BUILD_INFO['seconds']:.3f} s; calls {out['calls']}")
    if min(out["calls"][k] for k in ("hevm_load", "hevm_save", "cst_load", "cst_save")) <= 0:
        raise AssertionError(f"the native core: {out}")
    return out


def basic_batch_streamed(torch, HEVM, profile, keydir, cst, hevm, args, outs, meta, nk,
                         ntt_mod, resident_bytes):
    """The basic batch on a streaming HEVM, as deployed: a second VM on the
    row's keyset, built and loaded under DACAPO_TPU_HBM_BYTES =
    BASIC_PLAN_BYTES, streams its plaintexts and budgets its galois keys
    (the row's keys outweigh its plaintexts 15 to 1: every window reads all
    twelve, so its key arena holds them all, past the budget). Its batch
    graphs of BASIC_BATCH, which decode in-graph and read their keys from
    the arena, must give the resident batch's output ciphertexts byte for
    byte; one request timed, one profiled."""
    os.environ["DACAPO_TPU_HBM_BYTES"] = str(BASIC_PLAN_BYTES)
    try:
        vm = HEVM(profile, keyset_dir=keydir)
        vm.load(cst, hevm)
    finally:
        del os.environ["DACAPO_TPU_HBM_BYTES"]
    ex = vm.executor
    galois = vm.scheme.keys.galois
    if not ex.streaming or galois.budget is None or not ex.key_arena():
        raise AssertionError(f"{BASIC_BATCH_ROW} under DACAPO_TPU_HBM_BYTES="
                             f"{BASIC_PLAN_BYTES}: streaming {ex.streaming}, key budget "
                             f"{galois.budget}")
    shapes = DecodeShapes(vm.scheme.ev)
    shapes.start()
    try:
        t0 = time.perf_counter()
        graphs = vm.precompile_batch(BASIC_BATCH)
        capture_s = time.perf_counter() - t0
        reset_counts(nk, ntt_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, got_meta = ex.run_encrypted_batch(args)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    finally:
        shapes.stop()
    equal = got_meta == meta and all(torch.equal(a, b) for a, b in zip(got, outs))
    out = dict(hbm_bytes=BASIC_PLAN_BYTES, key_budget=galois.budget,
               load_parts_s=vm.load_seconds,
               resident_plaintext_bytes=resident_bytes, plaintext_budget_bytes=ex._pt_budget,
               pool_bytes=ex.pool_bytes, graphs=graphs, capture_s=capture_s,
               capture=ex.batch_capture_stats, batch_s=batch_s,
               plain_ntt_calls=dict(ntt_mod.CALLS), rows_equal_resident=equal,
               decode_ntt_sizes=sorted(shapes.sizes))
    prof = out["profiled_request"] = profile_request(
        torch, lambda: ex.run_encrypted_batch(args), f"basic {BASIC_BATCH_ROW} streamed batch",
        ex, nk, ntt_mod, cpu=False)
    cap = out["capture"]
    log(f"[basic batch] streamed under DACAPO_TPU_HBM_BYTES={BASIC_PLAN_BYTES}: galois keys "
        f"{ex.key_bytes} bytes, key budget {galois.budget}, arena {cap['key_slots']} slots "
        f"({cap['key_arena_bytes']} bytes), {cap['key_copies_planned']} key copies a request "
        f"planned")
    log(f"[basic batch] streamed: compact pool {ex.pool_bytes} bytes (resident "
        f"{resident_bytes}, budget {ex._pt_budget}); capture {capture_s:.3f} s ({graphs} "
        f"graphs, {out['capture']['decode_rows']} rows decoded in-graph a request); a batch "
        f"{batch_s:.4f} s; rows byte-equal to the resident batch: {equal}; NTT calls on the "
        f"device {prof['ntt_launches']}; decode NTT sizes {out['decode_ntt_sizes']}")
    if not equal:
        raise AssertionError(f"{BASIC_BATCH_ROW}: the streamed batch differs from the resident")
    if not graphs or any(out["plain_ntt_calls"].values()) or any(
            prof["plain_ntt_calls"].values()) or min(prof["ntt_launches"].values()) <= 0:
        raise AssertionError(f"the streamed basic batch: {graphs} graphs, NTT "
                             f"{prof['ntt_launches']}, plain {out['plain_ntt_calls']}")
    return out


def profile_ops(torch, nk, ntt_mod):
    """The profile phase: runtime/profiler.py measures tpu_n14's per-op,
    per-level latency table on the card (CUDA events, median of 10) into
    OUT_DIR; ir/config.load_profile reads it back; every row must be
    positive and nondecreasing. Returns (results, NTT launches)."""
    from dacapo_tpu_torch.ir.config import load_profile
    from dacapo_tpu_torch.runtime.profiler import card_name, profile_backend
    reset_counts(nk, ntt_mod)
    t0 = time.perf_counter()
    path = profile_backend("tpu_n14", out_path=os.path.join(
        OUT_DIR, f"profiled_{card_name(torch.device('cuda'))}_tpu_n14.json"), iters=10)
    seconds = time.perf_counter() - t0
    launches, plain = dict(nk.LAUNCHES), dict(ntt_mod.CALLS)
    cfg = load_profile(path)
    with open(path) as f:
        table = json.load(f)["latencyTable"]
    bad = {k: row for k, row in table.items()
           if not (all(v > 0 for v in row) and row == sorted(row))}
    top = cfg.level_upper
    rows = {k: cfg.latency_of(op, single, top) for k, op, single in (
        ("mul_double", "mul", False), ("rotate_single", "rotate", True),
        ("rescale_single", "rescale", True))}
    log(f"[profile] tpu_n14 table in {seconds:.2f} s -> {path} (runtime {cfg.runtime!r}); at "
        f"the top level {top}: " + ", ".join(f"{k} {v} us" for k, v in rows.items())
        + f"; NTT launches {launches}, plain NTT calls {plain}")
    for k in ("earth.mul_double", "earth.rotate_single", "earth.rescale_single"):
        log(f"[profile]   {k}: {table[k]}")
    if bad:
        raise AssertionError(f"profile rows not positive and nondecreasing: {bad}")
    if min(launches.values()) <= 0 or any(plain.values()):
        raise AssertionError(f"the profile phase: NTT {launches}, plain {plain}")
    return dict(seconds=seconds, path=os.path.relpath(path, REPO), top_level=top,
                top_level_us=rows, table=table, launches=launches), launches


NATIVE_N16_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "deep_dacapo40_tpu_n16")


def serve_native_n16(np, torch, HEVM, nk, ntt_mod, params, keydir):
    """The native_n16 phase: native bootstrapping on the 128-bit-secure
    N = 2^16 profile. HEVM("tpu_n16") (full mode; the native bootstrapper
    with radix 8, K 25 and degree 40, bootstrap_native.native_config) on a
    fresh keyset loads the committed artifacts/deep_dacapo40_tpu_n16 (the
    deep circuit at depth 6, one bootstrap to level 11, compiled by the JAX
    compiler against profiled_TPU_n16_native.json; its .hevm and .cst by
    SHA-256): the load makes the ~400 galois keys and the planes in its
    warm-up, keeps the keys in memory (save_keys=False: nothing on disk) and
    captures the segment graphs and the bootstrap's graph. Then
    TIMED_REQUESTS timed segment requests, one profiled (NTT calls of each
    mode on the device), the same request per op (jit=False) and on the
    whole-program path (jit=True: one CUDA graph with the bootstrap inline,
    captured as HEVM(jit=True).load does; ("whole", None)), each of these
    with the key generator's state restored, so each encrypts the same
    ciphertext. Each: RMS against deep_golden <= 1e-4, the bootstrap count
    of expected.json (replayed or eager, and why, as the executor's plan
    says), no key made, no plain NTT call, the NTT kernel in both modes (the
    wrapper's launches plus the replayed graphs' records); the outputs
    byte-equal. Then the NTT at every batch size the phase launched,
    bit-equal to the plain NTT in both modes. Returns
    (results, the profiled request's NTT calls on the device, the NTT
    check)."""
    from dacapo_tpu_torch.crypto.bootstrap_native import NativeBootstrapper, native_config
    from dacapo_tpu_torch.models.deep import deep_golden
    with open(os.path.join(NATIVE_N16_ART, "expected.json")) as f:
        expected = json.load(f)
    cst, hevm = (os.path.join(NATIVE_N16_ART, f"Deep.{x}") for x in ("cst", "hevm"))
    out = dict(hevm_sha256=sha256_file(hevm), cst_sha256=sha256_file(cst))
    if (out["hevm_sha256"] != expected["hevm_sha256"]
            or out["cst_sha256"] != expected["cst_sha256"]):
        raise AssertionError(f"the tpu_n16 program differs from expected.json: {out}")

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    t0 = sync()
    # the keys stay in memory: the smoke's machine takes 45 GiB of writes a
    # run, the earlier phases' keysets ~30 of them, and this keyset is ~35 GB
    # (scripts/torch_bootstrap_n16.py times writing it)
    vm = HEVM("tpu_n16", keyset_dir=keydir, save_keys=False)
    out["keygen_s"] = sync() - t0
    bs = vm.scheme._native_bs
    cfg = vm.scheme.ctx.config
    if (not isinstance(bs, NativeBootstrapper) or bs.cfg != native_config(cfg)
            or dataclasses.asdict(bs.cfg) != expected["bootstrap_config"]
            or bs.rows_left() != expected["bootstrap_rows_left"]):
        raise AssertionError(f"HEVM('tpu_n16') built {bs!r}, not {expected['bootstrap_config']}")
    shapes = NttShapes()        # stopped after the last request
    shapes.start()
    try:
        t0 = sync()
        vm.load(cst, hevm)
        out["load_s"] = sync() - t0
        ex = vm.executor
        keys = vm.scheme.keys
        planes = bs.cached_planes()
        out.update(load_parts_s=vm.load_seconds, instructions=len(vm.prog.ops),
                   galois_keys=len(keys.galois), galois_keys_counted=ex.n_keys,
                   key_bytes_counted=ex.key_bytes, key_budget=keys.galois.budget,
                   conj_key=keys.conj is not None, warmup=ex.bootstrap_stats, planes=planes,
                   plane_budget=bs.plane_budget, capture=ex.capture_stats,
                   streaming=ex.streaming, after_load_bytes=torch.cuda.memory_allocated(),
                   peak_load_bytes=torch.cuda.max_memory_allocated(),
                   keyset_bytes=sum(os.path.getsize(os.path.join(r, f))
                                    for r, _, fs in os.walk(keydir) for f in fs))
        log(f"[native n16] keygen {out['keygen_s']:.3f} s; load {out['load_s']:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in vm.load_seconds.items())
            + f"); {out['instructions']} instructions; {len(keys.galois)} galois keys + "
            f"conjugation key ({ex.n_keys} counted, {ex.key_bytes} bytes, budget "
            f"{keys.galois.budget}); keyset on disk {out['keyset_bytes']} bytes; bootstrap "
            f"signatures warmed {ex.bootstrap_stats['signatures']}, planes {planes} under a "
            f"bound of {bs.plane_budget} bytes; graphs {ex.capture_stats}; "
            f"{out['after_load_bytes']} bytes allocated after load, peak "
            f"{out['peak_load_bytes']}")
        plan_keys = expected["plan"]
        want_planes = expected["plan"]["planes_after_signature"][-1]
        if (ex.bootstrap_stats["signatures"] != expected["boot_signatures"]
                or len(keys.galois) != plan_keys["galois_keys"] - 1 or keys.conj is None
                or {k: planes[k] for k in ("diagonals", "diagonal_bytes", "constants",
                                           "constant_bytes")}
                != {k: want_planes[k] for k in ("diagonals", "diagonal_bytes", "constants",
                                                "constant_bytes")}):
            raise AssertionError(f"the tpu_n16 load made {len(keys.galois)} keys and {planes}; "
                                 f"expected.json's plan: {expected['plan']}")
        if (ex.streaming or keys.galois.budget is not None or out["keyset_bytes"]
                or not {"bootstrap_warmup", "capture", "boot_capture"} <= set(vm.load_seconds)):
            raise AssertionError(f"the tpu_n16 load: {vm.load_seconds}, streaming "
                                 f"{ex.streaming}, key budget {keys.galois.budget}")
        plan = out["boot_plan"] = [[wi, list(sig), why] for wi, sig, why in ex.boot_plan()]
        if any(why is not None for *_, why in plan):
            raise AssertionError(f"the tpu_n16 program's bootstraps are not all graphs: {plan}")

        x = np.random.default_rng(expected["input_seed"]).uniform(*expected["input_range"],
                                                                  cfg.n_slots)
        want = deep_golden(x, expected["depth"])
        rng = vm.scheme.keygen.rng.bit_generator
        state, first = rng.state, None

        def request(kind, want_path, want_boots):
            nonlocal first
            rng.state = state           # every request encrypts the same ciphertext
            reset_counts(nk, ntt_mod)
            calls0, n_keys0, ntt0 = bs.calls, len(keys.galois), graph_ntt(vm.executor)
            launches0 = vm.executor.replays
            torch.cuda.reset_peak_memory_stats()
            t0 = sync()
            vm.setInput(0, x)
            vm.run()
            res = vm.getOutput()[0]
            e = vm.executor
            r = dict(request_s=sync() - t0, path=list(e.last_path), boots=e.last_bootstraps,
                     bootstraps=bs.calls - calls0, graph_launches=e.replays - launches0,
                     eager_ntt_launches=dict(nk.LAUNCHES),
                     ntt_launches={k: nk.LAUNCHES[k] + v - ntt0[k]
                                   for k, v in graph_ntt(e).items()},
                     plain_ntt_calls=dict(ntt_mod.CALLS), keys_made=len(keys.galois) - n_keys0,
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     rms=float(np.sqrt(np.mean((res - want) ** 2))))
            outs = [c.clone() for c in e._last_outputs[0]]
            if first is None:
                first = outs
            r["equals_first"] = all(torch.equal(a, b) for a, b in zip(outs, first))
            log(f"[native n16] {kind} request {r['request_s']:.3f} s: path {r['path']}, "
                f"{r['bootstraps']} native bootstraps ({r['boots']}), {r['graph_launches']} "
                f"graph launches, NTT calls {r['ntt_launches']} (launched outside graphs "
                f"{r['eager_ntt_launches']}), plain NTT calls {r['plain_ntt_calls']}, keys made "
                f"{r['keys_made']}, rms {r['rms']:.4e} (bar {expected['rms_bar']}), peak "
                f"{r['peak_bytes']} bytes; output ciphertexts byte-equal to the first "
                f"request's: {r['equals_first']}")
            if res.shape != x.shape or not np.isfinite(res).all():
                raise AssertionError(f"bad output of the tpu_n16 program ({kind})")
            if not r["rms"] <= expected["rms_bar"]:
                raise AssertionError(f"tpu_n16 deep program rms {r['rms']} > "
                                     f"{expected['rms_bar']} ({kind})")
            if (r["path"] != want_path or r["bootstraps"] != expected["bootstraps"]
                    or r["boots"] != want_boots):
                raise AssertionError(f"the tpu_n16 {kind} request: path {r['path']}, "
                                     f"bootstraps {r['bootstraps']} {r['boots']}")
            if (min(r["ntt_launches"].values()) <= 0 or any(r["plain_ntt_calls"].values())
                    or r["keys_made"] or not r["equals_first"]):
                raise AssertionError(f"the tpu_n16 {kind} request: {r}")
            return r

        n_boot = expected["bootstraps"]
        replayed = dict(replayed=n_boot, eager={})
        requests = out["requests"] = [request(f"segment {i}", ["segment", None], replayed)
                                      for i in range(TIMED_REQUESTS)]
        out["request_median_s"] = statistics.median(r["request_s"] for r in requests)

        def profiled():
            vm.setInput(0, x)
            vm.run()

        prof = out["profiled_request"] = profile_request(torch, profiled, "native n16", ex, nk,
                                                         ntt_mod, cpu=False,
                                                         trace_loss_ok=True)
        if min(prof["ntt_launches"].values()) <= 0 or any(prof["plain_ntt_calls"].values()):
            raise AssertionError(f"the profiled tpu_n16 request: NTT {prof['ntt_launches']}, "
                                 f"plain {prof['plain_ntt_calls']}")

        vm.jit = False
        out["per_op"] = request("per-op", ["per_op", None],
                                dict(replayed=0, eager={"per_op": n_boot}))
        # the whole-program path (jit=True): its one graph, with the
        # bootstrap inline, captured as HEVM(jit=True).load does
        # (precompile_whole), in the segment graphs' place
        vm.jit = True
        if ex.whole_path() != ("whole", None):
            raise AssertionError(f"the tpu_n16 program's whole path: {ex.whole_path()}")
        t0 = sync()
        ex.precompile_whole()
        out["whole_capture_s"] = sync() - t0
        out["whole_capture"] = ex.capture_stats.get("whole")
        log(f"[native n16] whole-program graph captured in {out['whole_capture_s']:.3f} s: "
            f"{out['whole_capture']}")
        out["whole"] = request("whole-program", ["whole", None], replayed)
        if out["whole"]["graph_launches"] != 1:
            raise AssertionError(f"the tpu_n16 whole-program request: {out['whole']}")
    finally:
        shapes.stop()
        vm.jit = "auto"
    out["peak_bytes"] = max([out["peak_load_bytes"]] + [r["peak_bytes"] for r in requests]
                            + [out["per_op"]["peak_bytes"], out["whole"]["peak_bytes"]])
    log(f"[native n16] segment median of {TIMED_REQUESTS} {out['request_median_s']:.3f} s, "
        f"per op {out['per_op']['request_s']:.3f} s, whole program "
        f"{out['whole']['request_s']:.3f} s; the three byte-equal; profiled: device busy "
        f"{prof['device_busy_s']} s of {prof['wall_s']:.4f} s (idle share "
        f"{prof['idle_share']}), NTT calls on the device {prof['ntt_launches']}; peak "
        f"{out['peak_bytes']} bytes")
    del vm, ex, bs, keys
    gc.collect()
    torch.cuda.empty_cache()
    check = batch_kernel_checks(torch, params, ntt_mod, nk, "tpu_n16", sorted(shapes.sizes),
                                "native n16")
    return out, prof["ntt_launches"], check


SQUEEZENET_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts",
                              "squeezenet_dacapo40_tpu_n15b")
SQUEEZENET_TRACE = os.path.join(REPO, "traced", "squeezenet_torch")     # gitignored


def meminfo():
    """The host's MemTotal and MemAvailable (bytes, /proc/meminfo) and this
    process's resident bytes (VmRSS, /proc/self/status)."""
    out = {}
    for path, names in (("/proc/meminfo", ("MemTotal", "MemAvailable")),
                        ("/proc/self/status", ("VmRSS",))):
        with open(path) as f:
            for line in f:
                name, _, rest = line.partition(":")
                if name in names:
                    out[name] = int(rest.split()[0]) * 1024
    return out


def squeezenet_program(np, torch, prefix):
    """The program a squeezenet_native phase serves, traced by the port into
    SQUEEZENET_TRACE: (expected.json's entry, .cst, .hevm, packed input,
    reference outputs (the exact-float simulation's, one array per result),
    the torch model's outputs packed alike, postprocess). The whole network
    (prefix False): the 10 logits, the simulation's from expected.json. Its
    prefix (expected.json's "prefix": conv_1, avgpool_1 and the first Fire
    modules at full width): every slot of each output ciphertext, the
    simulation's run here (vm/simulate.py, held to expected.json's digest),
    the torch model's activations packed by the output shapes' OutPack
    (mpcb's "OP")."""
    from dacapo_tpu_torch.examples.benchmarks.SqueezeNet import trace, get_model
    from dacapo_tpu_torch.ir.serialize import read_cst
    from dacapo_tpu_torch.models import cnn_he
    from dacapo_tpu_torch.runtime.harness import trace_and_save
    from dacapo_tpu_torch.vm.hevm import HEVMProgram
    from dacapo_tpu_torch.vm.simulate import simulate
    with open(os.path.join(SQUEEZENET_ART, "expected.json")) as f:
        full = json.load(f)
    want = full["prefix"] if prefix else full
    name = "SqueezeNetPrefix" if prefix else "SqueezeNet"
    nt = full["nt"]
    model = get_model()
    t0 = time.perf_counter()
    if prefix:
        fires = want["fires"]
        trace_and_save(name, "c", lambda x: cnn_he.squeezenet_prefix_he_forward(
            x, model, fires=fires, nt=nt), SQUEEZENET_TRACE)
    else:
        trace(dirs=SQUEEZENET_TRACE, nt=nt, model=model)
    trace_s = time.perf_counter() - t0
    cst = os.path.join(SQUEEZENET_TRACE, f"_hecate_{name}.cst")
    hevm = os.path.join(SQUEEZENET_ART, f"{name}.hevm")
    got = dict(hevm_sha256=sha256_file(hevm), cst_sha256=sha256_file(cst))
    if any(got[k] != want[k] for k in got):
        raise AssertionError(f"the {name} program or its trace differs from "
                             f"expected.json: {got}")
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    packed = cnn_he.cnn_pack_input(x.numpy(), model.conv_1.Conv2d, nt=nt)
    with torch.no_grad():
        if not prefix:
            logits = model(x).numpy().ravel()
            if not np.allclose(logits, full["golden_logits"], rtol=0, atol=1e-9):
                raise AssertionError(f"torch model logits {logits} differ from "
                                     "expected.json's")
            return (want, cst, hevm, packed, [np.asarray(full["simulated_logits"])], [logits],
                    lambda res: [cnn_he.resnet_postprocess(res[0])], trace_s)
        act = cnn_he.squeezenet_prefix_torch(x, model, fires=want["fires"]).numpy()
    golden = list(cnn_he.makeClose(cnn_he.squeezenet_prefix_shapes(
        model, fires=want["fires"], nt=nt))["OP"](act))
    sim = simulate(HEVMProgram.load(hevm), read_cst(cst), [packed], "tpu_n15b",
                   steer="global")
    ref = [np.asarray(v) for v, _ in sim.outputs]
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(v).tobytes() for v in ref))
    if digest.hexdigest() != want["simulated_outputs_sha256"]:
        raise AssertionError("the prefix's simulation differs from expected.json's")
    return want, cst, hevm, packed, ref, golden, lambda res: list(res), trace_s


def serve_squeezenet_native(np, torch, HEVM, nk, ntt_mod, params, keydir, prefix=False):
    """A squeezenet_native phase: SqueezeNet `dacapo 40` (the first model of
    the deep list; the deterministic-random weights of
    examples/benchmarks/SqueezeNet.py) served encrypted on tpu_n15b with
    native bootstraps, its galois keys streamed from the host. prefix False:
    the whole network (conv_1, eight Fire modules, conv_10, 10 pooled
    logits), the committed artifacts/squeezenet_dacapo40_tpu_n15b/
    SqueezeNet.hevm, on the card's own memory plan (734 keys, 57.7 GB, past
    the 55 % key budget); scripts/torch_squeezenet_native.py runs it. prefix
    True: its first part at full width (squeezenet_program),
    SqueezeNetPrefix.hevm, under expected.json's DACAPO_TPU_HBM_BYTES plan,
    which puts its keys past the key budget as the whole network's are on
    the card; chip_smoke.py serves it. Each: the .hevm and the port's trace
    (.cst) by SHA-256; the host's memory read before the first key (where it
    cannot hold the keyset of expected.json's dry plan the run stops with
    both numbers); a full HEVM("tpu_n15b", save_keys=False) on a fresh
    keyset (nothing written) whose load makes the keys into pinned host
    slabs, the graph windows reading theirs from the key arena and the native
    bootstraps through the LRU; the bootstrap's planes get no room beside the
    keys (plane bound 0: only the running signature's group stays); the
    plaintexts stream from the compact pool. The input encrypted once, then
    one timed segment request (the default jit="auto": every bootstrap eager
    for "key_budget"), one profiled (device busy and idle share, NTT calls of
    each mode on the device) and one per op (jit=False; it drops the
    graphs). Each: RMS of the outputs against the exact-float simulation's
    at most expected.json's bar, against the torch model reported beside it;
    the bootstrap count, each bootstrap's seconds, key uploads and planes
    encoded again; no key made after the load; no plain NTT call; the NTT in
    both modes (the wrapper's launches plus the replayed graphs' records);
    the output ciphertexts byte-equal to the segment request's. Then the
    NTT at every batch size the phase launched, bit-equal to the plain NTT in
    both modes. Returns (results, the timed request's NTT calls, the NTT
    check)."""
    from dacapo_tpu_torch.crypto.bootstrap_native import NativeBootstrapper, native_config
    tag = "[squeezenet prefix]" if prefix else "[squeezenet]"

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    expected, cst, hevm, packed, ref, golden, post, trace_s = squeezenet_program(
        np, torch, prefix)
    out = dict(trace_s=trace_s)
    dry = expected["plan"]
    hbm = expected.get("hbm_bytes")
    env0 = os.environ.get("DACAPO_TPU_HBM_BYTES")
    if hbm is not None:
        os.environ["DACAPO_TPU_HBM_BYTES"] = str(hbm)

    # the host holds the keyset: read its memory before the first key
    release_host_cache(torch)
    host0 = out["host_before_keys"] = meminfo()
    log(f"{tag} traced in {trace_s:.2f} s; host memory before the keys: {host0}; the dry "
        f"plan's keyset {dry['key_bytes']} bytes ({dry['galois_keys']} keys of "
        f"{dry['key_bytes_each']} B); memory plan {hbm or 'the card'}")
    if host0["MemAvailable"] < dry["key_bytes"]:
        raise AssertionError(f"the host cannot hold the keyset: {host0['MemAvailable']} "
                             f"bytes available, the keyset takes {dry['key_bytes']}")
    torch.cuda.reset_peak_memory_stats()
    t0 = sync()
    vm = HEVM("tpu_n15b", keyset_dir=keydir, save_keys=False)
    out["base_keygen_s"] = sync() - t0
    bs = vm.scheme._native_bs
    if (not isinstance(bs, NativeBootstrapper) or bs.cfg != native_config(vm.scheme.ctx.config)
            or dataclasses.asdict(bs.cfg) != expected["bootstrap_config"]):
        raise AssertionError(f"HEVM('tpu_n15b') built {bs!r}, not "
                             f"{expected['bootstrap_config']}")
    shapes = NttShapes()        # stopped after the last request
    shapes.start()
    boots = []
    native = bs.bootstrap
    try:
        t0 = sync()
        vm.load(cst, hevm)
        out["load_s"] = sync() - t0
        ex = vm.executor
        keys = vm.scheme.keys
        galois = keys.galois
        kb = vm.scheme.galois_key_bytes()
        planes = bs.cached_planes()
        host1 = out["host_after_load"] = meminfo()
        out.update(load_parts_s=vm.load_seconds, instructions=len(vm.prog.ops),
                   galois_keys=len(galois), galois_keys_counted=ex.n_keys,
                   key_bytes_counted=ex.key_bytes, key_budget=galois.budget,
                   key_device_bytes=galois.device_bytes, key_slots=ex.key_arena(),
                   pinned_slabs=len(galois._slabs or ()),
                   pinned_slab_bytes=sum(s.nbytes for s in galois._slabs or ()),
                   warmup=ex.bootstrap_stats, planes=planes, plane_budget=bs.plane_budget,
                   capture=ex.capture_stats, streaming=ex.streaming,
                   unique_plaintexts=ex.n_plains, plain_bytes=ex.plain_bytes,
                   pool_bytes=ex.pool_bytes, plaintext_budget_bytes=ex._pt_budget,
                   after_load_bytes=torch.cuda.memory_allocated(),
                   peak_load_bytes=torch.cuda.max_memory_allocated(),
                   keyset_files=sum(len(fs) for _, _, fs in os.walk(keydir)))
        log(f"{tag} base keys {out['base_keygen_s']:.3f} s; load {out['load_s']:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in vm.load_seconds.items())
            + f"); {out['instructions']} instructions; {len(galois)} galois keys + conjugation "
            f"key ({ex.n_keys} counted, {ex.key_bytes} bytes, budget {galois.budget}; "
            f"{out['pinned_slabs']} pinned slabs, {out['pinned_slab_bytes']} bytes; "
            f"{out['key_slots']} arena slots, device key bytes {out['key_device_bytes']}); "
            f"{ex.n_plains} unique plaintexts, streaming {ex.streaming} (pool {ex.pool_bytes}, "
            f"resident {ex.plain_bytes}, budget {ex._pt_budget}); bootstrap signatures "
            f"warmed {len(ex.bootstrap_stats['signatures'])}, planes {planes} under a bound of "
            f"{bs.plane_budget} bytes; graphs {ex.capture_stats}; {out['after_load_bytes']} "
            f"bytes allocated after load, peak {out['peak_load_bytes']}; host after the load "
            f"{host1}")
        if (ex.bootstrap_stats["signatures"] != expected["boot_signatures"]
                or len(galois) != dry["galois_keys"] - 1 or keys.conj is None
                or ex.n_keys + 1 != dry["galois_keys"]):
            raise AssertionError(f"{tag} the load made {len(galois)} keys, warmed "
                                 f"{ex.bootstrap_stats['signatures']}; expected.json: "
                                 f"{dry['galois_keys']} keys, {expected['boot_signatures']}")
        if (galois.budget is None or bs.plane_budget != 0 or out["keyset_files"]
                or ex.streaming != dry["plaintexts_stream"]
                or ex.n_plains != dry["unique_plaintexts"]
                or not {"galois_keygen", "key_pin", "bootstrap_warmup", "key_arena",
                        "capture"} <= set(vm.load_seconds)
                or "boot_capture" in vm.load_seconds):
            raise AssertionError(f"{tag} the load: {vm.load_seconds}, key budget "
                                 f"{galois.budget}, plane bound {bs.plane_budget}, streaming "
                                 f"{ex.streaming}, {out['keyset_files']} keyset files")
        plan = out["boot_plan"] = [[wi, list(sig), why] for wi, sig, why in ex.boot_plan()]
        if len(plan) != expected["bootstraps"] or any(why != "key_budget"
                                                      for *_, why in plan):
            raise AssertionError(f"{tag} the boot windows: {plan}")

        def timed_bootstrap(data, nl, sc, target):
            up0, re0, ev0 = galois.uploads, bs.reencodes, bs.evictions
            t0 = sync()
            res = native(data, nl, sc, target)
            boots.append(dict(s=sync() - t0, signature=[nl, sc, target],
                              key_uploads=galois.uploads - up0,
                              key_upload_bytes=(galois.uploads - up0) * kb,
                              planes_reencoded=bs.reencodes - re0,
                              groups_dropped=bs.evictions - ev0))
            return res

        bs.bootstrap = timed_bootstrap
        t0 = sync()
        vm.setInput(0, packed)
        out["encrypt_s"] = sync() - t0
        first = None

        def rms(a, b):
            return float(np.sqrt(np.mean((np.concatenate(a) - np.concatenate(b)) ** 2)))

        def request(kind, jit, want_boots):
            nonlocal first
            vm.jit = jit
            reset_counts(nk, ntt_mod)
            calls0, n_keys0, ntt0 = bs.calls, len(galois), graph_ntt(ex)
            up0, staged0 = galois.uploads, dict(ex.key_staging)
            re0, ev0, replays0 = bs.reencodes, bs.evictions, ex.replays
            boots.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = sync()
            vm.run()
            request_s = sync() - t0
            res = post(vm.getOutput())
            outs = [c.clone() for c in ex._last_outputs[0]]
            if first is None:
                first = outs
            r = dict(
                request_s=request_s, path=list(ex.last_path), boots=ex.last_bootstraps,
                bootstraps=bs.calls - calls0, bootstrap_s=sum(b["s"] for b in boots),
                per_bootstrap=list(boots), graph_replays=ex.replays - replays0,
                eager_ntt_launches=dict(nk.LAUNCHES),
                ntt_launches={k: nk.LAUNCHES[k] + v - ntt0[k]
                              for k, v in graph_ntt(ex).items()},
                plain_ntt_calls=dict(ntt_mod.CALLS), keys_made=len(galois) - n_keys0,
                key_uploads=galois.uploads - up0,
                key_upload_bytes=(galois.uploads - up0) * kb,
                key_staging={k: v - staged0[k] for k, v in ex.key_staging.items()},
                planes_reencoded=bs.reencodes - re0, plane_groups_dropped=bs.evictions - ev0,
                peak_bytes=torch.cuda.max_memory_allocated(),
                key_device_bytes_peak=galois.peak_bytes,
                rms_vs_simulation=rms(res, ref), rms_vs_torch=rms(res, golden),
                equals_segment=all(torch.equal(a, b) for a, b in zip(outs, first)))
            if not prefix:
                r["logits"] = res[0].tolist()
            r["rest_s"] = request_s - r["bootstrap_s"]
            span = lambda v: f"{min(v):.3f}-{max(v):.3f}" if v else "none"
            log(f"{tag} {kind} request (jit={jit}: {r['path']}) {request_s:.3f} s: "
                f"{r['bootstraps']} native bootstraps {r['bootstrap_s']:.3f} s ({r['boots']}; "
                f"each {span([b['s'] for b in boots])} s), the rest {r['rest_s']:.3f} s, "
                f"{r['graph_replays']} graph replays; key uploads {r['key_uploads']} "
                f"({r['key_upload_bytes']} bytes; arena copies {r['key_staging']}); plane "
                f"groups dropped {r['plane_groups_dropped']}, planes encoded again "
                f"{r['planes_reencoded']}; NTT calls {r['ntt_launches']} (launched outside "
                f"graphs {r['eager_ntt_launches']}), plain NTT calls {r['plain_ntt_calls']}; "
                f"keys made {r['keys_made']}; peak {r['peak_bytes']} bytes; rms "
                f"{r['rms_vs_simulation']:.4e} against the simulation (bar "
                f"{expected['rms_bar']}), {r['rms_vs_torch']:.4e} against the torch model "
                f"(the simulation's {expected['simulated_rms_vs_torch']:.4e}); output "
                f"ciphertexts byte-equal to the segment request's: {r['equals_segment']}")
            for i, b in enumerate(boots):
                log(f"{tag}   bootstrap {i}: {b['s']:.3f} s, signature "
                    f"{b['signature'][0]} rows 2^{np.log2(b['signature'][1]):.6f} -> level "
                    f"{b['signature'][2]}, key uploads {b['key_uploads']} "
                    f"({b['key_upload_bytes']} B), planes encoded again "
                    f"{b['planes_reencoded']}, groups dropped {b['groups_dropped']}")
            if (len(res) != len(ref) or any(a.shape != b.shape for a, b in zip(res, ref))
                    or not all(np.isfinite(a).all() for a in res)):
                raise AssertionError(f"{tag} bad output ({kind})")
            if not r["rms_vs_simulation"] <= expected["rms_bar"] or (
                    prefix and not r["rms_vs_torch"] <= expected["rms_bar"]):
                raise AssertionError(f"{tag} rms {r['rms_vs_simulation']} against the "
                                     f"simulation, {r['rms_vs_torch']} against the torch "
                                     f"model, bar {expected['rms_bar']} ({kind})")
            want_path = ["per_op", None] if jit is False else ["segment", None]
            if (r["path"] != want_path or r["bootstraps"] != expected["bootstraps"]
                    or r["boots"] != want_boots or len(boots) != r["bootstraps"]):
                raise AssertionError(f"{tag} the {kind} request: path {r['path']}, "
                                     f"bootstraps {r['bootstraps']} {r['boots']}")
            if (min(r["ntt_launches"].values()) <= 0 or any(r["plain_ntt_calls"].values())
                    or r["keys_made"] or not r["equals_segment"]):
                raise AssertionError(f"{tag} the {kind} request: {r}")
            return r

        n_boot = expected["bootstraps"]
        segment = dict(replayed=0, eager={"key_budget": n_boot})
        requests = out["requests"] = {}
        requests["segment"] = request("segment", "auto", segment)

        def profiled():
            boots.clear()
            vm.run()

        prof = out["profiled_request"] = profile_request(torch, profiled, tag[1:-1], ex, nk,
                                                         ntt_mod, cpu=False, trace_loss_ok=True)
        res = post(vm.getOutput())
        prof.update(path=list(ex.last_path), boots=ex.last_bootstraps,
                    planes_reencoded=sum(b["planes_reencoded"] for b in boots),
                    key_uploads=sum(b["key_uploads"] for b in boots),
                    key_upload_bytes=sum(b["key_upload_bytes"] for b in boots),
                    rms_vs_simulation=rms(res, ref), rms_vs_torch=rms(res, golden),
                    equals_segment=all(torch.equal(a, b)
                                       for a, b in zip(ex._last_outputs[0], first)))
        log(f"{tag} profiled request: {prof['boots']}, planes encoded again "
            f"{prof['planes_reencoded']}, key uploads {prof['key_uploads']} "
            f"({prof['key_upload_bytes']} B), rms {prof['rms_vs_simulation']:.4e}, byte-equal "
            f"{prof['equals_segment']}")
        if (min(prof["ntt_launches"].values()) <= 0 or any(prof["plain_ntt_calls"].values())
                or prof["boots"] != segment or prof["path"] != ["segment", None]
                or not prof["equals_segment"]
                or not prof["rms_vs_simulation"] <= expected["rms_bar"]):
            raise AssertionError(f"{tag} the profiled request: NTT {prof['ntt_launches']}, "
                                 f"plain {prof['plain_ntt_calls']}, {prof['boots']}, path "
                                 f"{prof['path']}, rms {prof['rms_vs_simulation']}")
        requests["per_op"] = request("per-op", False, dict(replayed=0, eager={"per_op": n_boot}))
    finally:
        bs.__dict__.pop("bootstrap", None)
        shapes.stop()
        vm.jit = "auto"
        if hbm is not None:
            if env0 is None:
                os.environ.pop("DACAPO_TPU_HBM_BYTES")
            else:
                os.environ["DACAPO_TPU_HBM_BYTES"] = env0
    out["host_after_requests"] = meminfo()
    out["request_s"] = requests["segment"]["request_s"]
    out["peak_bytes"] = max([out["peak_load_bytes"]]
                            + [r["peak_bytes"] for r in requests.values()])
    log(f"{tag} segment request {out['request_s']:.3f} s (bootstraps "
        f"{requests['segment']['bootstrap_s']:.3f} s), per op "
        f"{requests['per_op']['request_s']:.3f} s; the three byte-equal; profiled: device "
        f"busy {prof['device_busy_s']} s of {prof['wall_s']:.4f} s (idle share "
        f"{prof['idle_share']}), NTT calls on the device {prof['ntt_launches']}; peak "
        f"{out['peak_bytes']} bytes")
    del vm, ex, bs, keys, galois, first
    gc.collect()
    torch.cuda.empty_cache()
    out["host_cache_released"] = release_host_cache(torch)
    shutil.rmtree(SQUEEZENET_TRACE)
    # the card is empty again: the plain NTT is timed at the largest size too
    check = batch_kernel_checks(torch, params, ntt_mod, nk, "tpu_n15b", sorted(shapes.sizes),
                                tag[1:-1], plain_up_to=None)
    return out, requests["segment"]["ntt_launches"], check


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "dacapo_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)       # the profile phase writes its table there
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.crypto import ntt as ntt_mod, params
    from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig
    from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext
    from dacapo_tpu_torch.crypto.cuda import ntt_kernel as nk
    from dacapo_tpu_torch.models import mlp

    card = card_line()
    nvcc = sh([nk._nvcc(), "--version"]).splitlines()
    log(f"[env] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvcc: {nvcc[-1] if nvcc else 'unavailable'} | python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    nk.build()
    log(f"[build] ntt.cu: {time.perf_counter() - t0:.2f} s -> {nk.BUILD_INFO['library']}")
    for line in nk.BUILD_INFO.get("nvcc_output", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")

    from dacapo_tpu_torch.vm import native as hevm_core
    t1 = time.perf_counter()
    hevm_core.build()
    log(f"[build] hevm_core.cpp: {time.perf_counter() - t1:.2f} s -> "
        f"{hevm_core.BUILD_INFO['library']}")
    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    results, max_err = kernel_checks(torch, params, ntt_mod, nk)
    seconds["kernel_checks"] = time.perf_counter() - t0
    report = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  ntt={m: {f"{p}/B={b}": v for (p, b), v in r.items()}
                       for m, r in results.items()})
    by_path = {}     # path -> NTT launches of each mode (kernel name -> count)
    marks = [time.perf_counter()]       # where the running phase's current part began
    part_seconds = {}

    def timed(name, fn, *args):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = marks[0] = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[time] {name}: {seconds[name]:.1f} s")
        return out

    # the programs the MLP and native phases serve, compiled by the port, and
    # the basic phase's work (removed at exit by the finalizer)
    work = tempfile.TemporaryDirectory(prefix="hevm_smoke_")
    files, report["compile"] = timed("compile", compile_programs,
                                     os.path.join(work.name, "compiled"))
    # one tpu_n15 keyset: the MLP phase generates it, the ResNet phase adds
    # the rotation keys the MLP lacks
    with tempfile.TemporaryDirectory(prefix="hevm_keys_") as keydir:
        report["mlp"], by_path["mlp_tpu_n15"], report["rms"] = timed(
            "mlp", serve_mlp, np, torch, HEVM, mlp, nk, ntt_mod, params, keydir, files)
        report["resnet"], by_path["resnet_tpu_n15_request"], resident = timed(
            "resnet", serve_resnet, np, torch, HEVM, nk, ntt_mod, keydir)
        report["resnet_streaming"], by_path["resnet_streaming_tpu_n15_request"], \
            resnet_decode_sizes = timed("resnet_streaming", serve_resnet_streaming, np, torch,
                                        HEVM, nk, ntt_mod, keydir, resident)
        del resident
    resnet_batch_out = report["resnet"]["batch"]
    by_path[f"resnet_tpu_n15_batch{RESNET_BATCH}_request"] = \
        resnet_batch_out["profiled_request"]["ntt_launches"]
    report["scheme_tpu_n16"] = timed("tpu_n16", scheme_n16, np, torch, Scheme, nk, ntt_mod,
                                     params)
    by_path["scheme_tpu_n16"] = report["scheme_tpu_n16"]["launches"]

    def lap(name):
        """Seconds of a part of a phase, since the last lap or the phase's start."""
        now = time.perf_counter()
        part_seconds[name] = now - marks[0]
        marks[0] = now
        log(f"[time]   {name}: {part_seconds[name]:.1f} s")

    deep_whole = {}         # what the native ResNet phase's server serves first

    def native(kd):
        out = dict(test_boot=native_test_boot(np, Scheme, Ciphertext, BootstrapConfig, params))
        out["tpu_n15b"], by_path["native_deep_tpu_n15b_request"], \
            (by_path["native_bootstrap_tpu_n15b"], by_path["native_bootstrap_graph_tpu_n15b"]), \
            kept = serve_native(np, torch, HEVM, nk, ntt_mod, params, kd, files)
        lap("native_segment")
        out["tpu_n15b_whole"], by_path["native_deep_whole_tpu_n15b_request"], blobs = \
            serve_native_whole(np, torch, nk, ntt_mod, files, kept)
        lap("native_whole")
        out["tpu_n15b_budget"], by_path["native_deep_keystream_tpu_n15b_request"] = \
            serve_native_budget(np, torch, nk, ntt_mod, files, kept)
        lap("native_budget")
        del kept
        deep_whole.update(files=files, blobs=blobs)
        return out

    # one tpu_n15b keyset: the native phase generates it (the bootstrap's
    # keys among them), the native ResNet phase, the last, adds ResNet's
    # rotation keys
    keys_n15b = tempfile.TemporaryDirectory(prefix="hevm_keys_n15b_")
    report["native"] = timed("native", native, keys_n15b.name)
    report["basic"], by_path["basic_server_requests"], \
        by_path[f"basic_{BASIC_BATCH_ROW}_batch{BASIC_BATCH}_request"] = timed(
            "basic", serve_basic, np, torch, HEVM, nk, ntt_mod,
            os.path.join(work.name, "basic"))
    # the NTT at every batch size the two batch paths launched
    basic_batch_out = report["basic"][BASIC_BATCH_ROW]["batch"]
    by_path[f"basic_{BASIC_BATCH_ROW}_streamed_batch{BASIC_BATCH}_request"] = \
        basic_batch_out["streamed"]["profiled_request"]["ntt_launches"]
    by_path[f"basic_{BASIC_BATCH_ROW}_mesh_batch{BASIC_BATCH}_request"] = \
        basic_batch_out["mesh"]["profiled_request"]["ntt_launches"]
    # and every batch size the plaintext decodes launched
    report["ntt_batch"] = timed("batch_kernel_checks", lambda: {
        f"resnet_tpu_n15_B{RESNET_BATCH}": batch_kernel_checks(
            torch, params, ntt_mod, nk, "tpu_n15", resnet_batch_out["ntt_batch_sizes"],
            f"ResNet B={RESNET_BATCH}"),
        f"{BASIC_BATCH_ROW}_tpu_n14_B{BASIC_BATCH}": batch_kernel_checks(
            torch, params, ntt_mod, nk, "tpu_n14", basic_batch_out["ntt_batch_sizes"],
            f"{BASIC_BATCH_ROW} B={BASIC_BATCH}"),
        "resnet_decode_tpu_n15": batch_kernel_checks(
            torch, params, ntt_mod, nk, "tpu_n15", resnet_decode_sizes, "ResNet decode"),
        f"{BASIC_BATCH_ROW}_decode_tpu_n14": batch_kernel_checks(
            torch, params, ntt_mod, nk, "tpu_n14",
            basic_batch_out["streamed"]["decode_ntt_sizes"], f"{BASIC_BATCH_ROW} decode")})
    report["profile"], by_path["profile_tpu_n14"] = timed(
        "profile", profile_ops, torch, nk, ntt_mod)
    report["resnet_native"], by_path["resnet_native_tpu_n15b_server_request"], \
        report["ntt_batch"]["resnet_native_tpu_n15b"] = timed(
            "resnet_native", serve_resnet_native, np, torch, HEVM, nk, ntt_mod, params,
            keys_n15b.name, work.name, (deep_whole["files"], deep_whole["blobs"]))
    keys_n15b.cleanup()
    # SqueezeNet's prefix on tpu_n15b, every earlier VM freed, under the
    # memory plan that streams its keys from pinned host memory (the whole
    # network: scripts/torch_squeezenet_native.py)
    with tempfile.TemporaryDirectory(prefix="hevm_keys_squeezenet_") as keys_sq:
        report["squeezenet_native"], by_path["squeezenet_prefix_tpu_n15b_request"], \
            report["ntt_batch"]["squeezenet_prefix_tpu_n15b"] = timed(
                "squeezenet_native", serve_squeezenet_native, np, torch, HEVM, nk, ntt_mod,
                params, keys_sq, True)
    # the native bootstrap at N = 2^16 on its own keyset (~35 GB written by
    # the full VM's load), every earlier VM freed
    with tempfile.TemporaryDirectory(prefix="hevm_keys_n16_") as keys_n16:
        report["native_n16"], by_path["native_deep_tpu_n16_request"], \
            report["ntt_batch"]["native_tpu_n16"] = timed(
                "native_n16", serve_native_n16, np, torch, HEVM, nk, ntt_mod, params, keys_n16)
    report["native_core"] = native_core(hevm_core)
    log("[time] phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    log("[time] parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in part_seconds.items()))

    per_ct = {f"resnet_tpu_n15_batch{RESNET_BATCH}_request": RESNET_BATCH,
              f"basic_{BASIC_BATCH_ROW}_batch{BASIC_BATCH}_request": BASIC_BATCH,
              f"basic_{BASIC_BATCH_ROW}_streamed_batch{BASIC_BATCH}_request": BASIC_BATCH,
              f"basic_{BASIC_BATCH_ROW}_mesh_batch{BASIC_BATCH}_request": BASIC_BATCH}
    kernels = []
    for mode, name, line in (("fwd", "ntt_fwd_cuda", 94), ("inv", "ntt_inv_cuda", 110)):
        r = results[mode][("tpu_n15", 112)]
        n15b = {f"B={b}": results[mode][("tpu_n15b", b)] for b in (120, 240)}
        oracle = {f"B={b}": results[mode][("tpu_n15", b)] for b in (3, 28, 84)}
        n14 = {f"B={b}": results[mode][("tpu_n14", b)] for b in BASIC_TIMED_N14}
        shape_checks = report["ntt_batch"]
        batch_shapes = {path: dict(largest_B=r["largest"], checked_B=r["checked"],
                                   max_abs_err=r["max_abs_err"][mode], **r[mode])
                        for path, r in shape_checks.items()}
        kernels.append(dict(
            name=name, route="cuda", source="dacapo_tpu_torch/csrc/ntt.cu",
            replaces=f"dacapo_tpu/crypto/pallas/ntt_kernel.py:{line}",
            launches=by_path["resnet_tpu_n15_request"][name],
            max_abs_err=max(max_err[mode], *(b["max_abs_err"][mode]
                                             for b in shape_checks.values())),
            ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape="B=112, N=2^15 (ModUp batch at tpu_n15)",
            launches_counted=("NTT calls the device ran in one profiled request of each "
                              "path (ntt_pass kernels in the trace, graph replays "
                              "included; the basic path: the five rows' server requests "
                              "summed); tpu_n16 and the profile phase (no graphs): the "
                              "wrapper's count; the native ResNet and SqueezeNet requests: "
                              "the wrapper's launches plus the replayed graphs' capture "
                              "records"),
            launches_by_path={k: v[name] for k, v in by_path.items()},
            launches_per_ciphertext={k: v[name] / per_ct.get(k, 1) for k, v in by_path.items()},
            batch_shapes=batch_shapes,
            native_shapes_tpu_n15b=n15b, oracle_shapes_tpu_n15=oracle,
            basic_shapes_tpu_n14=n14))
    report.update(phase_seconds=seconds, part_seconds=part_seconds, kernels=kernels)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
