#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dacapo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the environment (card, power limit, torch, CUDA, nvcc);
2. builds the hand-written CUDA NTT kernel (csrc/ntt.cu) from the checkout;
3. holds both kernel modes and the round trip against the plain PyTorch
   NTT on the card, bit for bit, at the shapes of the MLP path at tpu_n15
   (N=2^15), at N=2^11, at test_n8 (N=2^8) and at the rescale / ModUp
   shapes of tpu_n16 (N=2^16), and times them (device time by CUDA events,
   L2 flushed before each run, median of 25);
4. serves the committed MLP artifact (pars/40, tpu_n15) through
   HEVM.load / setInput / run / getOutput for three requests on a freshly
   generated keyset, on the default segment path (load captures one CUDA
   graph per window), checks each RMS against the numpy model and the first
   output ciphertext against the JAX package's digest, and that the plain
   NTT never ran; then runs one ciphertext through executor.run_encrypted
   with jit="segment" and jit=False and requires bit-equal outputs, and
   times three requests per-op (jit=False) for the other median;
5. profiles one more segmented request (device time by kernel, device
   kernels, kernels per graph launch, host launch calls, graph replays,
   idle share) with the NTT counts set to 0 just before it: both kernel
   modes must have run, counted on the device (the ntt_pass kernels in the
   trace, graph replays included: the wrapper counts only the launches it
   makes outside graphs); then one per-op request, where the trace's count
   must equal the wrapper's; and times the parts of load, graph capture
   included;
6. ResNet-20 `dacapo 40` (tpu_n15) with the trained checkpoint, full width
   and depth: traces it with the port and checks its .cst (and its .eir.json
   without source locations) against the JAX package's digests, loads the
   committed .hevm on the MLP's keyset (only the missing rotation keys are
   generated; the load captures the graphs), times keygen / galois keygen /
   pre-encode / capture and reports the plaintext and key bytes and the
   graphs' count; serves three timed segmented requests, checks the RMS of
   the 10 logits of each against the torch model (bar 9.5152e-4, the
   reference's), that 19 bootstraps ran in each and the plain NTT never
   did; reruns the second request per-op (jit=False) with the oracle's RNG
   restored and requires bit-equal output ciphertexts; reports peak device
   memory, times one request's windows by kind (a synchronize after each
   window) and profiles one more segmented request (oracle seconds, kernels
   per graph launch) in which both kernel modes must have run, counted on
   the device as in 5;
7. runs Scheme("tpu_n16", seed=5) on the card: keygen, encrypt two vectors,
   mul (relinearise), rescale, decrypt; checks the RMS against a*b, the
   output ciphertext bit-equal to the same calls with device="cpu", and that
   both kernel modes ran and the plain NTT never did;
8. the native bootstrap (ModRaise, CoeffToSlot, EvalMod, SlotToCoeff):
   (a) the test_boot bootstrap of tests/test_bootstrap.py on the card, its
   output ciphertext's SHA-256 equal to the JAX package's committed digest;
   (c) HEVM("tpu_n15b") (native bootstraps, radix 7) loads the committed
   deep DaCapo program (depth 20, 2 bootstraps to level 14, 2^14 slots) on a
   fresh keyset, the load running each bootstrap once (its galois keys,
   conjugation key and diagonals are made there) and capturing the graphs;
   three timed segmented requests (RMS against the plaintext model <= 1e-4,
   2 native bootstraps each, the NTT kernel launched in both modes, the
   plain NTT never), the second rerun per-op with the input RNG restored
   (bit-equal), one request timed by window and one profiled; (b) on the
   same scheme, the standalone bootstrap of uniform(-1, 1) at scale 2^40
   and nl=2 to level 14 (RMS <= 1e-5), timed three times, one bootstrap
   profiled (idle share, kernels, NTT calls of each mode on the device);
9. prints the kernel table as one JSON line (launches: the profiled ResNet
   request's, counted on the device; every path's under launches_by_path),
   then the card's name and power limit, then {"ok": true, "device":
   {...}} as the last line.

Any failed check raises, so the script exits non-zero and prints no result.
Without CUDA, or outside a checkout of the repository, it exits 2.
"""

import collections
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
TEST_BOOT_ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "native_test_boot")
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
N_TIMED = 25


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
    ~20 ms queued first keeps the card busy while the host enqueues the run,
    so the time excludes host launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        torch.cuda._sleep(40_000_000)
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


def kernel_checks(torch, params, ntt_mod, nk):
    """Both modes against the plain NTT at the MLP path's shapes."""
    results = {"fwd": {}, "inv": {}}
    max_err = {"fwd": 0, "inv": 0}
    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    # tpu_n15b: ModDown / mod_raise_pair (2 x 60 rows) and ModUp (4 digits x
    # 60 targets) at nl = 60, the native bootstrap's new shapes
    for profile, batches in (("tpu_n15", (2, 14, 56, 112, 2240)), ("test_n11", (2, 37)),
                             ("test_n8", (2, 9)), ("tpu_n16", (2, 42, 126)),
                             ("tpu_n15b", (120, 240))):
        ctx = params.CKKSContext(params.PROFILES[profile], "cuda")
        tab = ctx.dev
        for b in batches:
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
            n_primes = len(set(rows.tolist()))
            for mode in ("fwd", "inv"):
                k_ms = time_cuda(kern[mode], torch, flush)
                p_ms = time_cuda(plain[mode], torch, flush) if b <= 240 else None
                bound, by = ntt_bound_ms(b, ctx.n, n_primes, mode == "inv")
                results[mode][(profile, b)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                                   bound_by=by)
                log(f"[ntt] {mode} {profile} B={b:<5} equal=True kernel {k_ms:.4f} ms "
                    f"plain {'-' if p_ms is None else f'{p_ms:.4f}'} ms "
                    f"bound {bound:.4f} ms ({by})")
            del x, q
        del ctx, tab
        torch.cuda.empty_cache()
    log("[ntt] library: no single PyTorch call computes a modular NTT "
        "(torch.fft is floating point): library_ms is null")
    return results, max_err


# CUDA API calls that launch work (cuda* runtime, cu* low-level), as torch.profiler names them
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                       "cuLaunchKernelEx")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def graph_kernels(prof):
    """Device kernels of each graph launch in a trace, in launch order: the
    kernels (copies and sets left out) that carry the CUPTI correlation id of
    a graph launch call, as every kernel node of a launched graph does; and
    the count of every name among the device ops of those launches. None
    where the trace does not expose its raw events."""
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return None, None
    launch_ids = [e.correlation_id() for e in events if e.name() in GRAPH_LAUNCH_CALLS]
    ids = set(launch_ids)
    in_graphs = [e for e in events
                 if str(e.device_type()).endswith("CUDA") and e.correlation_id() in ids]
    per_id = collections.Counter(e.correlation_id() for e in in_graphs
                                 if not e.name().startswith(("Memcpy", "Memset")))
    names = collections.Counter(e.name()[:100] for e in in_graphs).most_common()
    return [per_id[c] for c in launch_ids], names


def profile_request(torch, request, tag, executor, nk, ntt_mod, cpu=True, trace_loss_ok=False):
    """One request under torch.profiler, with the NTT counts set to 0 just
    before it and read just after: device time by kernel, the NTT kernel's
    share, and the device's idle share of the request's wall time. Device
    ops are the kernels (inside graphs or not) and copies the profiler saw
    run on the card; host launches are the launch calls it saw on the host:
    kernel launches outside graphs plus graph launches, the latter checked
    against the executor's replay counter. ntt_launches: the NTT calls the
    device ran (nk.launches_in_profile, graph replays included);
    ntt_wrapper_launches: the calls the wrapper launched itself, outside
    graphs. Without replays the two must be equal. cpu=False records
    device activity and the runtime calls only (lighter on a long request).
    trace_loss_ok: a trace that holds fewer NTT calls than the wrapper
    launched is reported (ntt_trace_short_by), not raised: the native
    bootstrap's traces drop a few kernel records (a standalone bootstrap's
    trace held one NTT call of each mode fewer than the wrapper launched, in
    two runs, and 69,890 device kernels and copies against 69,895 kernel
    launch calls)."""
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    replays0 = executor.replays
    torch.cuda.synchronize()
    reset_counts(nk, ntt_mod)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    wrapper, plain = dict(nk.LAUNCHES), dict(ntt_mod.CALLS)
    replays = executor.replays - replays0
    averages = prof.key_averages()
    ntt_launches = nk.launches_in_profile(averages)
    per_graph, graph_names = graph_kernels(prof)
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
    out = dict(wall_s=wall, device_busy_s=busy, ntt_kernel_s=ntt,
               device_ops=sum(r[1] for r in rows), replays=replays,
               eager_kernel_launches=eager, graph_launch_calls=graph_calls,
               host_launches=replays + eager, launch_calls=calls,
               ntt_launches=ntt_launches, ntt_wrapper_launches=wrapper,
               plain_ntt_calls=plain,
               graph_kernels=None if per_graph is None else dict(
                   launches=len(per_graph), total=sum(per_graph),
                   largest=max(per_graph, default=0), per_launch=per_graph,
                   device_ops_by_name=graph_names),
               idle_share=(1 - busy / wall) if busy else None,
               by_kernel=[dict(device_s=r[0] / 1e6, count=r[1], name=r[2][:120]) for r in rows])
    log(f"[{tag}] host launches {out['host_launches']} = {replays} graph replays (executor) + "
        f"{eager} kernel launches outside graphs (profiler: {calls}); device kernels and "
        f"copies {out['device_ops']}")
    if graph_calls != replays:
        log(f"[{tag}] note: the profiler saw {graph_calls} graph launches, the executor "
            f"counted {replays} replays")
    if per_graph is None:
        log(f"[{tag}] kernels per graph launch: not measured (no raw trace events)")
    elif per_graph:
        log(f"[{tag}] kernels in the {len(per_graph)} graph launches: {sum(per_graph)} "
            f"(largest {max(per_graph)})")
    log(f"[{tag}] NTT calls the device ran {ntt_launches}, the wrapper launched outside "
        f"graphs {wrapper}, plain NTT calls {plain}")
    short = {k: wrapper[k] - ntt_launches[k] for k in wrapper if ntt_launches[k] < wrapper[k]}
    out["ntt_trace_short_by"] = short
    if short and not trace_loss_ok:
        raise AssertionError(f"the trace holds fewer NTT calls than the wrapper launched: "
                             f"{ntt_launches} < {wrapper}")
    if short:
        log(f"[{tag}] the trace holds fewer NTT calls than the wrapper launched, short by "
            f"{short}: it dropped records (device kernels and copies {out['device_ops']}, "
            f"kernel launch calls {eager})")
    elif replays == 0 and ntt_launches != wrapper:
        raise AssertionError(f"without graphs the trace's NTT calls {ntt_launches} differ "
                             f"from the wrapper's {wrapper}")
    if busy:
        log(f"[{tag}] request (profiled) wall {wall:.4f} s, device busy {busy:.4f} s "
            f"(idle share {1 - busy / wall:.3f}), {out['device_ops']} device kernels and copies, "
            f"NTT kernel {ntt:.4f} s ({ntt / busy:.3f} of device time)")
        for r in rows[:12]:
            log(f"[{tag}]   {r[0] / 1e3:9.3f} ms  x{r[1]:<6} {r[2][:90]}")
    else:
        log(f"[{tag}] no device time in the trace: device busy/idle share not measured")
    return out


def serve_mlp(np, torch, HEVM, mlp, nk, ntt_mod, params, keydir):
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
    vm.load(os.path.join(ARTIFACT, "MLP.cst"), os.path.join(ARTIFACT, "MLP.hevm"))
    mark("load", t0)
    ex = vm.executor
    cap = ex.capture_stats
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
    captures the graphs, three timed segmented requests are held to the
    reference's RMS bar, the second is rerun per-op with the same randomness
    and must give the same ciphertexts, and two more requests are timed by
    window and profiled."""
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
    vm = HEVM("tpu_n15", keyset_dir=keydir)
    torch.cuda.synchronize()
    out["keyset_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vm.load(cst, os.path.join(RESNET_ART, "ResNet.hevm"))
    out["load_s"] = time.perf_counter() - t0
    out["load_parts_s"] = vm.load_seconds
    shutil.rmtree(RESNET_TRACE)
    ex = vm.executor
    out.update(instructions=len(vm.prog.ops), unique_plaintexts=ex.n_plains,
               plaintext_bytes=ex.plain_bytes, galois_keys=ex.n_keys,
               galois_key_bytes=ex.key_bytes,
               after_load_bytes=torch.cuda.memory_allocated())
    cap = out["capture"] = ex.capture_stats
    out["peak_load_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[resnet] keyset load {out['keyset_load_s']:.3f} s; load {out['load_s']:.3f} s "
        + ", ".join(f"{k} {v:.3f} s" for k, v in vm.load_seconds.items()))
    log(f"[resnet] {out['instructions']} instructions, {ex.n_plains} unique plaintexts "
        f"{ex.plain_bytes} bytes, {ex.n_keys} galois keys {ex.key_bytes} bytes, "
        f"{out['after_load_bytes']} bytes allocated after load")
    log(f"[resnet] {cap['graphs']} graphs of {cap['windows']} windows: warm-up "
        f"{cap['warmup_s']:.3f} s, capture and instantiate {cap['capture_s']:.3f} s; peak "
        f"during load {out['peak_load_bytes']} bytes")

    # three timed segmented requests; the second one's input ciphertext, the
    # oracle's RNG state before it and its outputs are kept for the per-op rerun
    rng = vm.scheme.keygen.rng.bit_generator
    requests = []
    for i in range(3):
        reset_counts(nk, ntt_mod)
        ex.bootstrapper.calls = 0
        torch.cuda.reset_peak_memory_stats()
        state = rng.state
        t0 = time.perf_counter()
        vm.setInput(0, packed)
        vm.run()
        res = vm.getOutput()
        torch.cuda.synchronize()
        r = dict(request_s=time.perf_counter() - t0, eager_ntt_launches=dict(nk.LAUNCHES),
                 plain_ntt_calls=dict(ntt_mod.CALLS), bootstraps=ex.bootstrapper.calls,
                 peak_bytes=torch.cuda.max_memory_allocated())
        logits = cnn_he.resnet_postprocess(res[0])
        r["rms"] = float(np.sqrt(np.mean((logits - want) ** 2)))
        r["logits"] = logits.tolist()
        requests.append(r)
        log(f"[resnet] request {i} (segment) {r['request_s']:.3f} s: rms {r['rms']:.4e} "
            f"(bar {RMS_BAR_RESNET}), {r['bootstraps']} bootstraps, NTT launches outside "
            f"graphs {r['eager_ntt_launches']}, plain NTT calls {r['plain_ntt_calls']}, peak "
            f"{r['peak_bytes']} bytes allocated")
        if logits.shape != (10,) or not np.isfinite(logits).all():
            raise AssertionError(f"bad ResNet output {logits!r}")
        if not r["rms"] <= RMS_BAR_RESNET:
            raise AssertionError(f"ResNet rms {r['rms']} > {RMS_BAR_RESNET}")
        if r["bootstraps"] != expected["bootstraps"]:
            raise AssertionError(f"{r['bootstraps']} bootstraps ran, the program has "
                                 f"{expected['bootstraps']}")
        if any(r["plain_ntt_calls"].values()):
            raise AssertionError(f"the plain NTT ran on the ResNet path: {r}")
        if i == 1:
            kept_state, kept_outs = state, ex._last_outputs[0]
    out["requests"] = requests
    out["request_median_s"] = statistics.median(r["request_s"] for r in requests)

    # the second request again per-op, with the oracle's randomness restored
    rng.state = kept_state
    vm.jit = False
    t0 = time.perf_counter()
    vm.setInput(0, packed)
    vm.run()
    vm.getOutput()
    torch.cuda.synchronize()
    vm.jit = "auto"
    out["per_op_request_s"] = time.perf_counter() - t0
    out["segment_equals_per_op"] = all(
        torch.equal(a, b) for a, b in zip(ex._last_outputs[0], kept_outs))
    log(f"[resnet] request median of 3 (segment) {out['request_median_s']:.3f} s; the "
        f"second request per-op {out['per_op_request_s']:.3f} s, output ciphertexts "
        f"bit-equal to the segment run: {out['segment_equals_per_op']}")
    if not out["segment_equals_per_op"]:
        raise AssertionError("ResNet segment and per-op output ciphertexts differ")

    # windows by kind: a synchronize after each window
    ex.set_profiling(True)
    vm.setInput(0, packed)
    vm.run()
    ex.set_profiling(False)
    out["windows_by_kind"] = ex.seg_report(sys.stdout)

    # the profiled request also times each oracle bootstrap on the host
    # clock, between synchronizes (host RNG, CRT lift, NTTs, re-encryption)
    boot_s = []
    oracle = ex.bootstrapper.bootstrap

    def timed_bootstrap(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = oracle(*args)
        torch.cuda.synchronize()
        boot_s.append(time.perf_counter() - t0)
        return res

    def request():
        vm.setInput(0, packed)
        vm.run()

    ex.bootstrapper.bootstrap = timed_bootstrap
    try:
        prof = out["profiled_request"] = profile_request(torch, request, "resnet", ex, nk,
                                                         ntt_mod, cpu=False)
    finally:
        del ex.bootstrapper.bootstrap
    prof["bootstrap_s"] = boot_s
    log(f"[resnet] the profiled request's {len(boot_s)} bootstraps: {sum(boot_s):.3f} s "
        f"(min {min(boot_s):.4f}, max {max(boot_s):.4f} s each)")
    launches = prof["ntt_launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel mode never ran on the ResNet path: {launches}")
    if any(prof["plain_ntt_calls"].values()):
        raise AssertionError(f"the plain NTT ran on the ResNet path: {prof['plain_ntt_calls']}")
    return out, launches


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

def deep_golden(np, x, depth):
    """The plaintext model of the deep program (scripts/make_native_artifact.py)."""
    y = x.copy()
    for i in range(depth):
        y = y * x
        y = y + np.roll(y, -(1 + i))
        y = y * 0.9
    return y


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


def serve_native(np, torch, HEVM, nk, ntt_mod, params, keydir):
    """(c) HEVM("tpu_n15b") serves the committed deep DaCapo program with
    native bootstraps, then (b) the standalone bootstrap on the same scheme.
    Returns (results, the NTT calls of the profiled request on the device,
    those of the profiled standalone bootstrap)."""
    from types import SimpleNamespace
    from dacapo_tpu_torch.crypto.bootstrap_native import NativeBootstrapper
    from dacapo_tpu_torch.crypto.scheme import Ciphertext
    with open(os.path.join(NATIVE_ART, "expected.json")) as f:
        expected = json.load(f)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vm = HEVM("tpu_n15b", keyset_dir=keydir)
    torch.cuda.synchronize()
    out["keygen_s"] = time.perf_counter() - t0
    bs = vm.scheme._native_bs
    radix = 7 if vm.scheme.ctx.config.n_slots >= (1 << 14) else 5     # the runner's rule
    if not isinstance(bs, NativeBootstrapper) or bs.cfg.radix != radix:
        raise AssertionError(f"HEVM('tpu_n15b') built {bs!r}, not the radix-{radix} "
                             "native bootstrapper")
    t0 = time.perf_counter()
    vm.load(os.path.join(NATIVE_ART, "Deep.cst"), os.path.join(NATIVE_ART, "Deep.hevm"))
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
               after_load_bytes=torch.cuda.memory_allocated(),
               peak_load_bytes=torch.cuda.max_memory_allocated())
    log(f"[native] keygen {out['keygen_s']:.3f} s; load {out['load_s']:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in vm.load_seconds.items()))
    log(f"[native] {out['instructions']} instructions; galois keys {len(keys.galois)} made "
        f"({ex.n_keys} counted, {out['bootstrap_rotation_keys']} of them the bootstrap's) + "
        f"conjugation key, {ex.key_bytes} bytes; graphs {ex.capture_stats}; "
        f"{out['after_load_bytes']} bytes allocated "
        f"after load, peak {out['peak_load_bytes']}")
    if "bootstrap_warmup" not in vm.load_seconds or len(keys.galois) != ex.n_keys:
        raise AssertionError("the load did not make the bootstrap's keys")

    x = np.random.default_rng(expected["input_seed"]).uniform(
        *expected["input_range"], vm.scheme.ctx.config.n_slots)
    want = deep_golden(np, x, expected["depth"])
    rng = vm.scheme.keygen.rng.bit_generator
    requests = []
    for i in range(3):
        reset_counts(nk, ntt_mod)
        calls0, n_keys0 = bs.calls, len(keys.galois)
        torch.cuda.reset_peak_memory_stats()
        state = rng.state
        t0 = time.perf_counter()
        vm.setInput(0, x)
        vm.run()
        res = vm.getOutput()[0]
        torch.cuda.synchronize()
        r = dict(request_s=time.perf_counter() - t0, ntt_launches=dict(nk.LAUNCHES),
                 plain_ntt_calls=dict(ntt_mod.CALLS), bootstraps=bs.calls - calls0,
                 keys_made=len(keys.galois) - n_keys0,
                 peak_bytes=torch.cuda.max_memory_allocated())
        r["rms"] = float(np.sqrt(np.mean((res - want) ** 2)))
        r["min_max"] = [float(want.min()), float(want.max())]
        requests.append(r)
        log(f"[native] request {i} (segment) {r['request_s']:.3f} s: rms {r['rms']:.4e} "
            f"(bar {RMS_BAR_NATIVE_DEEP}), {r['bootstraps']} native bootstraps, NTT launches "
            f"{r['ntt_launches']}, plain NTT calls {r['plain_ntt_calls']}, keys made "
            f"{r['keys_made']}, peak {r['peak_bytes']} bytes")
        if res.shape != x.shape or not np.isfinite(res).all():
            raise AssertionError("bad output of the deep program")
        if not r["rms"] <= RMS_BAR_NATIVE_DEEP:
            raise AssertionError(f"deep program rms {r['rms']} > {RMS_BAR_NATIVE_DEEP}")
        if r["bootstraps"] != expected["bootstraps"] or expected["bootstraps"] < 2:
            raise AssertionError(f"{r['bootstraps']} native bootstraps ran, the program "
                                 f"has {expected['bootstraps']}")
        if min(r["ntt_launches"].values()) <= 0 or any(r["plain_ntt_calls"].values()):
            raise AssertionError(f"the NTT kernel did not carry the request: {r}")
        if r["keys_made"]:
            raise AssertionError("a request made keys the load should have made")
        if i == 1:
            kept_state, kept_outs = state, ex._last_outputs[0]
    out["requests"] = requests
    out["request_median_s"] = statistics.median(r["request_s"] for r in requests)

    rng.state = kept_state
    vm.jit = False
    t0 = time.perf_counter()
    vm.setInput(0, x)
    vm.run()
    torch.cuda.synchronize()
    vm.jit = "auto"
    out["per_op_request_s"] = time.perf_counter() - t0
    out["segment_equals_per_op"] = all(
        torch.equal(a, b) for a, b in zip(ex._last_outputs[0], kept_outs))
    log(f"[native] request median of 3 (segment) {out['request_median_s']:.3f} s; the "
        f"second per-op {out['per_op_request_s']:.3f} s, output ciphertexts bit-equal: "
        f"{out['segment_equals_per_op']}")
    if not out["segment_equals_per_op"]:
        raise AssertionError("the deep program's segment and per-op outputs differ")

    ex.set_profiling(True)
    vm.setInput(0, x)
    vm.run()
    ex.set_profiling(False)
    out["windows_by_kind"] = ex.seg_report(sys.stdout)

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
    for i in range(4):
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
    return out, req_launches, boot_launches


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

    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    results, max_err = kernel_checks(torch, params, ntt_mod, nk)
    seconds["kernel_checks"] = time.perf_counter() - t0
    # one tpu_n15 keyset: the MLP phase generates it, the ResNet phase adds
    # the rotation keys the MLP lacks
    with tempfile.TemporaryDirectory(prefix="hevm_keys_") as keydir:
        t0 = time.perf_counter()
        phases, launches, rms_all = serve_mlp(np, torch, HEVM, mlp, nk, ntt_mod, params,
                                              keydir)
        seconds["mlp"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rn, rn_launches = serve_resnet(np, torch, HEVM, nk, ntt_mod, keydir)
        seconds["resnet"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n16 = scheme_n16(np, torch, Scheme, nk, ntt_mod, params)
    seconds["tpu_n16"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    native = dict(test_boot=native_test_boot(np, Scheme, Ciphertext, BootstrapConfig, params))
    with tempfile.TemporaryDirectory(prefix="hevm_keys_n15b_") as keydir:
        native["tpu_n15b"], nat_launches, boot_launches = serve_native(
            np, torch, HEVM, nk, ntt_mod, params, keydir)
    seconds["native"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log("[time] phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))

    kernels = []
    for mode, name, line in (("fwd", "ntt_fwd_cuda", 94), ("inv", "ntt_inv_cuda", 110)):
        r = results[mode][("tpu_n15", 112)]
        n15b = {f"B={b}": results[mode][("tpu_n15b", b)] for b in (120, 240)}
        kernels.append(dict(
            name=name, route="cuda", source="dacapo_tpu_torch/csrc/ntt.cu",
            replaces=f"dacapo_tpu/crypto/pallas/ntt_kernel.py:{line}",
            launches=rn_launches[name], max_abs_err=max_err[mode], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape="B=112, N=2^15 (ModUp batch at tpu_n15)",
            launches_counted=("NTT calls the device ran in one profiled request of each "
                              "path (ntt_pass kernels in the trace, graph replays "
                              "included); tpu_n16 (no graphs): the wrapper's count"),
            launches_by_path={"resnet_tpu_n15_request": rn_launches[name],
                              "mlp_tpu_n15": launches[name],
                              "scheme_tpu_n16": n16["launches"][name],
                              "native_deep_tpu_n15b_request": nat_launches[name],
                              "native_bootstrap_tpu_n15b": boot_launches[name]},
            native_shapes_tpu_n15b=n15b))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       ntt={m: {f"{p}/B={b}": v for (p, b), v in r.items()}
                            for m, r in results.items()},
                       mlp=phases, rms=rms_all, resnet=rn, scheme_tpu_n16=n16,
                       native=native, phase_seconds=seconds, kernels=kernels),
                  f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
