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
   generated keyset, checks each RMS against the numpy model and the first
   output ciphertext against the JAX package's digest, and checks that the
   path ran the kernel and never the plain NTT;
5. profiles one more request (device time by kernel, idle share) and times
   the parts of load;
6. ResNet-20 `dacapo 40` (tpu_n15) with the trained checkpoint, full width
   and depth: traces it with the port and checks its .cst (and its .eir.json
   without source locations) against the JAX package's digests, loads the
   committed .hevm on the MLP's keyset (only the missing rotation keys are
   generated), times keygen / galois keygen / pre-encode and reports the
   plaintext and key bytes, serves one timed request, checks the RMS of the
   10 logits against the torch model (bar 9.5152e-4, the reference's), that
   19 bootstraps ran, both kernel modes launched and the plain NTT never
   did, reports peak device memory, and profiles one more request;
7. runs Scheme("tpu_n16", seed=5) on the card: keygen, encrypt two vectors,
   mul (relinearise), rescale, decrypt; checks the RMS against a*b, the
   output ciphertext bit-equal to the same calls with device="cpu", and that
   both kernel modes ran and the plain NTT never did;
8. prints the kernel table as one JSON line (launches: the ResNet request's;
   every path's under launches_by_path), then the card's name and power
   limit, then {"ok": true, "device": {...}} as the last line.

Any failed check raises, so the script exits non-zero and prints no result.
Without CUDA, or outside a checkout of the repository, it exits 2.
"""

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
OUT_DIR = os.path.join(REPO, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# H100 SXM 32-bit integer instructions a second: 64 INT32 lanes per SM (half
# the 128 FP32 lanes; Hopper architecture white paper) x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9
RMS_BAR = 1e-6
RMS_BAR_N16 = 1e-3
RMS_BAR_RESNET = 9.5152e-4     # the reference's published ResNet-20 RMS
N_TIMED = 25


def log(*a):
    print(*a, flush=True)


def sh(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"


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
    for profile, batches in (("tpu_n15", (2, 14, 56, 112, 2240)), ("test_n11", (2, 37)),
                             ("test_n8", (2, 9)), ("tpu_n16", (2, 42, 126))):
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
                p_ms = time_cuda(plain[mode], torch, flush) if b <= 126 else None
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


def profile_request(torch, request, tag, cpu=True):
    """One request under torch.profiler: device time by kernel, the NTT
    kernel's share, and the device's idle share of the request's wall time.
    cpu=False records device activity only (lighter on a long request)."""
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
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
    out = dict(wall_s=wall, device_busy_s=busy, ntt_kernel_s=ntt,
               kernel_launches=sum(r[1] for r in rows),
               idle_share=(1 - busy / wall) if busy else None,
               top=[dict(device_s=r[0] / 1e6, count=r[1], name=r[2][:120]) for r in rows[:12]])
    if busy:
        log(f"[{tag}] request (profiled) wall {wall:.4f} s, device busy {busy:.4f} s "
            f"(idle share {1 - busy / wall:.3f}), {out['kernel_launches']} kernel launches, "
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
    for k in nk.LAUNCHES:
        nk.LAUNCHES[k] = 0
    for k in ntt_mod.CALLS:
        ntt_mod.CALLS[k] = 0

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
        phases[f"request{seed}"]["rms"] = rms
        log(f"[mlp] request seed={seed}: {phases[f'request{seed}']['seconds']:.4f} s "
            f"rms {rms:.3e} launches fwd {phases[f'request{seed}']['ntt_fwd_cuda']} "
            f"inv {phases[f'request{seed}']['ntt_inv_cuda']}")
        if not rms <= RMS_BAR:
            raise AssertionError(f"MLP rms {rms} > {RMS_BAR}")
        if seed == 0:
            digest = hashlib.sha256()
            for ct in vm.executor._last_outputs[0]:
                digest.update(params.to_host(ct).astype("<u4").tobytes())
            phases["digest_match"] = digest.hexdigest() == expected["output_ct_sha256"]
            log(f"[mlp] output ciphertext sha256 {digest.hexdigest()} "
                f"(JAX package: {expected['output_ct_sha256']}) "
                f"match={phases['digest_match']}")
            if not phases["digest_match"]:
                raise AssertionError("output ciphertext differs from the JAX package's")
    plain_calls = dict(ntt_mod.CALLS)

    def request():
        vm.setInput(0, mlp.make_input(3))
        vm.run()

    phases["breakdown"] = dict(profiled_request=profile_request(torch, request, "profile"),
                               load_parts_s=vm.load_seconds)
    log("[mlp] parts of load: " + ", ".join(f"{k} {v:.3f} s"
                                            for k, v in vm.load_seconds.items()))
    launches = {k: sum(v.get(k, 0) for v in phases.values() if isinstance(v, dict))
                for k in nk.LAUNCHES}
    for name in ("keygen", "load"):
        log(f"[mlp] {name}: {phases[name]['seconds']:.3f} s, launches "
            f"fwd {phases[name]['ntt_fwd_cuda']} inv {phases[name]['ntt_inv_cuda']}")
    log(f"[mlp] main path launches {launches}, plain NTT calls {plain_calls}")
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
    the MLP phase wrote (only the missing rotation keys are generated), one
    timed request is held to the reference's RMS bar, and one more request
    is profiled."""
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
    log(f"[resnet] keyset load {out['keyset_load_s']:.3f} s; load {out['load_s']:.3f} s "
        + ", ".join(f"{k} {v:.3f} s" for k, v in vm.load_seconds.items()))
    log(f"[resnet] {out['instructions']} instructions, {ex.n_plains} unique plaintexts "
        f"{ex.plain_bytes} bytes, {ex.n_keys} galois keys {ex.key_bytes} bytes, "
        f"{out['after_load_bytes']} bytes allocated after load")

    for k in nk.LAUNCHES:
        nk.LAUNCHES[k] = 0
    for k in ntt_mod.CALLS:
        ntt_mod.CALLS[k] = 0
    ex.bootstrapper.calls = 0
    t0 = time.perf_counter()
    vm.setInput(0, packed)
    vm.run()
    res = vm.getOutput()
    torch.cuda.synchronize()
    out["request_s"] = time.perf_counter() - t0
    launches, plain_calls = dict(nk.LAUNCHES), dict(ntt_mod.CALLS)
    out.update(launches=launches, plain_ntt_calls=plain_calls,
               bootstraps=ex.bootstrapper.calls,
               peak_bytes=torch.cuda.max_memory_allocated())
    logits = cnn_he.resnet_postprocess(res[0])
    rms = out["rms"] = float(np.sqrt(np.mean((logits - want) ** 2)))
    out["logits"] = logits.tolist()
    log(f"[resnet] request {out['request_s']:.3f} s: rms {rms:.4e} (bar {RMS_BAR_RESNET}), "
        f"{out['bootstraps']} bootstraps, NTT launches {launches}, plain NTT calls "
        f"{plain_calls}, peak {out['peak_bytes']} bytes allocated")
    if logits.shape != (10,) or not np.isfinite(logits).all():
        raise AssertionError(f"bad ResNet output {logits!r}")
    if not rms <= RMS_BAR_RESNET:
        raise AssertionError(f"ResNet rms {rms} > {RMS_BAR_RESNET}")
    if out["bootstraps"] != expected["bootstraps"]:
        raise AssertionError(f"{out['bootstraps']} bootstraps ran, the program has "
                             f"{expected['bootstraps']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel mode never ran on the ResNet path: {launches}")
    if any(plain_calls.values()):
        raise AssertionError(f"the plain NTT ran on the ResNet path: {plain_calls}")

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
        out["profiled_request"] = profile_request(torch, request, "resnet", cpu=False)
    finally:
        del ex.bootstrapper.bootstrap
    out["profiled_request"]["bootstrap_s"] = boot_s
    log(f"[resnet] the profiled request's {len(boot_s)} bootstraps: {sum(boot_s):.3f} s "
        f"(min {min(boot_s):.4f}, max {max(boot_s):.4f} s each)")
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
    for k in nk.LAUNCHES:
        nk.LAUNCHES[k] = 0
    for k in ntt_mod.CALLS:
        ntt_mod.CALLS[k] = 0
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
    from dacapo_tpu_torch.crypto.scheme import Scheme
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

    results, max_err = kernel_checks(torch, params, ntt_mod, nk)
    # one tpu_n15 keyset: the MLP phase generates it, the ResNet phase adds
    # the rotation keys the MLP lacks
    with tempfile.TemporaryDirectory(prefix="hevm_keys_") as keydir:
        phases, launches, rms_all = serve_mlp(np, torch, HEVM, mlp, nk, ntt_mod, params,
                                              keydir)
        gc.collect()
        torch.cuda.empty_cache()
        rn, rn_launches = serve_resnet(np, torch, HEVM, nk, ntt_mod, keydir)
    gc.collect()
    torch.cuda.empty_cache()
    n16 = scheme_n16(np, torch, Scheme, nk, ntt_mod, params)

    kernels = []
    for mode, name, line in (("fwd", "ntt_fwd_cuda", 94), ("inv", "ntt_inv_cuda", 110)):
        r = results[mode][("tpu_n15", 112)]
        kernels.append(dict(
            name=name, route="cuda", source="dacapo_tpu_torch/csrc/ntt.cu",
            replaces=f"dacapo_tpu/crypto/pallas/ntt_kernel.py:{line}",
            launches=rn_launches[name], max_abs_err=max_err[mode], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape="B=112, N=2^15 (ModUp batch at tpu_n15)",
            launches_by_path={"resnet_tpu_n15_request": rn_launches[name],
                              "mlp_tpu_n15": launches[name],
                              "scheme_tpu_n16": n16["launches"][name]}))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       ntt={m: {f"{p}/B={b}": v for (p, b), v in r.items()}
                            for m, r in results.items()},
                       mlp=phases, rms=rms_all, resnet=rn, scheme_tpu_n16=n16,
                       kernels=kernels),
                  f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
