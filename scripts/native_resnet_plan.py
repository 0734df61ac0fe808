#!/usr/bin/env python3
"""Predict, on the CPU, the device memory of ResNet-20 `dacapo 40` served on
tpu_n15b with native bootstraps (the committed
dacapo_tpu_torch/artifacts/resnet_dacapo40_tpu_n15b), part by part, against
the executor's plan (vm/executor.py: galois keys past KEY_BUDGET_FRAC and
plaintexts past PTXT_BUDGET_FRAC of the card's memory stream).

    python3 scripts/native_resnet_plan.py [--hbm BYTES] [--cst PATH] [--batch B,...] [--json]

It makes no key and encodes nothing:

* the bootstrap signatures (input rows, scale, target level) by the
  executor's own metadata walk (HEVMExecutor._boot_signatures) on an
  executor built without keys;
* the plaintext diagonals and constants the native bootstrapper caches
  (SlotLinearTransform._pt, the last CtS level per input normalizer,
  encode_const), counted by running NativeBootstrapper.bootstrap itself
  over shape-only tensors (torch's meta device): the cache keys are the
  real ones, so the counts are what a load's warm-up makes, signature by
  signature;
* the distinct galois keys (the program's offsets and the bootstrap's
  rotation steps) and the conjugation key, against the key budget (past it
  the device holds the budget's bytes: the graph windows' key arena and the
  LRU the native bootstrap reads through);
* the plaintexts resident as NTT planes against the plaintext budget, and
  the compact pool that replaces them past it;
* the bounds the executor puts on those planes, path by path
  (HEVMExecutor.path_budgets: what the keys and the plaintexts leave of
  their two budgets, less the plaintext LRU's bytes on the path), run
  through the same bootstrapper code over the load's warm-up and two
  requests: the most it holds, the signature groups it drops and the planes
  it encodes again a request; and the segment path without a bound;
* the graph pool, scaled from ResNet-20 on tpu_n15 (PERF.md: peak 19.11 GB
  less 7.41 GB of keys and 9.36 GB of planes, NVIDIA H100 80GB HBM3), by the
  key switch's rows (top ciphertext rows plus the special primes);
* the native bootstrap's working set, from the deep tpu_n15b program
  (PERF.md: its request peak less its keys and diagonals);
* which boot windows the segment path replays as CUDA graphs under its
  bound (the signatures whose planes stay pinned) and why each of the rest
  runs eagerly, the same under a galois-key budget and per op
  (boot_graph_plans);
* with --batch, for each batch size B a batch request's memory plan
  (HEVMExecutor.plan_batch, as before the batch graphs are captured): the
  single request's register
  bytes by the executor's walk (register_bytes) and its graph pool (the
  estimate above), B times each; the batch's plane bound,
  run through the bootstrapper as above with each boot window's B rows
  bootstrapped row by row (NativeBootstrapper.bootstrap_rows); the boot
  windows it replays; its device bytes; or the refusal (BatchTooLarge)
  with the bytes it needs and those it has.

The constants (.cst) decide which plaintexts are payload-identical: --cst
names the trace, by default traced/resnet_torch/_hecate_ResNet.cst, which
the port's tracer writes when it is missing (models/cnn_he.trace_resnet,
about 5 s and 483 MB).
"""

import collections
import json
import os
import sys
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np                                            # noqa: E402
import torch                                                  # noqa: E402

from dacapo_tpu_torch.crypto.bootstrap_native import (        # noqa: E402
    BootstrapConfig, NativeBootstrapper, native_config, sized_for_secret)
from dacapo_tpu_torch.crypto.params import PROFILES           # noqa: E402
from dacapo_tpu_torch.crypto.scheme import Scheme             # noqa: E402
from dacapo_tpu_torch.vm.executor import (                    # noqa: E402
    BatchTooLarge, HEVMExecutor, boot_window_plan)
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP  # noqa: E402

ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15b")
PROFILE = "tpu_n15b"
# the device memory torch.cuda.mem_get_info reports on an NVIDIA H100 80GB
# HBM3 (the executor's _hbm_limit on that card)
H100_BYTES = 85_017_493_504
# ResNet-20 dacapo 40 on tpu_n15, resident, on an NVIDIA H100 80GB HBM3
# (PERF.md section 5):
# peak bytes at load, galois keys, resident planes; at 28 Q rows + 7 special
N15_PEAK, N15_KEYS, N15_PLANES, N15_KS_ROWS = 19_108_781_568, 7_413_432_320, 9_364_832_256, 35
# the deep tpu_n15b program on the same card (PERF.md section 5): request
# peak bytes and galois + conjugation key bytes
DEEP_REQUEST_PEAK, DEEP_KEY_BYTES = 22_991_434_240, 12_740_198_400


class _NoPayloads:
    """Constants of a program whose .cst is not at hand: every payload
    reads as the same array, so no two encodes dedup unless their level and
    scale agree. Each encode's (nl, scale), all the metadata walk reads, is
    unchanged."""

    def __getitem__(self, i):
        return np.zeros(1)


def executor_shell(prog, profile, constants=None, config=None):
    """An HEVMExecutor of `prog` on a keyless scheme, built only as far as
    its metadata walk needs: the fused op stream and the plaintexts' (nl,
    scale) (HEVMExecutor._plaintext_plan). constants: the .cst's arrays
    (None: _NoPayloads); config: a CKKSConfig in place of the profile's.
    Returns (executor, cid_info, cid_qp)."""
    s = Scheme(profile, config=config, device="cpu")
    ex = HEVMExecutor.plan_only(s, prog, _NoPayloads() if constants is None else constants)
    cid_info, _, cid_qp = ex._plaintext_plan()
    return ex, cid_info, cid_qp


def boot_signatures(prog, profile, constants=None, config=None):
    """The program's distinct bootstrap signatures (input rows, scale,
    target level), in program order, by the executor's walk."""
    ex, _, _ = executor_shell(prog, profile, constants, config)
    return ex._boot_signatures()


class _ShapeEvaluator:
    """The Evaluator ops the native bootstrap calls, on shapes alone: every
    result is an int32 tensor on the meta device."""

    def __init__(self, n):
        self.n = n

    def _ct(self, nl, lead=()):
        return torch.empty(tuple(lead) + (2, nl, self.n), dtype=torch.int32, device="meta")

    def ntt(self, x, rows):
        return torch.empty_like(x)

    intt = ntt

    def add_ct(self, a, b, nl):
        return self._ct(nl)

    sub_ct = add_ct

    def add_pt(self, ct, pt, nl):
        return self._ct(nl)

    mul_pt = add_pt

    def mul_ct(self, a, b, nl, rlk):
        return self._ct(nl)

    def square_ct(self, a, nl, rlk):
        return self._ct(nl)

    def upscale(self, ct, nl, up_bits):
        return self._ct(nl)

    def rescale_k(self, x, nl, k):
        return self._ct(nl - k)

    def rotate(self, ct, nl, steps, gk):
        return self._ct(nl)

    def conjugate(self, ct, nl, ck):
        return self._ct(nl)

    def rotate_batch(self, ct, nl, shifts, gks):
        return self._ct(nl, (len(shifts),))


class _Keys(dict):
    """The galois keys a shape-only bootstrap asked for (step -> None),
    with the key store's attributes a graph records."""
    generation = 0
    budget = None


class _ShapeBootstrapper(NativeBootstrapper):
    """NativeBootstrapper.bootstrap over shape-only data: the scale walk and
    every cache key are the real ones; encodes give meta planes and the
    galois keys it asks for are recorded, not made."""

    def encode_vec(self, vec, scale, nl):
        return torch.empty((nl, self.s.ctx.n), dtype=torch.int32, device="meta")

    def mod_raise_pair(self, data, nl):
        return self.ev._ct(self.s.ctx.config.num_q)


def dry_bootstraps(profile, sigs, bs_config, config=None, budget=None, sequence=None,
                   bootstrapper=None, rows=1):
    """Run the native bootstrap (BootstrapConfig bs_config) of each
    signature on shapes alone, under a plane budget planned over `sequence`
    (NativeBootstrapper.set_plane_budget) when `budget` or `sequence` is
    given; rows > 1: each signature as the boot window of a batch of `rows`
    (bootstrap_rows). Returns (NativeBootstrapper.cached_planes() after each
    signature, with the evictions and re-encoded planes so far, the galois
    steps the bootstraps asked for, whether they asked for the conjugation
    key); bootstrapper: a list that gets the bootstrapper."""
    ctx = Scheme(profile, config=config, device="cpu").ctx
    steps, conj = set(), []
    keys = SimpleNamespace(rlk=None, conj=None, galois=_Keys())

    def ensure_galois(rot_steps):
        half = ctx.n // 2
        for st in rot_steps:
            if st % half:
                steps.add(st % half)
                keys.galois[st % half] = None

    def ensure_conj(ks):
        conj.append(True)

    shell = SimpleNamespace(ctx=ctx, ev=_ShapeEvaluator(ctx.n), device=torch.device("meta"),
                            keys=keys, ensure_galois=ensure_galois,
                            keygen=SimpleNamespace(ensure_conj=ensure_conj))
    bs = _ShapeBootstrapper(shell, bs_config)
    if bootstrapper is not None:
        bootstrapper.append(bs)
    if budget is not None or sequence is not None:
        bs.set_plane_budget(budget, sequence)
    after = []
    for nl, sc, target in sigs:
        if rows == 1:
            bs.bootstrap(torch.empty((2, nl, ctx.n), dtype=torch.int32, device="meta"),
                         nl, sc, target)
        else:
            bs.bootstrap_rows(torch.empty((rows, 2, nl, ctx.n), dtype=torch.int32,
                                          device="meta"), nl, sc, target)
        after.append(dict(bs.cached_planes(), evictions=bs.evictions,
                          reencodes=bs.reencodes))
    return after, sorted(steps), bool(conj)


def plan(prog, constants, profile, hbm, batch=()):
    """The whole prediction as one dict (module docstring); batch: the
    batch sizes to plan (batch_plan)."""
    ex, cid_info, cid_qp = executor_shell(prog, profile, constants)
    cfg = ex.s.ctx.config
    sigs = ex._boot_signatures()
    bs_config = native_config(cfg)                              # the runner's
    radix = bs_config.radix
    after, boot_steps, conj = dry_bootstraps(profile, sigs, bs_config)
    half = cfg.n // 2
    prog_steps = {o % half for o in prog.rotation_offsets() if o % half}
    key_each = cfg.dnum * 2 * cfg.num_all * cfg.n * 4
    n_keys = len(prog_steps | set(boot_steps)) + conj
    key_budget = int(HEVMExecutor.KEY_BUDGET_FRAC * hbm)
    pt_budget = int(HEVMExecutor.PTXT_BUDGET_FRAC * hbm)
    resident = ex.resident_plain_bytes(cid_info, cid_qp)
    streams = resident > pt_budget
    pool = len(cid_info) * 2 * cfg.n * 4
    top_rows = max([nl for nl, _ in ex._arg_meta()] + [(t + 1) * ex.rr for *_, t in sigs])
    graph_pool = (N15_PEAK - N15_KEYS - N15_PLANES) * (top_rows + cfg.alpha) / N15_KS_ROWS
    deep = plan_deep_diagonals()
    boot_work = DEEP_REQUEST_PEAK - DEEP_KEY_BYTES - deep
    keys_bytes = n_keys * key_each
    # past the budget the keys stay in pinned host memory and the device
    # holds the graph windows' arena and the LRU inside the budget
    key_device = min(keys_bytes, key_budget)
    plaintext_bytes = pool if streams else resident
    # the bounds the executor plans, path by path (_plan_bootstrap_planes),
    # each over the load's warm-up (each signature once) and two requests
    eager = ex.eager_plain_bytes(cid_info, cid_qp)
    budgets = HEVMExecutor.path_budgets(hbm, keys_bytes, plaintext_bytes, streams, eager)
    seq = ex._boot_sequence()
    n_warm = len(sigs)
    paths = {}
    for path, (lru, room) in budgets.items():
        bounded, _, _ = dry_bootstraps(profile, sigs + seq + seq, bs_config, budget=room,
                                       sequence=[(nl, sc) for nl, sc, _ in seq])
        held = max(a["diagonal_bytes"] + a["constant_bytes"] for a in bounded)
        total = key_device + held + plaintext_bytes + lru + graph_pool + boot_work
        second = bounded[n_warm + len(seq) - 1]
        paths[path] = dict(
            plaintext_lru_bytes=lru, plane_budget=room, plane_bytes_held_most=held,
            reencoded_planes_warmup=bounded[n_warm - 1]["reencodes"],
            reencoded_planes_per_request=bounded[-1]["reencodes"] - second["reencodes"],
            evictions_per_request=bounded[-1]["evictions"] - second["evictions"],
            predicted_device_bytes=int(total), headroom=1 - total / hbm)
    unbounded = after[-1]["diagonal_bytes"] + after[-1]["constant_bytes"]
    total = (key_device + unbounded + plaintext_bytes + budgets["segment"][0] + graph_pool
             + boot_work)
    paths["segment_unbounded"] = dict(
        plaintext_lru_bytes=budgets["segment"][0], plane_budget=None,
        plane_bytes_held_most=unbounded, reencoded_planes_warmup=0,
        reencoded_planes_per_request=0, evictions_per_request=0,
        predicted_device_bytes=int(total), headroom=1 - total / hbm)
    return dict(
        profile=profile, hbm_bytes=hbm, instructions=len(prog.ops),
        bootstraps=sum(op.opcode == OP_BOOTSTRAP for op in prog.ops),
        signatures=[list(s) for s in sigs], radix=radix,
        planes_after_signature=after,
        program_rotation_keys=len(prog_steps), bootstrap_rotation_keys=len(boot_steps),
        shared_rotation_keys=len(prog_steps & set(boot_steps)), conjugation_key=conj,
        galois_keys=n_keys, key_bytes_each=key_each, key_bytes=keys_bytes,
        key_budget=key_budget, keys_stream=keys_bytes > key_budget,
        key_device_bytes=key_device,
        unique_plaintexts=len(cid_info), resident_plaintext_bytes=resident,
        plaintext_budget=pt_budget, plaintexts_stream=streams, pool_bytes=pool,
        top_ciphertext_rows=top_rows, graph_pool_estimate_bytes=int(graph_pool),
        bootstrap_working_set_bytes=int(boot_work), deep_diagonal_bytes=deep,
        unbounded_plane_bytes=unbounded, eager_plaintext_bytes=eager, paths=paths,
        boot_graphs=boot_graph_plans(prog, profile, budgets["segment"][1], constants),
        batches={b: batch_plan(ex, profile, bs_config, sigs, seq, b, budgets, graph_pool,
                               key_device + plaintext_bytes + graph_pool + boot_work, hbm)
                 for b in batch})


def batch_plan(ex, profile, bs_config, sigs, seq, batch, budgets, single_pool, base, hbm):
    """A batch request of `batch` ciphertexts (module docstring): the
    executor's plan of it (HEVMExecutor.plan_batch, on the shell executor
    given the path budgets and the single request's graph pool estimate):
    its bytes beside a single request's, the plane bound it leaves; then
    the planes it holds at most and encodes again a request, the boot
    windows it replays, and its predicted device bytes (`base`, what a
    single request holds but the planes and the LRU, plus the batch's own;
    `hbm` the limit it is a share of); or the refusal."""
    ex._path_budgets = budgets
    ex.capture_stats, ex.batch_capture_stats = dict(pool_bytes=int(single_pool)), None
    try:
        p = ex.plan_batch(batch)
    except BatchTooLarge as e:
        return dict(batch=batch, register_bytes=ex.register_bytes(),
                    single_pool_bytes=int(single_pool), batch_bytes=int(e.need), fits=False,
                    need_bytes=int(e.need), room_bytes=int(e.room))
    out = dict(batch=batch, register_bytes=p["register_bytes"],
               single_pool_bytes=int(single_pool), batch_bytes=int(p["batch_bytes"]))
    lru, room = p["lru_budget"], p["plane_budget"]
    held_bs = []
    bounded, _, _ = dry_bootstraps(profile, sigs + seq + seq, bs_config, budget=room,
                                   sequence=[(nl, sc) for nl, sc, _ in seq],
                                   bootstrapper=held_bs, rows=batch)
    held = max(a["diagonal_bytes"] + a["constant_bytes"] for a in bounded)
    second = bounded[len(sigs) + len(seq) - 1]
    verdict = held_bs[0].graph_plan()
    windows = boot_window_plan(ex._boot_windows(), verdict, "segment")
    index = {sig: i for i, sig in enumerate(sigs)}
    total = base + lru + held + p["batch_bytes"]
    return dict(out, fits=True, plaintext_lru_bytes=lru, plane_budget=int(room),
                plane_bytes_held_most=held,
                reencoded_planes_per_request=bounded[-1]["reencodes"] - second["reencodes"],
                evictions_per_request=bounded[-1]["evictions"] - second["evictions"],
                boot_windows=[(wi, index[sig], why) for wi, sig, why in windows],
                predicted_device_bytes=int(total), headroom=1 - total / hbm)


def boot_graph_plans(prog, profile, segment_bound, constants=None):
    """Which of the program's native boot windows the segment path replays
    as CUDA graphs and why each of the rest runs eagerly
    (vm/executor.py boot_window_plan over NativeBootstrapper.graph_plan,
    after a load's warm-up of each signature on shapes alone): {case:
    [(window index, signature index, None or the reason)]} for the cases
    "unbounded", "segment_bound" (the plane bound `segment_bound`),
    "key_budget" and "per_op"."""
    ex, _, _ = executor_shell(prog, profile, constants)
    cfg = ex.s.ctx.config
    sigs = ex._boot_signatures()
    bs_config = native_config(cfg)                              # the runner's
    seq = [(nl, sc) for nl, sc, _ in ex._boot_sequence()]
    windows = ex._boot_windows()
    index = {sig: i for i, sig in enumerate(sigs)}
    out = {}
    for case, budget in (("unbounded", None), ("segment_bound", segment_bound)):
        held = []
        dry_bootstraps(profile, sigs, bs_config, budget=budget, sequence=seq,
                       bootstrapper=held)
        verdict = held[0].graph_plan()
        out[case] = boot_window_plan(windows, verdict, "segment")
        if budget is not None:
            out["key_budget"] = boot_window_plan(windows, verdict, "segment", key_budget=True)
            out["per_op"] = boot_window_plan(windows, verdict, "per_op")
            out["pinned_bytes"] = _pinned_bytes(held[0], verdict)
    return {case: [(wi, index[sig], why) for wi, sig, why in plan] if case != "pinned_bytes"
            else plan for case, plan in out.items()}


def _pinned_bytes(bs, verdict):
    """(bytes the captured signatures' planes pin, the most any other
    signature reads besides them): what graph_plan holds under the bound."""
    pinned = {}
    for sig, why in verdict.items():
        if why is None:
            pinned.update(bs._sig_planes[sig])
    rest = [sum(p[2] for e, p in bs._sig_planes[sig].items() if e not in pinned)
            for sig, why in verdict.items() if why is not None]
    return sum(p[2] for p in pinned.values()), max(rest, default=0)


def plan_deep_diagonals():
    """Diagonal and constant bytes of the committed deep tpu_n15b program's
    bootstraps (its measured peak less these is the bootstrap's working
    set)."""
    from dacapo_tpu_torch.ir.serialize import read_cst
    d = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "deep_dacapo40_tpu_n15b")
    prog = HEVMProgram.load(os.path.join(d, "Deep.hevm"))
    sigs = boot_signatures(prog, PROFILE, read_cst(os.path.join(d, "Deep.cst")))
    after, _, _ = dry_bootstraps(PROFILE, sigs, sized_for_secret(
        BootstrapConfig(radix=7), PROFILES[PROFILE].secret_h, PROFILES[PROFILE].n))
    return after[-1]["diagonal_bytes"] + after[-1]["constant_bytes"]


def resnet_constants(path):
    from dacapo_tpu_torch.ir.serialize import read_cst
    if not os.path.exists(path):
        from dacapo_tpu_torch.models import cnn_he, resnet
        with open(os.path.join(ART, "expected.json")) as f:
            nt = json.load(f)["nt"]
        model = resnet.get_model(os.path.join(REPO, "examples", "data", "resnet20.silu.model"))
        cnn_he.trace_resnet(os.path.dirname(path), model, nt=nt)
    return read_cst(path)


def main(argv):
    hbm = int(argv[argv.index("--hbm") + 1]) if "--hbm" in argv else H100_BYTES
    cst = (argv[argv.index("--cst") + 1] if "--cst" in argv else
           os.path.join(REPO, "traced", "resnet_torch", "_hecate_ResNet.cst"))
    batch = ([int(b) for b in argv[argv.index("--batch") + 1].split(",")]
             if "--batch" in argv else [])
    prog = HEVMProgram.load(os.path.join(ART, "ResNet.hevm"))
    r = plan(prog, resnet_constants(cst), PROFILE, hbm, batch)
    if "--json" in argv:
        print(json.dumps(r))
        return
    gb = lambda b: f"{b / 1e9:.2f} GB"
    print(f"ResNet-20 dacapo 40 on {PROFILE}: {r['instructions']} instructions, "
          f"{r['bootstraps']} bootstraps, radix {r['radix']}; signatures (rows, scale, "
          f"target): " + "; ".join(f"({nl}, 2^{__import__('math').log2(sc):.9f}, {t})"
                                   for nl, sc, t in r["signatures"]))
    prev = dict(diagonals=0, diagonal_bytes=0, constants=0, constant_bytes=0)
    for i, a in enumerate(r["planes_after_signature"]):
        print(f"  after signature {i}: {a['diagonals']} diagonal planes "
              f"({a['diagonal_bytes']} B, +{a['diagonal_bytes'] - prev['diagonal_bytes']} B), "
              f"{a['constants']} constant planes ({a['constant_bytes']} B), "
              f"{a['cts_last_normalizers']} last-CtS normalizers")
        prev = a
    print(f"galois keys: {r['program_rotation_keys']} of the program, "
          f"{r['bootstrap_rotation_keys']} of the bootstrap ({r['shared_rotation_keys']} "
          f"shared), conjugation {r['conjugation_key']}: {r['galois_keys']} x "
          f"{r['key_bytes_each']} B = {r['key_bytes']} B ({gb(r['key_bytes'])}) against the "
          f"budget {r['key_budget']} B: stream {r['keys_stream']}")
    print(f"plaintexts: {r['unique_plaintexts']} unique, resident planes "
          f"{r['resident_plaintext_bytes']} B ({gb(r['resident_plaintext_bytes'])}) against "
          f"the budget {r['plaintext_budget']} B: stream {r['plaintexts_stream']}; compact "
          f"pool {r['pool_bytes']} B")
    print(f"graph pool (estimate, top ciphertext rows {r['top_ciphertext_rows']}): "
          f"{gb(r['graph_pool_estimate_bytes'])}; bootstrap working set (from the deep "
          f"program): {gb(r['bootstrap_working_set_bytes'])}")
    print(f"diagonals and constants: {gb(r['unbounded_plane_bytes'])} unbounded; the eager "
          f"windows' plaintexts {r['eager_plaintext_bytes']} B")
    for path, p in r["paths"].items():
        print(f"{path}: plaintext LRU {gb(p['plaintext_lru_bytes'])}, plane bound "
              f"{p['plane_budget']} B: at most {gb(p['plane_bytes_held_most'])} held, "
              f"{p['evictions_per_request']} signature groups dropped and "
              f"{p['reencoded_planes_per_request']} planes encoded again a request (Belady "
              f"over the request's {r['bootstraps']} bootstraps); predicted device bytes "
              f"{p['predicted_device_bytes']} ({gb(p['predicted_device_bytes'])}) of "
              f"{r['hbm_bytes']}: headroom {p['headroom']:.3f}")
    g = r["boot_graphs"]
    for case in ("unbounded", "segment_bound", "key_budget", "per_op"):
        eager = collections.Counter(why for _, _, why in g[case] if why is not None)
        print(f"boot windows, {case}: {sum(why is None for _, _, why in g[case])} replay a "
              f"CUDA graph (signatures {sorted({i for _, i, why in g[case] if why is None})})"
              f", eager {dict(eager)}")
    print(f"the segment bound's pinned planes {gb(g['pinned_bytes'][0])}, the most another "
          f"signature reads besides them {gb(g['pinned_bytes'][1])}")
    for b, p in r["batches"].items():
        head = (f"batch B={b}: registers {gb(p['register_bytes'])} and graph pool "
                f"{gb(p['single_pool_bytes'])} a ciphertext, {p['batch_bytes']} B "
                f"({gb(p['batch_bytes'])}) beside a single request")
        if not p["fits"]:
            print(f"{head}: cannot be held, {p['need_bytes']} B needed, {p['room_bytes']} B "
                  "of planes on the segment path (precompile_batch raises BatchTooLarge)")
            continue
        eager = collections.Counter(why for _, _, why in p["boot_windows"] if why is not None)
        print(f"{head}: plane bound {p['plane_budget']} B, at most "
              f"{gb(p['plane_bytes_held_most'])} held, {p['evictions_per_request']} groups "
              f"dropped and {p['reencoded_planes_per_request']} planes encoded again a batch "
              f"request; {sum(why is None for _, _, why in p['boot_windows'])} boot windows "
              f"replay a graph, eager {dict(eager)}; predicted device bytes "
              f"{p['predicted_device_bytes']} ({gb(p['predicted_device_bytes'])}): headroom "
              f"{p['headroom']:.3f}")


if __name__ == "__main__":
    main(sys.argv)
