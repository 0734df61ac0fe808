#!/usr/bin/env python3
"""Native programs served in a batch on one NVIDIA card: the JAX package's
batch path (HEVM.setInputBatch / precompile_batch / runBatch) on tpu_n15b,
whose bootstraps are native and run row by row.

    python3 scripts/torch_batch_native.py [B ...] [--profile B,...]   (default: 2 4)

Native ResNet-20 at the B given (the deep tpu_n15b program's batches, at B
= 2 and 4, are chip_smoke.py's native batch part). A full
HEVM("tpu_n15b", save_keys=False: its ~27 GB of keys stay in memory,
nothing is written) loads the committed
dacapo_tpu_torch/artifacts/resnet_dacapo40_tpu_n15b (its .hevm and the
port's trace of the trained checkpoint by SHA-256; the trace is written to
the gitignored traced/resnet_torch when missing). The test images of seeds
100.. (as many as the largest B) are encrypted once; each is served alone
(B=1, a segment request, timed), one B=1 request profiled; then for each B:
the executor's memory plan of the batch (plan_batch: the single request's
registers and measured graph pool, B times), precompile_batch(B) (which
raises BatchTooLarge before any capture where the plan cannot hold the
batch: then the refusal and its bytes are the result), one timed runBatch of
the first B images and one profiled (--profile: the sizes profiled, 1 for
the single request; by default 1 and every B: a profile of B=4 took about
400 s on an NVIDIA H100 80GB HBM3, the request, the walk over its trace and
the profiler's own processing of 5.6M device events).
Every row of every request: RMS of the
10 logits against the torch model <= 9.5152e-4, output ciphertexts
byte-equal to the B=1 request of the same ciphertext (a row that fails
either is reported and fails the run at its end, after every batch was
measured); 18 native bootstraps
a ciphertext, row by row, each a replay of its signature's graph or eager
for the reason the executor's plan gives; no key made; no plain NTT. Reports
for each B: the plan before and after the capture, capture seconds and pool
bytes, seconds a batch and a ciphertext beside B=1, the bootstraps' seconds
and share (a synchronize around each), replays and eager bootstraps by
reason, planes encoded again, key copies, peak device bytes, and the idle
share and NTT calls of the profiled request. Then the NTT at every batch
size the batches launched (the batch captures and requests, and one eager
run of each bootstrap signature), bit-equal to the plain NTT, the largest
timed. Prints the log and writes torch_batch_native.json into chip_smoke.OUT_DIR.
About 20 minutes on an NVIDIA H100 80GB HBM3 with every profile, about 9
without. Exits 1 where a row failed a check.
"""

import collections
import gc
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMS_BAR = 9.5152e-4            # the reference's published ResNet-20 RMS


def main(argv):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_batch_native: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.crypto import ntt as ntt_mod, params
    from dacapo_tpu_torch.crypto.cuda import ntt_kernel as nk
    from dacapo_tpu_torch.models import cnn_he, resnet
    from dacapo_tpu_torch.vm import native as hevm_core
    from dacapo_tpu_torch.vm.executor import BatchTooLarge
    args = list(argv[1:])
    profiled = None
    if "--profile" in args:
        i = args.index("--profile")
        profiled = {int(b) for b in args[i + 1].split(",")}
        del args[i:i + 2]
    batches = [int(a) for a in args] or [2, 4]
    profiled = {1, *batches} if profiled is None else profiled
    rows = max(batches)
    log = cs.log
    card = cs.card_line()
    log(f"[env] card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    nk.build()
    hevm_core.build()
    report = dict(card=card, batches=batches, profiled=sorted(profiled),
                  build_s=time.perf_counter() - t0)

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    with open(os.path.join(cs.RESNET_NATIVE_ART, "expected.json")) as f:
        expected = json.load(f)
    hevm = os.path.join(cs.RESNET_NATIVE_ART, "ResNet.hevm")
    cst = os.path.join(cs.RESNET_TRACE, "_hecate_ResNet.cst")
    model = resnet.get_model(cs.RESNET_CKPT)
    if not os.path.exists(cst):
        cnn_he.trace_resnet(cs.RESNET_TRACE, model, nt=expected["nt"])
    digests = (cs.sha256_file(hevm), cs.sha256_file(cst))
    if digests != (expected["hevm_sha256"], expected["cst_sha256"]):
        raise AssertionError(f"the native ResNet program or its trace differs: {digests}")
    xs = [torch.randn(1, 3, 32, 32, dtype=torch.double,
                      generator=torch.Generator().manual_seed(100 + i)) for i in range(rows)]
    with torch.no_grad():
        wants = [model(x).numpy().ravel() for x in xs]
    packed = np.stack([cnn_he.resnet_pack_input(x.numpy(), model, nt=expected["nt"])
                       for x in xs])

    keydir = tempfile.TemporaryDirectory(prefix="hevm_keys_batch_native_")
    torch.cuda.reset_peak_memory_stats()
    t0 = sync()
    vm = HEVM("tpu_n15b", keyset_dir=keydir.name, save_keys=False)
    t1 = sync()
    vm.load(cst, hevm)
    t2 = sync()
    ex = vm.executor
    bs, keys = ex.bootstrapper, vm.scheme.keys
    plan = ex.boot_plan()
    load = report["load"] = dict(
        keygen_s=t1 - t0, load_s=t2 - t1, load_parts_s=vm.load_seconds,
        capture=ex.capture_stats, warmup=ex.bootstrap_stats, streaming=ex.streaming,
        pool_bytes=ex.pool_bytes, galois_keys=len(keys.galois), key_bytes=ex.key_bytes,
        path_budgets=ex._path_budgets, plane_budget=bs.plane_budget,
        register_bytes=ex.register_bytes(), boot_plan=[[wi, list(sig), why]
                                                      for wi, sig, why in plan],
        after_load_bytes=torch.cuda.memory_allocated(),
        peak_load_bytes=torch.cuda.max_memory_allocated())
    log(f"[batch native] keys {load['keygen_s']:.1f} s, load {load['load_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in vm.load_seconds.items())
        + f"); {len(keys.galois)} galois keys ({ex.key_bytes} bytes), streaming "
        f"{ex.streaming} (pool {ex.pool_bytes}); single request graphs' pool "
        f"{(ex.capture_stats or {}).get('pool_bytes')} bytes, bootstrap graphs "
        f"{(ex.capture_stats or {}).get('boot')}; registers {load['register_bytes']} bytes; plane "
        f"budgets by path {ex._path_budgets}; boot windows {load['boot_plan']}; "
        f"{load['after_load_bytes']} bytes allocated, peak {load['peak_load_bytes']}")

    vm.setInputBatch(0, packed)
    data, nl, scale = vm._arg_cts_batch[0]
    boot_s = []
    native = bs.bootstrap

    def timed_bootstrap(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = native(*args)
        torch.cuda.synchronize()
        boot_s.append(time.perf_counter() - t0)
        return res

    def counted(run, nbatch):
        """One timed request: its outputs' rows, seconds, bootstraps and
        what moved, every check held (its boot windows as the executor
        plans them for a batch of nbatch, boot_plan)."""
        plan = ex.boot_plan(batch=nbatch if nbatch > 1 else None)
        cs.reset_counts(nk, ntt_mod)
        before = dict(calls=bs.calls, reencodes=bs.reencodes, evictions=bs.evictions,
                      keys=len(keys.galois), conj=keys.conj, staged=dict(ex.key_staging),
                      uploads=keys.galois.uploads, ntt=cs.graph_ntt(ex))
        boot_s.clear()
        torch.cuda.reset_peak_memory_stats()
        bs.bootstrap = timed_bootstrap
        try:
            t0 = sync()
            res = run()
            seconds = sync() - t0
        finally:
            del bs.bootstrap
        outs = [o.clone() for o in ex._last_outputs[0]]
        r = dict(seconds=seconds, per_ciphertext_s=seconds / nbatch,
                 bootstraps=bs.calls - before["calls"], boots=ex.last_bootstraps,
                 bootstraps_total_s=sum(boot_s), bootstrap_share=sum(boot_s) / seconds,
                 planes_reencoded=bs.reencodes - before["reencodes"],
                 plane_groups_dropped=bs.evictions - before["evictions"],
                 key_copies={k: v - before["staged"][k] for k, v in ex.key_staging.items()},
                 lru_uploads=keys.galois.uploads - before["uploads"],
                 keys_made=(len(keys.galois), keys.conj) != (before["keys"], before["conj"]),
                 ntt_launches={k: nk.LAUNCHES[k] + v - before["ntt"][k]
                               for k, v in cs.graph_ntt(ex).items()},
                 plain_ntt_calls=dict(ntt_mod.CALLS), peak_bytes=torch.cuda.max_memory_allocated(),
                 boot_plan=[[wi, list(sig), why] for wi, sig, why in plan])
        want = dict(replayed=nbatch * sum(why is None for *_, why in plan), eager={})
        for *_, why in plan:
            if why is not None:
                want["eager"][why] = want["eager"].get(why, 0) + nbatch
        if (r["bootstraps"] != expected["bootstraps"] * nbatch or r["boots"] != want
                or r["keys_made"] or any(r["plain_ntt_calls"].values())
                or min(r["ntt_launches"].values()) <= 0):
            raise AssertionError(f"a request of {nbatch}: {r}, planned {want}")
        return res, outs, r

    def rms(res, b):
        """RMS of the 10 logits of decrypted result 0 against image b's."""
        return float(np.sqrt(np.mean((cnn_he.resnet_postprocess(res[0]) - wants[b]) ** 2)))

    def single(b):
        vm._arg_cts[0] = (data[b], nl, scale)
        return vm.run()

    # a row past the RMS bar or unequal to its B=1 request fails the run, at
    # the end: every batch is measured first
    failures = report["failures"] = []
    report["single"] = singles = []
    single_outs = []
    for b in range(rows):
        res, outs, r = counted(lambda: single(b), 1)
        single_outs.append(outs)
        r["rms"] = rms(res, b)
        singles.append(r)
        log(f"[batch native] B=1 row {b}: {r['seconds']:.3f} s, bootstraps "
            f"{r['bootstraps_total_s']:.3f} s ({r['boots']}), planes encoded again "
            f"{r['planes_reencoded']}, rms {r['rms']:.4e}, peak {r['peak_bytes']} bytes")
        if not r["rms"] <= RMS_BAR:
            failures.append(f"B=1 row {b} (image seed {100 + b}): rms {r['rms']} > {RMS_BAR}")
    single_s = statistics.median(r["seconds"] for r in singles)
    report["single_median_s"] = single_s
    prof = report["single_profiled"] = cs.profile_request(
        torch, lambda: single(0), "batch native B=1", ex, nk, ntt_mod, cpu=False,
        trace_loss_ok=True) if 1 in profiled else None

    shapes = cs.NttShapes()
    shapes.start()
    report["batch"] = {}
    try:
        for nbatch in batches:
            entry = report["batch"][str(nbatch)] = {}
            t0 = sync()
            try:
                # what precompile_batch plans first, from the single request's pool
                entry["plan_before_capture"] = dict(ex.plan_batch(nbatch) or {})
                graphs = vm.precompile_batch(nbatch)
            except BatchTooLarge as e:
                entry.update(refused=True, need_bytes=e.need, room_bytes=e.room, message=str(e))
                log(f"[batch native] B={nbatch}: refused by the memory plan before any "
                    f"capture: {e}")
                continue
            entry.update(refused=False, graphs=graphs, capture_s=sync() - t0,
                         capture=dict(ex.batch_capture_stats or {}),
                         plan=ex.plan_batch(nbatch))
            vm._arg_cts_batch[0] = (data[:nbatch], nl, scale)
            res, outs, r = counted(vm.runBatch, nbatch)
            r["rms"] = [rms(res[b], b) for b in range(nbatch)]
            r["rows_equal_single"] = [all(torch.equal(o[b], s)
                                          for o, s in zip(outs, single_outs[b]))
                                      for b in range(nbatch)]
            r["single_over_per_ciphertext"] = single_s / r["per_ciphertext_s"]
            entry["request"] = r
            log(f"[batch native] B={nbatch}: plan {entry['plan_before_capture']} before the "
                f"capture, {entry['plan']} after; {graphs} graphs in {entry['capture_s']:.1f} s "
                f"(pool {entry['capture'].get('pool_bytes')} bytes); request {r['seconds']:.3f} s, "
                f"{r['per_ciphertext_s']:.3f} s a ciphertext (B=1 {single_s:.3f} s), "
                f"bootstraps {r['bootstraps_total_s']:.3f} s (share {r['bootstrap_share']:.3f}; "
                f"{r['boots']}), planes encoded again {r['planes_reencoded']}, key copies "
                f"{r['key_copies']}, LRU uploads {r['lru_uploads']}; rms "
                + ", ".join(f"{v:.4e}" for v in r["rms"])
                + f"; rows byte-equal to B=1 {r['rows_equal_single']}; peak "
                f"{r['peak_bytes']} bytes")
            failures.extend(f"B={nbatch} row {b} (image seed {100 + b}): rms {v} > {RMS_BAR}"
                            for b, v in enumerate(r["rms"]) if not v <= RMS_BAR)
            failures.extend(f"B={nbatch} row {b}: output ciphertexts differ from its B=1 request's"
                            for b, eq in enumerate(r["rows_equal_single"]) if not eq)
            if nbatch in profiled:
                entry["profiled"] = cs.profile_request(
                    torch, vm.runBatch, f"batch native B={nbatch}", ex, nk, ntt_mod,
                    cpu=False, trace_loss_ok=True)
            # the next size captures its own graphs: this one's pool goes back
            vm.drop_batch()
            gc.collect()
            torch.cuda.empty_cache()
        for sig in dict.fromkeys(sig for _, sig, _ in plan):
            bs.warm(*sig)
    finally:
        shapes.stop()
    report["ntt_check"] = cs.batch_kernel_checks(torch, params, ntt_mod, nk, "tpu_n15b",
                                                 sorted(shapes.sizes), "native ResNet batch")
    for nbatch, res in report["batch"].items():
        if "profiled" in res:
            p = res["profiled"]
            log(f"[batch native] B={nbatch} profiled: wall {p['wall_s']:.3f} s, idle share "
                f"{p['idle_share']}, NTT calls on the device {p['ntt_launches']} (counted "
                f"{p['ntt_counted']})")
    if prof is not None:
        log(f"[batch native] B=1 profiled: wall {prof['wall_s']:.3f} s, idle share "
            f"{prof['idle_share']}, NTT calls {prof['ntt_launches']}")
    eager = collections.Counter(why for *_, why in plan if why is not None)
    log(f"[batch native] the plan's boot windows a request: "
        f"{sum(why is None for *_, why in plan)} replayed, eager {dict(eager)}")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "torch_batch_native.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    keydir.cleanup()
    for f in failures:
        log(f"[batch native] FAILED: {f}")
    log(card)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
