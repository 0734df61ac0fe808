#!/usr/bin/env python3
"""Count, on the CPU, what the port's galois-key slot arena does for a
committed program under a device-memory plan (dacapo_tpu_torch/vm/executor.py
`_key_arena`): the segment plan's windows, the key reads of its graph
windows, the arena's slots, and the keys copied into them a request with the
planned (Belady) slots against a plain LRU of as many slots.

    python3 scripts/key_slot_plan.py            # ResNet-20 at 10 GiB, the deep program at 16 GiB
    python3 scripts/key_slot_plan.py --json     # the same as one JSON line

Reads the .hevm files only: no key is made and nothing runs on a device. The
deep program's reserve (its conjugation key) and its native bootstrap's
rotation keys come from a tpu_n15b NativeBootstrapper built without keys.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dacapo_tpu_torch.crypto.params import PROFILES          # noqa: E402
from dacapo_tpu_torch.vm.executor import (                    # noqa: E402
    HEVMExecutor, key_slot_count, lru_key_copies, plan_key_slots)
from dacapo_tpu_torch.vm.fuse import ssa_expand, build_fuse_plan   # noqa: E402
from dacapo_tpu_torch.vm.hevm import HEVMProgram              # noqa: E402

ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts")
CASES = (
    ("ResNet-20 dacapo 40", os.path.join(ART, "resnet_dacapo40_tpu_n15", "ResNet.hevm"),
     "tpu_n15", 10 << 30, False),
    ("deep dacapo 40", os.path.join(ART, "deep_dacapo40_tpu_n15b", "Deep.hevm"),
     "tpu_n15b", 16 << 30, True),
)


def window_plan(path):
    """The executor's segment plan of a program, without a scheme."""
    ex = object.__new__(HEVMExecutor)
    ex.ops, ex.num_regs, ex.res_dst = ssa_expand(HEVMProgram.load(path))
    ex.ops, ex._fused_pt_regs, ex.num_regs = build_fuse_plan(ex.ops, ex.num_regs, ex.res_dst)
    return ex, ex._window_plan(HEVMExecutor.SEGMENT_MAX_OPS)


def native_reads(profile):
    """(rotation keys, the galois-key reads of one native bootstrap in its
    order): each CtS/StC level reads its baby steps (rotate_bank), then one
    giant step per group (SlotLinearTransform.apply)."""
    from dacapo_tpu_torch.crypto.bootstrap_native import NativeBootstrapper, native_config
    from dacapo_tpu_torch.crypto.scheme import Scheme
    s = Scheme(profile, device="cpu")
    bs = NativeBootstrapper(s, native_config(s.ctx.config))   # the runner's
    n_slots = s.ctx.config.n_slots
    cts, stc_first, stc_rest = bs._transforms()
    last = bs._cts_last(1.0)
    reads = []
    for t in list(cts) + list(last) + list(stc_first) + list(stc_rest):
        reads += sorted({off % t.b for offs in t.groups.values() for off in offs} - {0})
        reads += [g * t.b % n_slots for g in sorted(t.groups) if g * t.b % n_slots]
    return bs.rotation_steps(), reads


def count(name, path, profile, hbm, native):
    cfg = PROFILES[profile]
    kb = cfg.dnum * 2 * cfg.num_all * cfg.n * 4
    ex, plan = window_plan(path)
    graphs = [info for info in plan if ex._graph_window(info)]
    seq = [info["rot_steps"] for info in graphs if info["rot_steps"]]
    n_slots = cfg.n // 2
    steps = {o % n_slots for o in HEVMProgram.load(path).rotation_offsets() if o % n_slots}
    boot, boot_reads = native_reads(profile) if native else ([], [])
    n_keys = len(steps | set(boot))
    budget = int(HEVMExecutor.KEY_BUDGET_FRAC * hbm)
    reserve = kb if native else 0
    slots = key_slot_count(seq, budget, kb, reserve)
    _, _, planned = plan_key_slots(seq, slots)
    lru = lru_key_copies(seq, slots)
    reads = sum(map(len, seq))
    return dict(
        program=name, profile=profile, hbm_bytes=hbm, key_bytes_each=kb,
        windows=len(plan), graph_windows=len(graphs), rotating_graph_windows=len(seq),
        key_reads=reads, widest_window=max(map(len, seq), default=0),
        distinct_graph_keys=len({k for ks in seq for k in ks}),
        keys_counted=n_keys + native, key_bytes_counted=(n_keys + native) * kb,
        bootstrap_rotation_keys=len(boot), key_budget=budget,
        streams=(n_keys + native) * kb > budget, reserve_bytes=reserve,
        slots=slots, arena_bytes=slots * kb, lru_room_keys=(budget - reserve) // kb - slots,
        copies_planned=planned, copies_lru=lru,
        bytes_planned=planned * kb, bytes_lru=lru * kb,
        # the native bootstraps read through the key store's LRU, in the
        # room the arena leaves: its uploads a request (two bootstraps)
        bootstrap_key_reads=len(boot_reads),
        bootstrap_lru_uploads=lru_key_copies([boot_reads] * 2, max(
            1, (budget - reserve) // kb - slots)) if boot_reads else 0)


def main():
    rows = [count(*case) for case in CASES]
    if "--json" in sys.argv:
        print(json.dumps(rows))
        return
    for r in rows:
        print(f"{r['program']} ({r['profile']}, DACAPO_TPU_HBM_BYTES={r['hbm_bytes']}): "
              f"{r['windows']} windows, {r['graph_windows']} graph windows, "
              f"{r['rotating_graph_windows']} rotate; {r['key_reads']} key reads a request, "
              f"widest window {r['widest_window']}, {r['distinct_graph_keys']} distinct keys; "
              f"keys counted {r['keys_counted']} x {r['key_bytes_each']} B = "
              f"{r['key_bytes_counted']} B (native bootstrap {r['bootstrap_rotation_keys']}), "
              f"budget {r['key_budget']} B, streams {r['streams']}; arena {r['slots']} slots "
              f"({r['arena_bytes']} B), LRU room {r['lru_room_keys']} keys; copies a request: "
              f"planned {r['copies_planned']} ({r['bytes_planned']} B), plain LRU "
              f"{r['copies_lru']} ({r['bytes_lru']} B); native bootstrap: "
              f"{r['bootstrap_key_reads']} key reads each, {r['bootstrap_lru_uploads']} LRU "
              f"uploads a request of two")


if __name__ == "__main__":
    main()
