"""The native bootstrap's CUDA graphs (crypto/bootstrap_native.py capture,
vm/executor.py boot_plan), on the CPU, where no graph exists:

* the plan of the committed ResNet-20 program on tpu_n15b
  (artifacts/resnet_dacapo40_tpu_n15b): which of its 18 boot windows the
  segment path replays and why each of the rest runs eagerly, without a
  plane bound, under the segment path's bound on an NVIDIA H100 80GB HBM3
  (29,248,905,543 B, HEVMExecutor.path_budgets there), under a galois-key
  budget and per op, by the executor's metadata walk and the bootstrapper
  run over shape-only tensors (scripts/native_resnet_plan.py; no key made,
  nothing encoded);
* the replay's host bookkeeping (calls, the planned sequence's position,
  groups, evictions, re-encodes) equal to an eager run's over a request, a
  stand-in graph in place of the CUDA one;
* pinned planes never dropped by the bound, and given back by drop_graphs;
* the executor's count of eager bootstraps by reason on both paths, and
  the per-op path dropping the graphs' pins.

Replays on the card: tests/test_torch_native_cuda.py."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig, NativeBootstrapper
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.vm.executor import boot_window_plan
from dacapo_tpu_torch.vm.hevm import HEVMProgram

ROOT = os.path.join(os.path.dirname(__file__), "..")
ART = os.path.join(ROOT, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15b")
SEGMENT_BOUND = 29_248_905_543      # the segment path's plane bound on an H100 80GB HBM3
CFG = dict(K=16, r=3, degree=36, baby=8)
A, B = (2, 2.0 ** 25), (2, 2.0 ** 24)          # two test_boot signatures (rows, scale)


def _plan_script():
    spec = importlib.util.spec_from_file_location(
        "native_resnet_plan", os.path.join(ROOT, "scripts", "native_resnet_plan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def resnet_plans():
    with open(os.path.join(ART, "expected.json")) as f:
        expected = json.load(f)
    prog = HEVMProgram.load(os.path.join(ART, "ResNet.hevm"))
    return _plan_script().boot_graph_plans(prog, "tpu_n15b", SEGMENT_BOUND), expected


@pytest.mark.parametrize("case,replayed,eager", [
    ("unbounded", set(range(7)), {}),
    # the bound keeps the planes of the signatures with the most bootstraps
    # (0: 9 of 18; 4, 5, 6: 2 each) pinned beside one more signature's
    ("segment_bound", {0, 4, 5, 6}, {"dropped_group": 3}),
    ("key_budget", set(), {"key_budget": 18}),
    ("per_op", set(), {"per_op": 18}),
])
def test_resnet_boot_plan(resnet_plans, case, replayed, eager):
    plans, expected = resnet_plans
    plan = plans[case]
    assert len(plan) == expected["bootstraps"] == 18
    assert [i for _, i, _ in plan] == [0, 1, 0, 2, 0, 3, 0, 4, 0, 5, 0, 6, 0, 4, 0, 5, 0, 6]
    assert {i for _, i, why in plan if why is None} == replayed
    counted = {}
    for _, i, why in plan:
        if why is not None:
            counted[why] = counted.get(why, 0) + 1
    assert counted == eager
    pinned, most_other = plans["pinned_bytes"]
    assert pinned + most_other <= SEGMENT_BOUND < pinned + 2 * most_other


def test_boot_window_plan_reasons():
    """One reason for each eager window: per op first, then a mesh, then a
    key budget, then the plane bound's verdict."""
    windows = [(3, A + (1,)), (7, B + (1,))]
    verdict = {A: None, B: "dropped_group"}
    assert boot_window_plan(windows, verdict, "segment") == [
        (3, A + (1,), None), (7, B + (1,), "dropped_group")]
    for kw, why in ((dict(path="per_op", key_budget=True, mesh=True), "per_op"),
                    (dict(path="segment", key_budget=True, mesh=True), "mesh"),
                    (dict(path="segment", key_budget=True), "key_budget")):
        assert [w for _, _, w in boot_window_plan(windows, verdict, **kw)] == [why, why]


def _shape_bootstrapper(budget, sequence):
    """The test_boot bootstrapper over shape-only tensors, after a warm-up
    run of A and B under the bound planned over `sequence`."""
    held = []
    _plan_script().dry_bootstraps("test_boot", [A + (1,), B + (1,)], BootstrapConfig(**CFG),
                                  budget=budget, sequence=sequence, bootstrapper=held)
    return held[0]


def _stand_in_graph(bs, sig, target):
    """A graph record of `sig` as capture leaves it, its replay a stand-in
    for the CUDA graph's (the same device work, recorded nowhere), and the
    signature's planes pinned as capture pins them."""
    bs.warm(*sig, target)
    inp = torch.empty((2, sig[0], bs.s.ctx.n), dtype=torch.int32, device="meta")
    out, meta = bs._bootstrap(inp, *sig, target)
    rec = dict(inp=inp, out=out, meta=meta, keys=bs.s.keys, galois=bs.s.keys.galois,
               generation=0, conj=bs.s.keys.conj, ntt={"ntt_fwd_cuda": 3, "ntt_inv_cuda": 2})
    rec["graph"] = SimpleNamespace(replay=lambda: bs._bootstrap(inp, *sig, target))
    bs._pin(sig)
    bs._graphs[sig + (target,)] = rec


def _bookkeeping(bs):
    return dict(calls=bs.calls, pos=bs._pos, evictions=bs.evictions, reencodes=bs.reencodes,
                groups={sig: sorted(map(repr, (k for _, k, _ in g))) for sig, g in bs._groups.items()},
                group_bytes=dict(bs._group_bytes), planes=bs.cached_planes(),
                pinned=sorted(map(repr, (k for _, k in bs._pinned))))


@pytest.mark.parametrize("room", [True, False])
def test_replay_bookkeeping_equals_eager(room):
    """A request of A, B, A, B, A under a bound that holds A's planes and
    B's own (room), or of 0 bytes: A pinned, its bootstraps eager on one
    bootstrapper and replayed (a stand-in graph) on a twin; after every
    call the two keep the same counts, position, groups and planes, and the
    replays count their NTT records."""
    seq = [A, B, A, B, A]
    probe = _shape_bootstrapper(None, seq)
    size = lambda sig: sum(p[2] for p in probe._sig_planes[sig].values())
    own_b = sum(p[2] for e, p in probe._sig_planes[B].items() if e not in probe._sig_planes[A])
    budget = size(A) + own_b if room else 0
    eager, replayed = _shape_bootstrapper(budget, seq), _shape_bootstrapper(budget, seq)
    assert eager.graph_plan() == ({A: None, B: None} if room else
                                  {A: "dropped_group", B: "dropped_group"})
    eager.warm(*A, 1)
    eager._pin(A)
    _stand_in_graph(replayed, A, 1)
    assert _bookkeeping(eager) == _bookkeeping(replayed)
    n = eager.s.ctx.n
    for sig in seq:
        data = torch.empty((2, sig[0], n), dtype=torch.int32, device="meta")
        e_out, e_meta = eager.bootstrap(data, *sig, 1)
        r_out, r_meta = replayed.bootstrap(data, *sig, 1)
        assert e_meta == r_meta and e_out.shape == r_out.shape
        assert _bookkeeping(eager) == _bookkeeping(replayed)
    assert replayed.replays == 3 and eager.replays == 0
    assert replayed.replayed_ntt == {"ntt_fwd_cuda": 9, "ntt_inv_cuda": 6}


def test_batch_rows_keep_the_request_position():
    """A batch request of 2 rows over a request of A, B, A, B under a bound
    that holds one signature's planes: bootstrap_rows runs each window's
    rows at the place of the request's bootstrap they repeat, so after
    every window the sequence's position, the groups dropped and the planes
    encoded again are a single request's (without it the second row of the
    first A moved the request to its second A), with twice the calls."""
    seq = [A, B, A, B]
    probe = _shape_bootstrapper(None, seq)
    budget = max(sum(p[2] for p in probe._sig_planes[sig].values()) for sig in (A, B))
    single, batch = _shape_bootstrapper(budget, seq), _shape_bootstrapper(budget, seq)
    n = single.s.ctx.n
    for sig in seq + seq:
        out, meta = single.bootstrap(torch.empty((2, sig[0], n), dtype=torch.int32,
                                                 device="meta"), *sig, 1)
        rows, rows_meta = batch.bootstrap_rows(torch.empty((2, 2, sig[0], n), dtype=torch.int32,
                                                           device="meta"), *sig, 1)
        assert rows_meta == meta and rows.shape == (2,) + tuple(out.shape)
        one, two = _bookkeeping(single), _bookkeeping(batch)
        warm = 2                # each bootstrapper's warm-up of A and B
        assert two.pop("calls") - warm == 2 * (one.pop("calls") - warm)
        assert one == two
    assert single.evictions > 0 and single.reencodes > 0


def test_pinned_planes_never_dropped():
    """Under a bound of 0 bytes (only the running signature's planes stay)
    the pinned planes of A stay through B's bootstraps, which drop and
    encode again only B's; drop_graphs gives A's planes back to its group,
    and the bound then drops them, keeping only the group of B, the
    sequence's next signature."""
    seq = [A, B]
    bs = _shape_bootstrapper(0, seq)
    _stand_in_graph(bs, A, 1)
    pinned = dict(bs._pinned)
    assert pinned and A not in bs._groups and bs.graph_plan() == {A: "dropped_group",
                                                                 B: "dropped_group"}
    n = bs.s.ctx.n
    for sig in (B, A, B, A):
        before = bs.reencodes
        bs.bootstrap(torch.empty((2, 2, n), dtype=torch.int32, device="meta"), *sig, 1)
        assert all(key in cache for cache, key, _, _ in pinned.values())
        if sig == A:
            assert bs.reencodes == before and A not in bs._groups
    assert bs.evictions > 0 and bs.reencodes > 0
    bs.drop_graphs()
    assert not bs._pinned and not bs._graphs and len(bs._groups[A]) == len(pinned)
    bs.set_plane_budget(0)
    assert bs._sequence[bs._pos] == B and list(bs._groups) == [B]
    assert not any(key in cache for cache, key, _, _ in pinned.values())


def test_graph_plan_leaves_out_signatures_outside_the_sequence():
    """A signature that ran before the sequence was planned (another
    program on the same bootstrapper) runs in none of its requests: the
    plan neither lists it nor keeps room for its planes, so a bound that
    holds the sequence's signature alone pins it."""
    bs = _shape_bootstrapper(None, [A, B])
    assert set(bs._sig_planes) == {A, B}
    need = sum(p[2] for p in bs._sig_planes[A].values())
    bs.set_plane_budget(need, [A, A])
    assert bs.graph_plan() == {A: None}
    assert bs.graph_plan([B]) == {A: "dropped_group", B: "dropped_group"}


def test_capture_needs_the_card():
    """Off the card a signature cannot be captured, and says why."""
    from dacapo_tpu_torch.crypto.scheme import Scheme
    bs = NativeBootstrapper(Scheme("test_boot", device="cpu"), BootstrapConfig(**CFG))
    assert bs.capture_blocker() == "cpu"
    with pytest.raises(RuntimeError, match="cpu"):
        bs.capture(*A, 1)
    assert not bs._graphs and not bs._pinned


@pytest.fixture(scope="module")
def deep_executor(tmp_path_factory):
    """The test_boot deep circuit of tests/test_torch_executor_native.py (1
    bootstrap) in the port's executor on the CPU, and its input."""
    import dataclasses
    from dacapo_tpu_torch.crypto import params
    from dacapo_tpu_torch.crypto.scheme import Scheme
    from dacapo_tpu_torch.vm.executor import HEVMExecutor
    from test_torch_executor_native import PROFILE, SEED, WIDER, compile_test_boot
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _, payloads, path, _ = compile_test_boot(tmp_path_factory.mktemp("graphs"))
    s = Scheme(PROFILE, config=dataclasses.replace(params.PROFILES[PROFILE], **WIDER),
               seed=SEED, device="cpu")
    s.generate_keys()
    s.enable_native_bootstrap(BootstrapConfig(**CFG))
    ex = HEVMExecutor(s, HEVMProgram.load(path), payloads)
    ex.preprocess()
    x = np.random.default_rng(0).uniform(0.5, 0.55, s.ctx.config.n_slots)
    nl, scale = (ex.prog.arg_level[0] + 1) * ex.rr, float(2.0 ** ex.prog.arg_scale[0])
    yield ex, [(s.encrypt(x, scale=scale, nl=nl).data, nl, scale)]
    torch.set_num_threads(n_threads)


def test_executor_counts_eager_bootstraps(deep_executor):
    """The CPU runs every boot window eagerly ("cpu" where the card would
    replay), the per-op path under "per_op", with bit-equal outputs; the
    per-op path drops the graphs' pinned planes."""
    ex, args = deep_executor
    bs = ex.bootstrapper
    (wi, sig, why), = ex.boot_plan()
    assert ex.prog.ops and why is None and ex._segment_plan()[wi]["kind"] == "boot"
    seg = [to_host(c) for c in ex.run_encrypted(args)[0]]
    assert ex.last_bootstraps == dict(replayed=0, eager={"cpu": 1})
    bs._pin(sig[:2])
    assert bs._pinned
    per_op = [to_host(c) for c in ex.run_encrypted(args, jit=False)[0]]
    assert ex.last_bootstraps == dict(replayed=0, eager={"per_op": 1})
    assert not bs._pinned and not bs._graphs
    for a, b in zip(seg, per_op):
        np.testing.assert_array_equal(a, b)
