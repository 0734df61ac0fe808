"""Segment execution as CUDA graphs, on the card: the committed test_n11 MLP
program (artifacts/mlp_pars25_test_n11, the JAX compiler's output, checked by
tests/test_torch_segments.py) loaded by HEVM, whose load captures the graphs.
Graph replay is bit-equal to per-op dispatch, replays repeat, outputs
survive later requests, graphs under a galois-key budget (set before the
capture or after it) read their keys from the key arena, bit-equal to
per-op, a replaced resident key is captured again, and the NTT kernels
that replays run are counted on the device: the wrapper counts no capture
and no replay. Imports no JAX:
    python -m pytest tests/test_torch_graphs_cuda.py -m cuda
Without a card every case skips (a CUDA graph has no CPU mode)."""

from pathlib import Path

import pytest
import torch

from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.crypto.cuda import ntt_kernel
from dacapo_tpu_torch.models.mlp import make_input

ART = Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts" / "mlp_pars25_test_n11"


def _load(keydir, jit="auto"):
    vm = HEVM("test_n11", keyset_dir=str(keydir), device="cuda", jit=jit)
    vm.load(str(ART / "MLP.cst"), str(ART / "MLP.hevm"))
    return vm


@pytest.fixture(scope="module")
def keydir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    return tmp_path_factory.mktemp("keys_n11")


@pytest.fixture(scope="module")
def vm(keydir):
    return _load(keydir)


def _args(vm, seed):
    vm.setInput(0, make_input(seed))
    return [vm._arg_cts[0]]


@pytest.mark.cuda
def test_capture_at_load(vm):
    stats = vm.executor.capture_stats
    assert "capture" in vm.load_seconds
    graphs = vm.executor._captured[-1]
    assert stats["graphs"] == len(graphs) >= 1 and stats["capture_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("jit", ["segment", True])
def test_graphs_bit_equal_to_per_op(vm, jit):
    args = _args(vm, 0)
    got, meta = vm.executor.run_encrypted(args, jit=jit)
    want, want_meta = vm.executor.run_encrypted(args, jit=False)
    torch.cuda.synchronize()
    assert meta == want_meta
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_replays_repeat_and_outputs_survive(vm):
    args0, args1 = _args(vm, 0), _args(vm, 1)
    first, _ = vm.executor.run_encrypted(args0)
    kept = [c.clone() for c in first]
    again, _ = vm.executor.run_encrypted(args0)
    other, _ = vm.executor.run_encrypted(args1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, kept))
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not all(torch.equal(a, b) for a, b in zip(other, kept))


def _profiled(fn):
    """NTT calls the wrapper counted and the device ran, over fn()."""
    from torch.profiler import profile, ProfilerActivity
    for k in ntt_kernel.LAUNCHES:
        ntt_kernel.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(ntt_kernel.LAUNCHES), ntt_kernel.launches_in_profile(prof.key_averages())


@pytest.mark.cuda
def test_ntt_launches_in_graphs_counted_on_device(vm):
    ex = vm.executor
    graphs = ex._captured[-1]
    args = _args(vm, 2)
    # per-op: the wrapper counts every call, and the trace agrees
    host, dev = _profiled(lambda: ex.run_encrypted(args, jit=False))
    assert host == dev and min(dev.values()) > 0
    replays = ex.replays
    seg_host, seg_dev = _profiled(lambda: ex.run_encrypted(args))
    assert ex.replays - replays == len(graphs)
    assert seg_dev == dev
    assert all(seg_host[k] < dev[k] for k in dev)      # the replayed calls are not the wrapper's
    # a capture records kernels and launches none: capturing the program's
    # one window again, its device caches full, records at once with no
    # eager warm-up, and the wrapper counts nothing
    assert len(ex._segment_plan()) == len(graphs) == 1
    for k in ntt_kernel.LAUNCHES:
        ntt_kernel.LAUNCHES[k] = 0
    ex._captured = None
    ex.precompile_segments()
    assert ex.capture_stats["warmed"] == 0 and ex.capture_stats["warmup_s"] == 0
    assert ntt_kernel.LAUNCHES == dict.fromkeys(host, 0)


@pytest.mark.cuda
def test_key_budget_refuses_graphs(keydir, vm):
    """A key budget set before the capture no longer refuses graphs: the
    graph reads its keys from the arena (here wider than the budget: the
    program's one window reads every key), bit-equal to per-op."""
    per_op = _load(keydir, jit=False)
    per_op.scheme.set_key_budget(1 << 20)
    ex = per_op.executor
    args = _args(per_op, 0)
    want, _ = ex.run_encrypted(args, jit=False)
    staged = ex.key_staging["host"]
    assert ex.precompile_segments() == len(ex._captured[-1]) >= 1
    assert ex.capture_stats["key_slots"] == ex.n_keys
    got, _ = ex.run_encrypted(args, jit="segment")
    torch.cuda.synchronize()
    assert ex.key_staging["host"] - staged == ex.n_keys     # filled once, at the arena
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_key_budget_after_load_refuses_replay(keydir):
    """A key budget set after the load: the next request captures once more,
    over the arena, and replays from then on; bit-equal to per-op."""
    seg = _load(keydir)
    ex = seg.executor
    args = _args(seg, 0)
    want, _ = ex.run_encrypted(args, jit=False)
    first = ex._captured
    seg.scheme.set_key_budget(1 << 20)
    replays = ex.replays
    got, _ = ex.run_encrypted(args)
    assert ex._captured is not first and ex.replays == replays + len(ex._captured[-1])
    assert ex.capture_stats["key_slots"] > 0
    again, _ = ex.run_encrypted(args)
    assert ex._captured[-1] is not first[-1]
    captured = ex._captured
    ex.run_encrypted(args)
    assert ex._captured is captured
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(again, want))


@pytest.mark.cuda
def test_replaced_key_is_captured_again(keydir):
    seg = _load(keydir)
    ex = seg.executor
    args = _args(seg, 1)
    first = ex._captured[-1]
    galois = seg.scheme.keys.galois
    for st in list(galois._dev):
        galois[st] = galois[st].clone()      # same key at a new address
    got, _ = ex.run_encrypted(args)
    assert ex._captured[-1] is not first
    want, _ = ex.run_encrypted(args, jit=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
