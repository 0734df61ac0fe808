"""The whole-program path (`jit=True`) on the card: one CUDA graph a
request. The committed test_n11 MLP (artifacts/mlp_pars25_test_n11) loaded
by HEVM(jit=True), whose load captures the whole-program graph and no
segment graph: its replay is byte-equal to the segment and per-op requests,
a segment request between two whole-program requests drops the graph and
the next one captures it again, a replaced key is captured again, and a
capture that uploads under capture raises and keeps no graph. The committed
deep tpu_n15b program (artifacts/deep_dacapo40_tpu_n15b, 2 native
bootstraps) as one graph: both bootstraps recorded inline and counted as
replays, one graph launch a request, byte-equal to its segment and per-op
requests. Imports no JAX:
    python -m pytest tests/test_torch_whole_cuda.py -m cuda
Without a card every case skips (a CUDA graph has no CPU mode)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.models.mlp import make_input

ARTIFACTS = Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts"
MLP = ARTIFACTS / "mlp_pars25_test_n11"
DEEP = ARTIFACTS / "deep_dacapo40_tpu_n15b"


def _load(keydir, jit=True):
    vm = HEVM("test_n11", keyset_dir=str(keydir), device="cuda", jit=jit)
    vm.load(str(MLP / "MLP.cst"), str(MLP / "MLP.hevm"))
    return vm


def _args(vm, seed):
    vm.setInput(0, make_input(seed))
    return [vm._arg_cts[0]]


def _whole(ex):
    """The whole-program graph's record the executor holds, else None."""
    held = ex._captured
    return held[-1] if held is not None and held[0][0] == "whole" else None


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def keydir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    return tmp_path_factory.mktemp("keys_n11")


@pytest.mark.cuda
def test_whole_capture_at_load(keydir):
    vm = _load(keydir)
    ex = vm.executor
    stats = ex.capture_stats["whole"]
    assert "whole_capture" in vm.load_seconds and "capture" not in vm.load_seconds
    assert _whole(ex) is not None and ex._captured[-1] is _whole(ex)
    assert stats["graphs"] == 1 and stats["bootstraps"] == 0 and stats["capture_s"] > 0
    assert stats["nodes"] > 0
    assert min(stats["ntt_in_graphs"].values()) > 0


@pytest.mark.cuda
def test_whole_equals_segment_and_per_op(keydir):
    """whole, segment, whole, per-op on one ciphertext: the segment request
    captures the segment graphs and drops the whole-program graph, the next
    jit=True request captures it again; one replay a whole request."""
    vm = _load(keydir)
    ex = vm.executor
    args = _args(vm, 0)
    first = _whole(ex)
    replays = ex.replays
    whole, meta = ex.run_encrypted(args, jit=True)
    assert ex.last_path == ("whole", None) and ex.replays == replays + 1
    kept = [c.clone() for c in whole]
    seg, seg_meta = ex.run_encrypted(args, jit="segment")
    assert ex.last_path == ("segment", None) and _whole(ex) is None
    again, _ = ex.run_encrypted(args, jit=True)
    assert _whole(ex) is not None and _whole(ex) is not first
    per_op, op_meta = ex.run_encrypted(args, jit=False)
    torch.cuda.synchronize()
    assert meta == seg_meta == op_meta
    for other in (whole, seg, again, per_op):
        assert _equal(other, kept)


@pytest.mark.cuda
def test_whole_replaced_key_is_captured_again(keydir):
    vm = _load(keydir)
    ex = vm.executor
    args = _args(vm, 1)
    first = _whole(ex)
    galois = vm.scheme.keys.galois
    for st in list(galois._dev):
        galois[st] = galois[st].clone()      # same key at a new address
    got, _ = ex.run_encrypted(args, jit=True)
    assert _whole(ex) is not None and _whole(ex) is not first
    want, _ = ex.run_encrypted(args, jit=False)
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.cuda
def test_whole_failed_capture_raises(keydir, monkeypatch):
    """A host-to-device copy under capture fails the capture: it raises and
    keeps no graph; the next request captures it again."""
    vm = _load(keydir)
    ex = vm.executor
    args = _args(vm, 2)
    stream = ex._exec_stream

    def uploads_under_capture(*a, **k):
        out = stream(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            torch.ones(4).to("cuda")
        return out

    monkeypatch.setattr(ex, "_exec_stream", uploads_under_capture)
    ex._captured = None
    with pytest.raises(RuntimeError):
        ex.run_encrypted(args, jit=True)
    assert ex._captured is None
    monkeypatch.undo()
    got, _ = ex.run_encrypted(args, jit=True)
    want, _ = ex.run_encrypted(args, jit=False)
    torch.cuda.synchronize()
    assert ex.last_path == ("per_op", None) and _equal(got, want)


@pytest.mark.cuda
def test_deep_program_one_graph(tmp_path):
    """The deep tpu_n15b program under HEVM(jit=True): the load captures one
    graph holding both native bootstraps; a request replays it once, counts
    2 bootstrap replays (calls, replays, the graph's inline ones) and equals
    the segment and per-op requests byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    vm = HEVM("tpu_n15b", keyset_dir=str(tmp_path / "keys"), jit=True)
    vm.load(str(DEEP / "Deep.cst"), str(DEEP / "Deep.hevm"))
    ex = vm.executor
    bs = ex.bootstrapper
    stats = ex.capture_stats["whole"]
    assert "whole_capture" in vm.load_seconds and not bs._graphs
    assert stats["bootstraps"] == 2 and len(stats["signatures"]) == 1
    x = np.random.default_rng(0).uniform(0.5, 0.55, vm.scheme.ctx.config.n_slots)
    nl, scale = (ex.prog.arg_level[0] + 1) * ex.rr, float(2.0 ** ex.prog.arg_scale[0])
    args = [(vm.scheme.encrypt(x, scale=scale, nl=nl).data, nl, scale)]
    before = (bs.calls, bs.replays, bs.inlined, ex.replays)
    outs, counts = [], []
    for jit in (True, "auto", False):
        outs.append([to_host(c) for c in ex.run_encrypted(args, jit=jit)[0]])
        counts.append((ex.last_path, ex.last_bootstraps))
        if jit is True:
            assert (bs.calls, bs.replays, bs.inlined, ex.replays) == (
                before[0] + 2, before[1] + 2, before[2] + 2, before[3] + 1)
    assert counts == [(("whole", None), dict(replayed=2, eager={})),
                      (("segment", None), dict(replayed=2, eager={})),
                      (("per_op", None), dict(replayed=0, eager={"per_op": 2}))]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)
