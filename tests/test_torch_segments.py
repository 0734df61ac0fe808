"""Segment execution (`jit="auto"`/`"segment"`) on the CPU, held against the
JAX package for two programs: the MLP (pars, waterline 25, test_n11) and the
bootstrapped deep circuit (dacapo, waterline 25, test_n10), compiled as in
tests/test_torch_mlp_e2e.py and tests/test_torch_executor_boot.py. The
window plan and the metadata walk equal the JAX executor's; the segment path
(every window eager here: graphs exist only on the card) gives output
ciphertexts bit-equal to the JAX per-op path. The JAX oracle runs on its
host-RNG path (DACAPO_TPU_ORACLE_JIT=0), which the port's oracle matches
with host_rng=True."""

import dataclasses
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.crypto.keys import GaloisStore
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.models.mlp import make_input
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP, OP_ENCODE, OP_ALLOC
from test_torch_executor_boot import compile_deep, PROFILE as DEEP_PROFILE
from test_torch_mlp_e2e import compile_mlp, PROFILE as MLP_PROFILE

ARTIFACT_N11 = (Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts"
                / "mlp_pars25_test_n11")


@pytest.fixture(scope="module", params=["mlp", "boot"])
def pair(request, tmp_path_factory):
    """The JAX executor after one per-op request and the port's after one
    segment request on the same keys (same seed) and input ciphertext."""
    tmp = tmp_path_factory.mktemp(request.param)
    mp = pytest.MonkeyPatch()
    mp.setenv("DACAPO_TPU_ORACLE_JIT", "0")
    try:
        if request.param == "mlp":
            profile = MLP_PROFILE
            prog, payloads, _, path, _ = compile_mlp(tmp)
            x = make_input(0)
        else:
            profile = DEEP_PROFILE
            n = RefScheme(profile).ctx.config.n_slots
            prog, payloads, path = compile_deep(tmp, n)
            x = np.random.default_rng(0).uniform(0.4, 0.9, n)
        ref_s = RefScheme(profile)
        ref_s.generate_keys()
        ref = RefExecutor(ref_s, prog, payloads)
        ref.preprocess()
        ref.run([x], jit=False)
        ref_cts = [np.asarray(c) for c in ref._last_outputs[0]]
        ref_meta = [tuple(m) for m in ref._last_outputs[1]]
    finally:
        mp.undo()

    s = Scheme(profile, device="cpu")
    s.generate_keys()
    port = HEVMExecutor(s, HEVMProgram.load(path), payloads, host_rng=True)
    port.preprocess()
    nl = (port.prog.arg_level[0] + 1) * port.rr
    scale = float(2.0 ** port.prog.arg_scale[0])
    arg_cts = [(s.encrypt(x, scale=scale, nl=nl).data, nl, scale)]
    outs, meta = port.run_encrypted(arg_cts, jit="segment")
    return dict(name=request.param, ref=ref, port=port, arg_cts=arg_cts,
                ref_cts=ref_cts, ref_meta=ref_meta, outs=outs, meta=meta,
                path=path, payloads=payloads)


def _op_key(op):
    return op.opcode, (op.rescale_dst if getattr(op, "fold_rescale", False) else op.dst)


def _plan_key(plan):
    return [dict(kind=w["kind"], ops=[_op_key(op) for op in w["ops"]], ins=list(w["ins"]),
                 outs=list(w["outs"]), writes=set(w["writes"]),
                 plain_regs=list(w["plain_regs"]), rot_steps=list(w["rot_steps"]),
                 has_mulcc=bool(w["has_mulcc"]))
            for w in plan]


@pytest.mark.parametrize("max_ops", [None, 8])
def test_segment_plan_equals_jax(pair, max_ops, monkeypatch):
    ref, port = pair["ref"], pair["port"]
    if max_ops is None:
        ref._seg_plan = None
        want, got = ref._segment_plan(), port._segment_plan()
        assert HEVMExecutor.SEGMENT_MAX_OPS == RefExecutor.SEGMENT_MAX_OPS == 96
        assert HEVMExecutor.SEGMENT_MIN_OPS == RefExecutor.SEGMENT_MIN_OPS == 4
    else:
        monkeypatch.setattr(RefExecutor, "SEGMENT_MAX_OPS", max_ops)
        ref._seg_plan = None
        want, got = ref._segment_plan(), port._window_plan(max_ops)
    ref._seg_plan = None
    assert len(got) > (1 if max_ops else 0)
    assert _plan_key(got) == _plan_key(want)


@pytest.mark.parametrize("max_ops", [96, 8, 1])
def test_plan_covers_the_stream(pair, max_ops):
    """Windows partition the stream in order; a bootstrap is a window of its
    own; a dead register is read by no later window and is not a result."""
    port = pair["port"]
    plan = port._window_plan(max_ops)
    stream = [op for op in port.ops if op.opcode not in (OP_ENCODE, OP_ALLOC)]
    assert [op for w in plan for op in w["ops"]] == stream
    for wi, w in enumerate(plan):
        if w["kind"] == "boot":
            assert [op.opcode for op in w["ops"]] == [OP_BOOTSTRAP]
        else:
            assert 0 < len(w["ops"]) <= max_ops
            assert all(op.opcode != OP_BOOTSTRAP for op in w["ops"])
        later = {r for v in plan[wi + 1:] for r in v["ins"]}
        assert not set(w["dead"]) & (later | set(port.res_dst))
        assert set(w["outs"]) <= w["writes"]


def test_trace_meta_equals_jax(pair):
    ref, port = pair["ref"], pair["port"]
    arg_meta = [(None, nl, sc) for _, nl, sc in pair["arg_cts"]]
    _, want = ref._trace_meta(arg_meta)
    assert [tuple(m) for m in port._trace_meta(arg_meta)] == [tuple(m) for m in want]
    assert [tuple(m) for m in pair["meta"]] == pair["ref_meta"]


def test_segment_outputs_bit_equal_to_jax_per_op(pair):
    got = [c.numpy().view(np.uint32) for c in pair["outs"]]
    assert len(got) == len(pair["ref_cts"]) >= 1
    for g, w in zip(got, pair["ref_cts"]):
        np.testing.assert_array_equal(g, w)


def test_jit_true_follows_the_jax_rule(pair, monkeypatch):
    """jit=True takes the segment path: the JAX rule for the bootstrapped
    program; for the MLP (one window) the whole-program function is not
    ported. The MLP's outputs stay bit-equal on the same ciphertext."""
    port = pair["port"]
    calls = []
    seg = port._run_segmented
    monkeypatch.setattr(port, "_run_segmented", lambda a: calls.append(1) or seg(a))
    outs, _ = port.run_encrypted(pair["arg_cts"], jit=True)
    assert calls == [1]
    if pair["name"] == "mlp":
        assert len(port._segment_plan()) == 1
        for g, w in zip(outs, pair["ref_cts"]):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


def test_last_outputs_survive_the_next_request(pair):
    port = pair["port"]
    x = make_input(5) if pair["name"] == "mlp" else np.full(
        port.s.ctx.config.n_slots, 0.5)
    first = port.run_encrypted(pair["arg_cts"])
    kept = [c.clone() for c in first[0]]
    port.run([x])
    assert all(a.equal(b) for a, b in zip(first[0], kept))
    assert not all(a.equal(b) for a, b in zip(port._last_outputs[0], kept))


def test_per_op_path_unchanged(pair):
    """jit=False still runs the per-op path; on the MLP (no randomness in the
    run) its outputs equal the segment path's on the same ciphertext."""
    port = pair["port"]
    before = port._seg_plan
    outs, meta = port.run_encrypted(pair["arg_cts"], jit=False)
    assert port._seg_plan is before
    assert [tuple(m) for m in meta] == pair["ref_meta"]
    if pair["name"] == "mlp":
        for g, w in zip(outs, pair["ref_cts"]):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


def test_no_graphs_on_the_cpu(pair):
    port = pair["port"]
    assert port.precompile_segments() == 0
    assert port._captured is None and port.replays == 0


def test_graphs_follow_the_key_store(pair, monkeypatch):
    """The graph cache as the card uses it, with the capture stubbed: kept
    while the keys stay, captured again after a device key tensor was
    replaced or the key set swapped, refused (and dropped) under a key
    budget, even one set after the capture."""
    port = pair["port"]
    captures = []
    monkeypatch.setattr(port.s, "device", torch.device("cuda"))
    monkeypatch.setattr(port, "_capture", lambda plan, meta: captures.append(1) or {0: None})
    monkeypatch.setattr(port, "_captured", None)
    meta = port._arg_meta()
    first = port._graphs(meta)
    assert port._graphs(meta) is first and len(captures) == 1
    galois = port.s.keys.galois
    st = next(iter(galois.keys()))
    gen = galois.generation
    galois[st] = galois[st].clone()
    assert galois.generation == gen + 1
    assert port._graphs(meta) is not first and len(captures) == 2
    port._graphs([(nl - port.rr, sc) for nl, sc in meta])
    assert len(captures) == 3
    monkeypatch.setattr(port.s, "keys", dataclasses.replace(port.s.keys))
    port._graphs(meta)
    assert len(captures) == 4
    monkeypatch.setattr(galois, "budget", 1 << 20)
    with pytest.raises(RuntimeError, match="jit=False"):
        port._graphs(meta)
    assert port._captured is None and len(captures) == 4


def test_galois_generation_counts_device_drops():
    """GaloisStore.generation grows when a device key tensor is dropped or
    replaced (set_budget, re-insertion, put_host, LRU eviction), not when a
    key is added or promoted."""
    store = GaloisStore("cpu")
    key = torch.zeros((4, 256), dtype=torch.int32)
    store[1] = key
    store.put_host(2, np.zeros((4, 256), dtype=np.uint32))
    store[2]
    assert store.generation == 0
    store[1] = key.clone()
    assert store.generation == 1
    store.put_host(1, np.ones((4, 256), dtype=np.uint32))
    assert store.generation == 2
    store.set_budget(key.nbytes)
    assert store.generation == 2
    store[1]
    assert store.generation == 3 and list(store._dev) == [1]
    store.set_budget(0)
    assert store.generation == 4 and not store._dev


def test_segment_profile(pair):
    port = pair["port"]
    port.set_profiling(True)
    try:
        port.run_encrypted(pair["arg_cts"], jit="segment")
    finally:
        port.set_profiling(False)
    prof = port.seg_profile
    plan = port._segment_plan()
    assert [p["wi"] for p in prof] == list(range(len(plan)))
    assert sum(p["kind"] == "boot" for p in prof) == sum(
        op.opcode == OP_BOOTSTRAP for op in port.ops)
    assert all(p["kind"] in ("boot", "eager") and p["s"] >= 0 for p in prof)
    out = io.StringIO()
    port.seg_report(out)
    assert out.getvalue().startswith(f"[segprof] total ") and f"over {len(plan)} windows" in out.getvalue()


def test_bad_jit_refused(pair):
    with pytest.raises(ValueError):
        pair["port"].run_encrypted(pair["arg_cts"], jit="fast")
    with pytest.raises(ValueError):
        HEVM(MLP_PROFILE, device="cpu", jit="fast")


@pytest.mark.parametrize("pair", ["mlp"], indirect=True)
def test_committed_test_n11_artifact(pair):
    """The card tests (tests/test_torch_graphs_cuda.py) run this committed
    copy of the test_n11 MLP program: it equals the JAX compiler's output."""
    got = Path(pair["path"])
    assert (ARTIFACT_N11 / "MLP.hevm").read_bytes() == got.read_bytes()
    assert (ARTIFACT_N11 / "MLP.cst").read_bytes() == got.with_suffix(".cst").read_bytes()
