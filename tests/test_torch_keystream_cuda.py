"""Galois keys under a device budget as CUDA graphs, on the card: the
KeyStream program (three rot-mac layers over overlapping rotation offsets,
two oracle bootstraps between them; test_n10), traced and compiled by the
port, served by HEVM under DACAPO_TPU_HBM_BYTES = KEY_PLAN_BYTES, which puts
its 11 galois keys under a budget of 9 (the arena gets 8 slots, so a request
copies keys into them) and streams its plaintexts. Every window of at least
SEGMENT_MIN_OPS ops is a graph that reads its keys from the arena; the
outputs equal the per-op path (the key store's LRU) and a resident VM's bit
for bit, single and in B=3 batch graphs; a request copies the planned keys;
a replaced key reaches the next request without a capture. Imports no JAX:
    python -m pytest --noconftest tests/test_torch_keystream_cuda.py -m cuda
Without a card every case skips (a CUDA graph has no CPU mode).
tests/test_torch_keystream.py runs the same program (build_program below)
on the CPU against the JAX package."""

import os

import numpy as np
import pytest
import torch

PROFILE = "test_n10"
# rotation offsets of the three layers: 11 keys, at most 7 in one window
OFFSETS = ((1, 2, 3, 4, 5, 6), (3, 4, 5, 6, 7, 8, 9), (1, 2, 9, 10, 11))
# 55 % of it holds 9 keys of test_n10 (196,608 B each): 8 arena slots and
# one of room for the LRU; 12 % of it is less than the plaintexts' bytes
KEY_PLAN_BYTES = 3_300_000
B = 3


def build_program(tmp):
    """Trace and compile KeyStream (pars, waterline 25) with the port into
    tmp. Returns (cst path, hevm path, golden: x -> the plaintext model)."""
    from dacapo_tpu_torch.crypto.params import PROFILES
    from dacapo_tpu_torch.ir import trace as trace_mod
    from dacapo_tpu_torch.runtime.harness import compile_traced, trace_and_save
    n = PROFILES[PROFILE].n_slots
    rng = np.random.default_rng(11)
    w = [rng.normal(0, 0.3, (len(steps), n)) for steps in OFFSETS]

    def layers(x, rotate, plain, bootstrap):
        h = x
        for layer, steps in enumerate(OFFSETS):
            acc = None
            for i, st in enumerate(steps):
                t = rotate(h, st) * plain(w[layer][i])
                acc = t if acc is None else acc + t
            h = acc + 0.1
            h = h * h
            if layer < len(OFFSETS) - 1:
                h = bootstrap(h)
        return h

    def body(x):
        return layers(x, lambda h, st: h.rotate(st), trace_mod.Plain, trace_mod.bootstrap)

    def golden(x):
        return layers(np.asarray(x, dtype=np.float64), lambda h, st: np.roll(h, -st),
                      lambda v: v, lambda h: h)

    traced = os.path.join(str(tmp), "traced")
    trace_and_save("KeyStream", "c", body, traced)
    hevm = compile_traced("KeyStream", "pars", 25, PROFILE, traced,
                          os.path.join(str(tmp), "optimized"))
    return os.path.join(traced, "_hecate_KeyStream.cst"), hevm, golden


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    return build_program(tmp_path_factory.mktemp("keystream"))


def _load(program, keydir, plan=True):
    from dacapo_tpu_torch import HEVM
    mp = pytest.MonkeyPatch()
    if plan:
        mp.setenv("DACAPO_TPU_HBM_BYTES", str(KEY_PLAN_BYTES))
    try:
        vm = HEVM(PROFILE, keyset_dir=str(keydir))
        vm.load(*program[:2])
    finally:
        mp.undo()
    return vm


@pytest.fixture(scope="module")
def vms(program, tmp_path_factory):
    keydir = tmp_path_factory.mktemp("keys_n10")
    return _load(program, keydir), _load(program, keydir, plan=False)


def _args(vm, seed, batch=False):
    n = vm.scheme.ctx.config.n_slots
    rng = np.random.default_rng(seed)
    if batch:
        vm.setInputBatch(0, rng.uniform(-1, 1, (B, n)))
        return [vm._arg_cts_batch[0]]
    vm.setInput(0, rng.uniform(-1, 1, n))
    return [vm._arg_cts[0]]


def _run(vm, args, state, jit="auto", batch=False):
    """Outputs of one request from the oracle generator's `state`."""
    ex = vm.executor
    ex.bootstrapper.gen.set_state(state)
    outs, _ = ex.run_encrypted_batch(args) if batch else ex.run_encrypted(args, jit=jit)
    torch.cuda.synchronize()
    return [o.clone() for o in outs]


@pytest.mark.cuda
def test_load_makes_the_arena(vms):
    vm, resident = vms
    ex, galois = vm.executor, vm.scheme.keys.galois
    stats = ex.capture_stats
    assert galois.budget is not None and ex.streaming
    assert {"key_pin", "key_arena", "capture"} <= set(vm.load_seconds)
    assert stats["graphs"] >= 3 and stats["key_slots"] == 8
    assert stats["key_arena_bytes"] == 8 * vm.scheme.galois_key_bytes()
    assert 0 < stats["key_copies_planned"] <= stats["key_copies_lru"]
    assert all(slab.is_pinned() for slab in galois._slabs)
    assert resident.scheme.keys.galois.budget is None and resident.executor._arena is None
    assert resident.executor.capture_stats["key_slots"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [False, True], ids=["single", "B3"])
def test_budget_graphs_equal_per_op_and_resident(vms, batch):
    vm, resident = vms
    ex, galois = vm.executor, vm.scheme.keys.galois
    args = _args(vm, 3, batch)
    if batch:
        vm.precompile_batch(B)
    captured = ex._captured_batch if batch else ex._captured
    state = ex.bootstrapper.gen.get_state()
    staged, replays = dict(ex.key_staging), ex.replays
    got = _run(vm, args, state, batch=batch)
    graphs = len(captured[-1])
    assert ex.replays - replays == graphs >= 3
    assert (ex._captured_batch if batch else ex._captured) is captured
    copies = sum(ex.key_staging[k] - staged[k] for k in ("host", "device"))
    assert copies == ex._arena["copies"]
    assert galois.peak_bytes <= galois.budget
    if not batch:
        assert all(torch.equal(a, b) for a, b in zip(got, _run(vm, args, state, jit=False)))
    want = _run(resident, args, state, batch=batch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_replaced_key_is_staged(vms):
    vm = vms[0]
    ex, galois = vm.executor, vm.scheme.keys.galois
    args = _args(vm, 4)
    state = ex.bootstrapper.gen.get_state()
    before = _run(vm, args, state)
    captured = ex._captured
    original = galois.peek_host(10)
    galois.put_host(10, galois.peek_host(11))     # a wrong key for step 10
    try:
        wrong = _run(vm, args, state)
        assert ex._captured is captured
        assert not all(torch.equal(a, b) for a, b in zip(wrong, before))
        assert all(torch.equal(a, b) for a, b in zip(wrong, _run(vm, args, state, jit=False)))
    finally:
        galois.put_host(10, original)
    assert all(torch.equal(a, b) for a, b in zip(_run(vm, args, state), before))
