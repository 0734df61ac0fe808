"""Galois keys under a device budget on the segment path, on the CPU: the
KeyStream program of tests/test_torch_keystream_cuda.py (three rot-mac
layers, two host-RNG oracle bootstraps, test_n10), traced and compiled by the
port, run under DACAPO_TPU_HBM_BYTES = KEY_PLAN_BYTES by the JAX package and
by the port (its keys stream and so do its plaintexts). The port's graph
windows read their keys from the arena's slots (vm/executor.py `_key_arena`),
here eagerly, through the slot map and the staging the card runs:

(a) the plan: the same key and plaintext budgets as the JAX package, 8 slots
    for 11 keys;
(b) the segment path bit-equal to the JAX package's segment path, single
    and at B=3 (DACAPO_TPU_ORACLE_JIT=0 there, host_rng here), to the port's
    per-op path under the same budget and to a resident port run;
(c) at every window, its keys in its slots and the arena plus the LRU
    within the budget; a request copies the planned keys, no more than a
    plain LRU of as many slots;
(d) a replaced key reaches the next request; a budget changed after a
    request makes the arena again;
(e) plan_key_slots on random sequences: distinct slots within a window, the
    copies it reports equal to replaying its slot map, never more than an
    LRU's;
(f) the key store: pinned-slab host copies (plain memory on the CPU), the
    reserve, the peak, key versions.
The graphs on the card are tests/test_torch_keystream_cuda.py."""

import numpy as np
import pytest
import torch

from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.ir.serialize import read_cst as ref_read_cst
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram
from dacapo_tpu_torch.crypto.keys import GaloisStore
from dacapo_tpu_torch.crypto.scheme import Ciphertext, Scheme
from dacapo_tpu_torch.ir.serialize import read_cst
from dacapo_tpu_torch.vm.executor import (
    HEVMExecutor, key_slot_count, lru_key_copies, plan_key_slots)
from dacapo_tpu_torch.vm.hevm import HEVMProgram
from test_torch_batch import U
from test_torch_keystream_cuda import B, KEY_PLAN_BYTES, OFFSETS, PROFILE, build_program


def _inputs(n):
    rng = np.random.default_rng(21)
    return rng.uniform(-1, 1, n), rng.uniform(-1, 1, (B, n))


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    return build_program(tmp_path_factory.mktemp("keystream"))


@pytest.fixture(scope="module")
def jax_runs(program):
    """The JAX package under the plan: keys, galois keys, x encrypted, the
    segment request, the rows encrypted, the batch request."""
    cst, hevm, _ = program
    mp = pytest.MonkeyPatch()
    mp.setenv("DACAPO_TPU_HBM_BYTES", str(KEY_PLAN_BYTES))
    mp.setenv("DACAPO_TPU_ORACLE_JIT", "0")
    try:
        ref = RefScheme(PROFILE)
        ref.generate_keys()
        rex = RefExecutor(ref, RefProgram.load(hevm), ref_read_cst(cst))
        rex.preprocess()
        x, xs = _inputs(ref.ctx.config.n_slots)
        nl = (rex.prog.arg_level[0] + 1) * rex.rr
        scale = float(2.0 ** rex.prog.arg_scale[0])
        ct = np.asarray(ref.encrypt(x, scale=scale, nl=nl).data)
        single = rex.run_encrypted([(ct, nl, scale)], jit="segment")
        cts = np.stack([np.asarray(ref.encrypt(r, scale=scale, nl=nl).data) for r in xs])
        batch = rex.run_encrypted_batch([(cts, nl, scale)], mesh=None)
    finally:
        mp.undo()
    runs = {k: ([np.asarray(o) for o in outs], [tuple(m) for m in meta])
            for k, (outs, meta) in dict(single=single, batch=batch).items()}
    return dict(runs, key_budget=ref.keys.galois.budget, pt_budget=rex._pt_budget,
                streaming=rex._streaming, ct=ct, cts=cts)


def _port(program, plan=True):
    cst, hevm, _ = program
    mp = pytest.MonkeyPatch()
    if plan:
        mp.setenv("DACAPO_TPU_HBM_BYTES", str(KEY_PLAN_BYTES))
    try:
        s = Scheme(PROFILE, device="cpu")
        s.generate_keys()
        ex = HEVMExecutor(s, HEVMProgram.load(hevm), read_cst(cst), host_rng=True)
        ex.preprocess()
        ex.key_arena()                 # as HEVM.load makes it: filled for a request
    finally:
        mp.undo()
    return ex


def _serve(ex, checks=None):
    """The JAX fixture's sequence on a port executor: x encrypted, a segment
    request (then per-op from the same RNG state), the rows, a batch.
    checks(wi, info): called before each window that runs through
    `_seg_body`."""
    s = ex.s
    x, xs = _inputs(s.ctx.config.n_slots)
    nl = (ex.prog.arg_level[0] + 1) * ex.rr
    scale = float(2.0 ** ex.prog.arg_scale[0])
    ct = s.encrypt(x, scale=scale, nl=nl).data
    if checks is not None:
        body = ex._seg_body

        def checked(wi, info, ciphers, meta):
            checks(wi, info)
            return body(wi, info, ciphers, meta)

        ex._seg_body = checked
    rng = s.keygen.rng.bit_generator
    state = rng.state
    staged = dict(ex.key_staging)
    try:
        single = ex.run_encrypted([(ct, nl, scale)])
    finally:
        ex.__dict__.pop("_seg_body", None)
    copies = sum(ex.key_staging[k] - staged[k] for k in ("host", "device"))
    rng.state = state
    per_op = ex.run_encrypted([(ct, nl, scale)], jit=False)
    cts = torch.stack([s.encrypt(r, scale=scale, nl=nl).data for r in xs])
    batch = ex.run_encrypted_batch([(cts, nl, scale)])
    return dict(ct=ct, cts=cts, nl=nl, scale=scale, single=single, per_op=per_op,
                batch=batch, copies=copies)


@pytest.fixture(scope="module")
def served(program):
    ex = _port(program)
    windows = []

    def checks(wi, info):
        arena, galois = ex._arena, ex.s.keys.galois
        held = {st: torch.equal(arena["data"][s], torch.from_numpy(
                    galois.peek_host(st).view(np.int32)))
                for st, s in arena["slots"].get(wi, {}).items()}
        windows.append(dict(wi=wi, steps=list(info["rot_steps"]), held=held,
                            device_bytes=galois.device_bytes))

    out = _serve(ex, checks)
    return dict(out, ex=ex, windows=windows)


@pytest.fixture(scope="module")
def resident(program):
    ex = _port(program, plan=False)
    return dict(_serve(ex), ex=ex)


def test_plan_equals_jax(jax_runs, served, resident):
    ex = served["ex"]
    galois = ex.s.keys.galois
    assert galois.budget == jax_runs["key_budget"] == int(0.55 * KEY_PLAN_BYTES)
    assert ex._pt_budget == jax_runs["pt_budget"] and ex.streaming == jax_runs["streaming"]
    assert ex.streaming
    assert ex.n_keys == len({st for steps in OFFSETS for st in steps}) == 11
    assert len(ex._arena["held"]) == 8
    assert ex._arena["data"].shape[0] == 8 and galois.reserved == ex._arena["data"].nbytes
    assert resident["ex"]._arena is None and resident["ex"].s.keys.galois.budget is None
    plan = ex._segment_plan()
    graph_windows = [wi for wi, info in enumerate(plan) if ex._graph_window(info)]
    assert sorted(ex._arena["slots"]) == graph_windows and len(graph_windows) == 3


@pytest.mark.parametrize("path", ["single", "batch"])
def test_segment_bit_equal_to_jax(jax_runs, served, path):
    np.testing.assert_array_equal(U(served["ct"]), jax_runs["ct"])
    if path == "batch":
        np.testing.assert_array_equal(U(served["cts"]), jax_runs["cts"])
    outs, meta = served[path]
    want, want_meta = jax_runs[path]
    assert [tuple(m) for m in meta] == want_meta
    assert len(outs) == len(want) >= 1
    for got, w in zip(outs, want):
        np.testing.assert_array_equal(U(got), w)


@pytest.mark.parametrize("path", ["per_op", "resident", "resident_batch"])
def test_segment_equals_per_op_and_resident(served, resident, path):
    got = served["batch" if path == "resident_batch" else "single"]
    want = {"per_op": served["per_op"], "resident": resident["single"],
            "resident_batch": resident["batch"]}[path]
    assert got[1] == want[1]
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))


def test_near_the_plaintext_model(served, program):
    ex = served["ex"]
    x, _ = _inputs(ex.s.ctx.config.n_slots)
    outs, meta = served["single"]
    res = ex.s.decrypt(Ciphertext(outs[0], meta[0][1]))
    assert float(np.sqrt(np.mean((res - program[2](x)) ** 2))) < 5e-2


def test_keys_in_their_slots_at_every_window(served):
    ex = served["ex"]
    windows = served["windows"]
    plan = ex._segment_plan()
    assert [w["wi"] for w in windows] == [
        wi for wi, info in enumerate(plan) if ex._graph_window(info)]
    for w in windows:
        assert sorted(w["held"]) == sorted(w["steps"]) and all(w["held"].values())
        assert w["device_bytes"] <= ex.s.keys.galois.budget
    assert ex.s.keys.galois.peak_bytes <= ex.s.keys.galois.budget


def test_copies_as_planned(served):
    arena = served["ex"]._arena
    seq = [info["rot_steps"] for wi, info in enumerate(served["ex"]._segment_plan())
           if wi in arena["slots"]]
    assert served["copies"] == arena["copies"] > 0
    assert arena["copies"] <= arena["lru_copies"] == lru_key_copies(seq, len(arena["held"]))


def test_replaced_key_reaches_the_next_request(served):
    ex = served["ex"]
    galois = ex.s.keys.galois
    arg = [(served["ct"], served["nl"], served["scale"])]
    rng = ex.s.keygen.rng.bit_generator
    state = rng.state

    def run(jit="auto"):
        rng.state = state
        return ex.run_encrypted(arg, jit=jit)[0]

    before = run()
    original = galois.peek_host(10)          # step 10: the last layer only
    staged = ex.key_staging["host"]
    galois.put_host(10, galois.peek_host(11))
    try:
        wrong = run()
        assert ex.key_staging["host"] > staged
        assert not all(torch.equal(a, b) for a, b in zip(wrong, before))
        assert all(torch.equal(a, b) for a, b in zip(wrong, run(jit=False)))
    finally:
        galois.put_host(10, original)
    assert all(torch.equal(a, b) for a, b in zip(run(), before))


def test_budget_changed_makes_the_arena_again(program):
    ex = _port(program)
    galois = ex.s.keys.galois
    first = ex._arena
    kb = ex.s.galois_key_bytes()
    ex.s.set_key_budget(galois.budget + kb)
    second = ex._key_arena()
    assert second is not first and second["serial"] == first["serial"] + 1
    assert len(second["held"]) == 9 and galois.reserved == 9 * kb
    assert ex._key_arena() is second
    ex.s.set_key_budget(None)
    assert ex._key_arena() is None and ex._arena is None and galois.reserved == 0


@pytest.mark.parametrize("seed", range(4))
def test_plan_key_slots_invariants(seed):
    rng = np.random.default_rng(seed)
    keys = list(range(40))
    seq = [list(rng.choice(keys, size=rng.integers(0, 9), replace=False))
           for _ in range(30)]
    for n_slots in (8, 16, 39):
        maps, start, copies = plan_key_slots(seq, n_slots)
        assert len(maps) == len(seq) and len(start) == n_slots
        for ks, m in zip(seq, maps):
            assert sorted(m) == sorted(ks) and len(set(m.values())) == len(ks)
            assert all(0 <= s < n_slots for s in m.values())
        # replaying the fixed map from `start` copies what it reports, and
        # ends where it started
        held = list(start)
        replayed = 0
        for ks, m in zip(seq, maps):
            for k in ks:
                if held[m[k]] != k:
                    held[m[k]] = k
                    replayed += 1
        assert replayed == copies and held == start
        assert copies <= lru_key_copies(seq, n_slots)
    assert key_slot_count(seq, 20 * 100, 100) == 19
    assert key_slot_count(seq, 20 * 100, 100, reserved=100) == 18
    assert key_slot_count(seq, 3 * 100, 100) == max(map(len, seq))
    assert key_slot_count([[1, 2]], 20 * 100, 100) == 2


def test_store_pins_reserves_and_versions():
    store = GaloisStore("cpu")
    keys = {st: np.full((2, 8), st, dtype=np.uint32) for st in range(1, 6)}
    for st, arr in keys.items():
        store[st] = arr
    nbytes = keys[1].nbytes
    store.set_budget(3 * nbytes)
    assert len(store._dev) == 3 and store.peak_bytes == 5 * nbytes
    store.pin_host()
    assert all(isinstance(store._host[st], torch.Tensor) for st in keys)
    assert len(store._slabs) == 1 and not store._slabs[0].is_pinned()
    for st, arr in keys.items():
        np.testing.assert_array_equal(store.peek_host(st), arr)
        src, on_device = store.stage_source(st)
        assert on_device == (st in store._dev)
        np.testing.assert_array_equal(src.numpy().view(np.uint32), arr)
    store.peak_bytes = 0
    store.reserve(2 * nbytes)
    assert store._dev_bytes <= nbytes and store.device_bytes <= store.budget
    store[1]
    store[2]                                   # one stays, however tight
    assert list(store._dev) == [2] and store.peak_bytes == 3 * nbytes
    row = store._host[3]
    v, gen = store.version(3), store.generation
    store.put_host(3, np.zeros((2, 8), dtype=np.uint32))
    assert store._host[3] is row and store.version(3) == v + 1
    assert not store.peek_host(3).any() and store.version(4) == 0
    store[6] = np.ones((2, 8), dtype=np.uint32)      # a new key: no version
    assert store.version(6) == 0 and store.generation == gen
