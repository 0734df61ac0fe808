"""The batch path through the native bootstrap on the CPU: the deep circuit of
tests/test_torch_executor_native.py (compiled by the JAX package for
test_boot with 40 Q primes, one bootstrap), on the full HEVM set up as in
tests/test_torch_server_native.py. One batched request of B=3 runs the
native bootstrap row by row, as the JAX package's run_encrypted_batch does
(it has no batched native bootstrap), and equals three single requests on
the same ciphertexts bit for bit. The single path and the batch of three
are held against the JAX package by tests/test_torch_executor_native.py,
whose JAX executor has compiled the native bootstrap's ops in its process
(here the JAX package's batch would compile them again: ~4 minutes on the
CPU).
precompile_batch on the CPU captures nothing and makes no key. The memory
plan of a batch (vm/executor.py: HEVMExecutor.path_budgets, plan_batch)
is held to stated numbers without a fixture."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig, NativeBootstrapper
from dacapo_tpu_torch.runtime import runner
from dacapo_tpu_torch.runtime.runner import HEVM
from dacapo_tpu_torch.vm.executor import BatchTooLarge, HEVMExecutor
from test_torch_executor_native import CFG, DEPTH, PROFILE, WIDER, _script, compile_test_boot

RMS_BAR = 1e-3      # tests/test_torch_executor_native.py's
B = 3


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch_native")
    _, _, hv, cst = compile_test_boot(tmp)
    keydir = str(tmp / "keys")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(params.PROFILES, PROFILE,
                   dataclasses.replace(params.PROFILES[PROFILE], **WIDER))
        mp.setattr(runner, "BootstrapConfig",
                   lambda radix: BootstrapConfig(radix=radix, **CFG))
        mp.setenv("DACAPO_TPU_BOOT", "native")
        vm = HEVM(PROFILE, keyset_dir=keydir, device="cpu")
        vm.load(cst, hv)
        keys = vm.scheme.keys
        before = (len(keys.galois), keys.conj is not None)
        precompiled = vm.precompile_batch(B)
        precompile_keys = (len(keys.galois), keys.conj is not None) != before
        xs = np.random.default_rng(0).uniform(0.5, 0.55, (B, vm.scheme.ctx.config.n_slots))
        vm.setInputBatch(0, xs)
        calls = vm.executor.bootstrapper.calls
        out = vm.runBatch()
        batch_calls = vm.executor.bootstrapper.calls - calls
        outs = [c.clone() for c in vm.executor._last_outputs[0]]
        data, nl, scale = vm._arg_cts_batch[0]
        singles = []
        for b in range(B):
            vm._arg_cts[0] = (data[b], nl, scale)
            singles.append((vm.run(), [c.clone() for c in vm.executor._last_outputs[0]]))
    torch.set_num_threads(n)
    return dict(vm=vm, xs=xs, out=out, outs=outs, singles=singles, batch_calls=batch_calls,
                precompiled=precompiled, precompile_keys=precompile_keys)


def test_native_bootstrap_runs_per_row(batched):
    assert isinstance(batched["vm"].executor.bootstrapper, NativeBootstrapper)
    assert batched["batch_calls"] == B


def test_batch_equals_single_requests(batched):
    assert batched["out"].shape[0] == B
    for b, (dec, cts) in enumerate(batched["singles"]):
        np.testing.assert_array_equal(batched["out"][b], dec)
        for got, want in zip(batched["outs"], cts):
            assert torch.equal(got[b], want)


def test_batch_rows_decrypt_to_the_model(batched):
    for b, x in enumerate(batched["xs"]):
        want = _script().deep_golden(x, DEPTH)
        rms = float(np.sqrt(np.mean((batched["out"][b][0] - want) ** 2)))
        assert rms < RMS_BAR, (b, rms)


def test_precompile_batch_on_the_cpu(batched):
    """On a native profile, off the card, precompile_batch captures nothing
    (the CPU runs the batch eagerly), returns 0 and makes no key; the
    test_boot limit is none (N < 2^15), so no batch plan either."""
    assert batched["precompiled"] == 0 and not batched["precompile_keys"]
    assert batched["vm"].executor.batch_plan is None


GB = 10 ** 9


def _bounded(budgets, pool=2 * GB, regs=GB // 2):
    """An executor with nothing but what plan_batch reads: the paths'
    budgets, the single request's segment graphs' pool and its registers."""
    ex = HEVMExecutor.__new__(HEVMExecutor)
    ex._path_budgets = budgets
    ex.capture_stats, ex.batch_capture_stats, ex.batch_plan = dict(pool_bytes=pool), None, None
    ex.register_bytes = lambda: regs
    return ex


def test_batch_memory_plan():
    """The plan with stated numbers, no fixture. A limit of 100 GB: keys
    30 GB and resident plaintexts 10 GB leave the native bootstrap's planes
    0.67 * 100 - 40 = 27 GB on the segment path. A batch of 4 of a request
    whose registers peak at 0.5 GB and whose segment graphs' pool took
    2 GB holds 4 * 0.5 + 4 * 2 = 10 GB beside the single request before its
    capture, so its planes get 17 GB; once the batch graphs' pool is
    measured (6 GB) 4 * 0.5 + 6 = 8 GB, so 19 GB (another size keeps the
    prediction); a batch of 11 (27.5 GB) cannot be held, and says with
    what. The plan is a query: it leaves batch_plan alone."""
    args = (100 * GB, 30 * GB, 10 * GB, False, 0)
    assert HEVMExecutor.path_budgets(*args) == dict(per_op=(0, 27 * GB), segment=(0, 27 * GB))
    ex = _bounded(HEVMExecutor.path_budgets(*args))
    plan = ex.plan_batch(4)
    assert (plan["batch_bytes"], plan["plane_budget"], plan["lru_budget"]) == (
        10 * GB, 17 * GB, 0)
    assert plan["batch_pool_bytes"] is None and plan["segment_plane_budget"] == 27 * GB
    ex.batch_capture_stats = dict(batch=4, pool_bytes=6 * GB)
    plan = ex.plan_batch(4)
    assert (plan["batch_bytes"], plan["plane_budget"], plan["batch_pool_bytes"]) == (
        8 * GB, 19 * GB, 6 * GB)
    assert ex.plan_batch(2)["plane_budget"] == 22 * GB
    # streaming plaintexts: the segment path's LRU (the eager windows' 1 GB)
    # stays the batch's, the planes lose it too
    streamed = _bounded(HEVMExecutor.path_budgets(100 * GB, 30 * GB, 10 * GB, True, GB))
    assert streamed._path_budgets["segment"] == (GB, 26 * GB)
    plan = streamed.plan_batch(4)
    assert (plan["lru_budget"], plan["plane_budget"]) == (GB, 16 * GB)
    with pytest.raises(BatchTooLarge) as e:
        ex.plan_batch(11)
    assert (e.value.need, e.value.room) == (27_500_000_000, 27 * GB)
    assert "27500000000" in str(e.value) and "27000000000" in str(e.value)
    assert ex.batch_plan is None and streamed.batch_plan is None
    # no plane bound (no memory limit, or no native bootstrap): no plan
    assert _bounded(None).plan_batch(4) is None


def test_precompile_batch_refuses_before_capture():
    """precompile_batch plans the batch before it captures anything: on an
    executor whose planes are bounded (the numbers of test_batch_memory_plan,
    the single request's pool measured at 2 GB) a batch of 11 raises
    BatchTooLarge and no capture starts; a batch of 4 is planned at a 17 GB
    plane bound before its capture and at the measured pool's 19 GB after
    it; drop_batch lets the capture go, and the plan is the prediction
    again."""
    ex = _bounded(HEVMExecutor.path_budgets(100 * GB, 30 * GB, 10 * GB, False, 0))
    captured = []

    def precompile_segments(batch):
        captured.append(batch)
        ex.batch_capture_stats = dict(batch=batch, pool_bytes=6 * GB)
        return 5

    ex.precompile_segments = precompile_segments
    ex.capture_oracle = lambda batch: 0
    vm = SimpleNamespace(executor=ex, device=torch.device("cuda"), jit="auto", load_seconds={})
    with pytest.raises(BatchTooLarge):
        HEVM.precompile_batch(vm, 11)
    assert not captured
    assert ex.plan_batch(4)["plane_budget"] == 17 * GB
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "synchronize", lambda device=None: None)
        assert HEVM.precompile_batch(vm, 4) == 5
    assert captured == [4]
    plan = ex.plan_batch(4)
    assert plan["batch_pool_bytes"] == 6 * GB and plan["batch_bytes"] == 8 * GB
    assert plan["plane_budget"] == 19 * GB and plan["segment_plane_budget"] == 27 * GB
    ex._captured_batch = object()
    ex.drop_batch()
    assert ex._captured_batch is None and ex.batch_capture_stats is None
    assert ex.plan_batch(4)["plane_budget"] == 17 * GB
