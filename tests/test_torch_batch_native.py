"""The batch path through the native bootstrap on the CPU: the deep circuit of
tests/test_torch_executor_native.py (compiled by the JAX package for
test_boot with 40 Q primes, one bootstrap), on the full HEVM set up as in
tests/test_torch_server_native.py. One batched request of B=2 runs the
native bootstrap row by row, as the JAX package's run_encrypted_batch does
(it has no batched native bootstrap), and equals two single requests on the
same ciphertexts bit for bit; the single path is held against the JAX
package by tests/test_torch_executor_native.py."""

import dataclasses

import numpy as np
import pytest
import torch

from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig, NativeBootstrapper
from dacapo_tpu_torch.runtime import runner
from dacapo_tpu_torch.runtime.runner import HEVM
from test_torch_executor_native import CFG, DEPTH, PROFILE, WIDER, _script, compile_test_boot

RMS_BAR = 1e-3      # tests/test_torch_executor_native.py's
B = 2


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch_native")
    _, _, hv, cst = compile_test_boot(tmp)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(params.PROFILES, PROFILE,
                   dataclasses.replace(params.PROFILES[PROFILE], **WIDER))
        mp.setattr(runner, "BootstrapConfig",
                   lambda radix: BootstrapConfig(radix=radix, **CFG))
        mp.setenv("DACAPO_TPU_BOOT", "native")
        vm = HEVM(PROFILE, keyset_dir=str(tmp / "keys"), device="cpu")
        vm.load(cst, hv)
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
    return dict(vm=vm, xs=xs, out=out, outs=outs, singles=singles, batch_calls=batch_calls)


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
