"""The bound on the native bootstrapper's cached planes
(NativeBootstrapper.set_plane_budget, which vm/executor.py plans under a
memory limit, path by path: what the galois keys and the plaintexts leave of
their budgets, less the plaintext LRU's share on the path; Belady's rule over
the request's bootstrap signatures), on the CPU: outputs under a forced
bound are bit-equal to the unbounded port and to the JAX package's
RefExecutor, with the dropped and re-encoded planes counted
(tests/test_torch_plane_paths.py runs each path under its own bounds). The
deep circuit of
tests/test_torch_executor_native.py at depth 14, where its 3 bootstraps
take 2 input scales, on test_boot with 40 Q primes."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dacapo_tpu.crypto.bootstrap_native import BootstrapConfig as RefConfig
from dacapo_tpu.crypto.params import PROFILES as REF_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram
from test_torch_executor_native import CFG, PROFILE, WIDER, _script

ROOT = os.path.join(os.path.dirname(__file__), "..")

BOUND_DEPTH = 14      # the deep circuit's depth with two bootstrap input scales


@pytest.fixture(scope="module")
def deep14(tmp_path_factory):
    """The deep circuit at BOUND_DEPTH, compiled for test_boot: (.hevm path,
    payloads)."""
    tmp = tmp_path_factory.mktemp("bound")
    with open(os.path.join(ROOT, "dacapo_tpu", "profiles", "profiled_TPU_test_boot.json")) as f:
        prof = json.load(f)
    prof["levelUpperBound"] = prof["bootstrapLevelUpperBound"] = 9
    path = str(tmp / "profile.json")
    with open(path, "w") as f:
        json.dump(prof, f)
    prog, payloads = _script().compile_deep(str(tmp), PROFILE, BOUND_DEPTH, 25,
                                            compiler_profile=path)
    return prog, str(tmp / "Deep.hevm"), payloads


def test_bounded_planes_bit_equal(deep14):
    """The bound on the native bootstrapper's planes (set_plane_budget, what
    the executor plans under a memory limit): the deep circuit of depth 14
    (3 bootstraps, 2 input scales) on test_boot with 40 Q primes, run by the
    JAX package's RefExecutor and by the port's executor without a bound,
    then again on the same ciphertext with a bound of 0 bytes (only the
    running signature's planes stay): the three outputs are bit-equal, and
    the bounded run dropped planes and encoded them again."""
    prog, hevm, payloads = deep14
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = RefScheme(PROFILE, config=dataclasses.replace(REF_PROFILES[PROFILE], **WIDER),
                        seed=7)
        ref.generate_keys()
        ref.enable_native_bootstrap(RefConfig(**CFG))
        x = np.random.default_rng(0).uniform(0.5, 0.55, ref.ctx.config.n_slots)
        ex = RefExecutor(ref, prog, payloads)
        ex.preprocess()
        ex.run([x], jit=False)
        want = [np.asarray(c) for c in ex._last_outputs[0]]

        port = Scheme(PROFILE, config=dataclasses.replace(params.PROFILES[PROFILE], **WIDER),
                      seed=7, device="cpu")
        port.generate_keys()
        bs = port.enable_native_bootstrap(BootstrapConfig(**CFG))
        pex = HEVMExecutor(port, HEVMProgram.load(hevm), payloads)
        pex.preprocess()
        assert bs.plane_budget is None                    # no memory limit below 2^15
        seq = pex._boot_sequence()
        assert len(seq) == 3 and len(set(seq)) == 2
        nl, scale = (pex.prog.arg_level[0] + 1) * pex.rr, float(2.0 ** pex.prog.arg_scale[0])
        ct = port.encrypt(x, scale=scale, nl=nl)
        free = [to_host(c) for c in pex.run_encrypted([(ct.data, nl, scale)])[0]]
        bs.set_plane_budget(0, [(n, sc) for n, sc, _ in seq])
        bound = [to_host(c) for c in pex.run_encrypted([(ct.data, nl, scale)])[0]]
    finally:
        torch.set_num_threads(n_threads)
    for a, b, c in zip(free, bound, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert bs.evictions >= 1 and bs.reencodes > 0
    assert bs.cached_planes()["diagonals"] < 2 * 1276

