"""The native bootstrapper's plane bound path by path
(vm/executor.py: HEVMExecutor.path_budgets, _use_path), on the CPU: under a
memory limit a per-op request and a segment request each run under their
own bounds on the plaintext LRU and the bootstrap's planes, `plane_bound`
lifts the latter, and the outputs are bit-equal. The deep circuit of
tests/test_torch_bootstrap_bound.py (depth 14, 3 bootstraps of 2 input
scales, test_boot with 40 Q primes)."""

import dataclasses

import numpy as np
import torch

from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram
from test_torch_bootstrap_bound import deep14  # noqa: F401  (the fixture)
from test_torch_executor_native import CFG, PROFILE, WIDER


def test_each_path_runs_under_its_bounds(deep14, monkeypatch):
    """Under a memory limit of 400 MiB (DACAPO_TPU_HBM_BYTES), with the
    plaintext budget at 2^-10 of it (the 9 plaintexts, 548,864 bytes as
    planes, stream) and the key budget at 0.6 (the 170 MB of keys stay):
    the executor's per-path budgets are HEVMExecutor.path_budgets'; a
    per-op request runs with the plaintext LRU at its whole budget and the
    planes at the per-op bound, a segment request with the LRU cut to the
    eager windows' plaintexts and the planes at the segment bound, and a
    segment request with `plane_bound` False drops no plane; the three
    outputs are bit-equal, and the bounded requests dropped planes."""
    _, hevm, payloads = deep14
    limit = 400 << 20
    monkeypatch.setenv("DACAPO_TPU_HBM_BYTES", str(limit))
    monkeypatch.setattr(HEVMExecutor, "PTXT_BUDGET_FRAC", 2.0 ** -10)
    monkeypatch.setattr(HEVMExecutor, "KEY_BUDGET_FRAC", 0.6)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = Scheme(PROFILE, config=dataclasses.replace(params.PROFILES[PROFILE], **WIDER),
                      seed=7, device="cpu")
        port.generate_keys()
        bs = port.enable_native_bootstrap(BootstrapConfig(**CFG))
        pex = HEVMExecutor(port, HEVMProgram.load(hevm), payloads)
        pex.preprocess()
        assert pex.streaming and pex.key_bytes < 0.6 * limit
        cid_info, _, cid_qp = pex._plaintext_plan()           # the same plan again
        budgets = HEVMExecutor.path_budgets(limit, pex.key_bytes, pex.pool_bytes, True,
                                            pex.eager_plain_bytes(cid_info, cid_qp))
        assert pex._path_budgets == budgets
        (lru_op, planes_op), (lru_seg, planes_seg) = budgets["per_op"], budgets["segment"]
        assert lru_op == pex._pt_budget and lru_seg <= lru_op and planes_op <= planes_seg
        assert bs.plane_budget == planes_seg                      # the load's warm-up
        nl, scale = (pex.prog.arg_level[0] + 1) * pex.rr, float(2.0 ** pex.prog.arg_scale[0])
        x = np.random.default_rng(0).uniform(0.5, 0.55, port.ctx.config.n_slots)
        ct = port.encrypt(x, scale=scale, nl=nl)
        outs = {}
        for kind, jit in (("per_op", False), ("segment", "auto"), ("free", "auto")):
            pex.plane_bound = kind != "free"
            evictions = bs.evictions
            outs[kind] = [to_host(c) for c in pex.run_encrypted([(ct.data, nl, scale)],
                                                                jit=jit)[0]]
            if kind == "per_op":
                assert bs.plane_budget == planes_op and pex._lru_budget == lru_op
                assert pex._pt_dev_bytes > 0
            elif kind == "segment":
                assert bs.plane_budget == planes_seg and pex._lru_budget == lru_seg
                assert pex._pt_dev_bytes <= lru_seg or len(pex._pt_dev) <= 1
            else:
                assert bs.plane_budget is None and bs.evictions == evictions
    finally:
        torch.set_num_threads(n_threads)
    for a, b, c in zip(outs["per_op"], outs["segment"], outs["free"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert bs.evictions >= 1 and bs.reencodes > 0
