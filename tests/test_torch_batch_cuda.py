"""The batch path as CUDA graphs, on the card: the committed test_n11 MLP
(artifacts/mlp_pars25_test_n11) loaded by HEVM, whose load captures the
single-request graphs, then precompile_batch(4) the batch graphs beside
them. The batch graphs'
rows equal the single path's rows and the CPU batch bit for bit, replays
repeat, and a replaced galois key makes the batch graphs capture again.
Imports no JAX:
    python -m pytest --noconftest tests/test_torch_batch_cuda.py -m cuda
Without a card every case skips (a CUDA graph has no CPU mode)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.models.mlp import make_input

ART = Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts" / "mlp_pars25_test_n11"
B = 4


def _load(keydir, device="cuda"):
    vm = HEVM("test_n11", keyset_dir=str(keydir), device=device)
    vm.load(str(ART / "MLP.cst"), str(ART / "MLP.hevm"))
    vm.precompile_batch(B)
    return vm


@pytest.fixture(scope="module")
def keydir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    return tmp_path_factory.mktemp("keys_n11_batch")


@pytest.fixture(scope="module")
def vm(keydir):
    return _load(keydir)


def _batch(vm, seed):
    vm.setInputBatch(0, np.stack([make_input(seed + b) for b in range(B)]))
    return [vm._arg_cts_batch[0]]


@pytest.mark.cuda
def test_batch_graphs_captured_at_load(vm):
    ex = vm.executor
    assert "batch_capture" in vm.load_seconds and "capture" in vm.load_seconds
    graphs = ex._captured_batch[-1]
    assert ex.batch_capture_stats["graphs"] == len(graphs) >= 1
    assert ex.batch_capture_stats["batch"] == B
    assert all(rec["ins"][0].shape[0] == B for rec in graphs.values())
    assert ex._captured[-1] is not graphs


@pytest.mark.cuda
def test_batch_rows_equal_single_path_and_cpu(vm, keydir):
    ex = vm.executor
    args = _batch(vm, 0)
    replays = ex.replays
    outs, meta = ex.run_encrypted_batch(args)
    assert ex.replays - replays == len(ex._captured_batch[-1])
    outs = [o.clone() for o in outs]
    data, nl, scale = args[0]
    for b in range(B):
        single, single_meta = ex.run_encrypted([(data[b], nl, scale)])
        assert single_meta == meta
        assert all(torch.equal(o[b], s) for o, s in zip(outs, single))
    cpu = _load(keydir, device="cpu")
    cpu_outs, cpu_meta = cpu.executor.run_encrypted_batch([(data.cpu(), nl, scale)])
    assert cpu_meta == meta
    assert all(torch.equal(o.cpu(), c) for o, c in zip(outs, cpu_outs))
    again, _ = ex.run_encrypted_batch(args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, o) for a, o in zip(again, outs))


@pytest.mark.cuda
def test_run_batch_decrypts_per_row(vm):
    _batch(vm, 5)
    out = vm.runBatch()
    assert out.shape == (B, vm.prog.res_length, vm.scheme.ctx.config.n_slots)
    assert np.isfinite(out).all()
    assert not np.array_equal(out[0], out[1])


@pytest.mark.cuda
def test_replaced_key_captures_the_batch_graphs_again(keydir):
    vm = _load(keydir)
    ex = vm.executor
    args = _batch(vm, 1)
    first, first_single = ex._captured_batch[-1], ex._captured[-1]
    galois = vm.scheme.keys.galois
    for st in list(galois._dev):
        galois[st] = galois[st].clone()      # same key at a new address
    got, _ = ex.run_encrypted_batch(args)
    assert ex._captured_batch[-1] is not first
    assert ex._captured[-1] is first_single          # the single graphs wait for their use
    data, nl, scale = args[0]
    want, _ = ex.run_encrypted([(data[2], nl, scale)], jit=False)
    torch.cuda.synchronize()
    assert all(torch.equal(g[2], w) for g, w in zip(got, want))
