"""Plaintext streaming as CUDA graphs, on the card: the committed test_n11
MLP (artifacts/mlp_pars25_test_n11) loaded by HEVM, then forced to stream
by a plaintext budget below its plaintext bytes and preprocessed again (its
galois keys outweigh its plaintexts 5 to 1, so no DACAPO_TPU_HBM_BYTES
streams its plaintexts without also budgeting the keys, which
tests/test_torch_keystream_cuda.py covers). The graphs decode their plaintexts from the compact pool in-graph;
their outputs equal the per-op path (the LRU), the resident graphs and the
CPU run bit for bit, at B=1 and in the B=4 batch graphs; a preprocess run
again makes the next request capture again. Imports no JAX:
    python -m pytest --noconftest tests/test_torch_stream_cuda.py -m cuda
Without a card every case skips (a CUDA graph has no CPU mode)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.models.mlp import make_input

ART = Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts" / "mlp_pars25_test_n11"
B = 4


def _load(keydir, device="cuda", stream=True):
    vm = HEVM("test_n11", keyset_dir=str(keydir), device=device)
    vm.load(str(ART / "MLP.cst"), str(ART / "MLP.hevm"))
    if stream:
        ex = vm.executor
        ex._pt_budget = ex.plain_bytes // 4
        ex.preprocess()
        assert ex.streaming
        ex.precompile_segments()
    return vm


@pytest.fixture(scope="module")
def keydir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    return tmp_path_factory.mktemp("keys_n11_stream")


@pytest.fixture(scope="module")
def vms(keydir):
    return _load(keydir), _load(keydir, stream=False)


def _args(vm, seed):
    vm.setInput(0, make_input(seed))
    return [vm._arg_cts[0]]


@pytest.mark.cuda
def test_graphs_decode_in_graph(vms):
    ex = vms[0].executor
    stats = ex.capture_stats
    assert ex.plain_bytes == 0 and ex.pool_bytes == ex.n_plains * 2 * ex.s.ctx.n * 4
    assert stats["graphs"] == len(ex._captured[-1]) >= 1
    assert stats["decode_rows"] > 0 and stats["decode_max_bytes"] > 0
    assert ex._pt_groups and all(idx.is_cuda for g in ex._pt_groups.values()
                                 for _, _, idx in g)


@pytest.mark.cuda
def test_graphs_equal_per_op_resident_and_cpu(vms, keydir):
    stream, resident = vms
    ex = stream.executor
    args = _args(stream, 0)
    replays = ex.replays
    got, meta = ex.run_encrypted(args)
    assert ex.replays - replays == len(ex._captured[-1])
    got = [g.clone() for g in got]
    per_op, per_op_meta = ex.run_encrypted(args, jit=False)
    assert ex._pt_dev_bytes <= ex._pt_budget or len(ex._pt_dev) == 1
    res, res_meta = resident.executor.run_encrypted(args)
    cpu = _load(keydir, device="cpu")
    cpu_out, cpu_meta = cpu.executor.run_encrypted([(a.cpu(), nl, sc) for a, nl, sc in args])
    torch.cuda.synchronize()
    assert meta == per_op_meta == res_meta == cpu_meta
    for g, p, r, c in zip(got, per_op, res, cpu_out):
        assert torch.equal(g, p) and torch.equal(g, r) and torch.equal(g.cpu(), c)


@pytest.mark.cuda
def test_batch_graphs_equal_single_and_cpu(vms, keydir):
    stream = vms[0]
    ex = stream.executor
    assert stream.precompile_batch(B) >= 1
    assert ex.batch_capture_stats["decode_rows"] == ex.capture_stats["decode_rows"]
    stream.setInputBatch(0, np.stack([make_input(3 + b) for b in range(B)]))
    data, nl, scale = stream._arg_cts_batch[0]
    outs, meta = ex.run_encrypted_batch([(data, nl, scale)])
    outs = [o.clone() for o in outs]
    for b in range(B):
        single, single_meta = ex.run_encrypted([(data[b], nl, scale)], jit=False)
        assert single_meta == meta
        assert all(torch.equal(o[b], s) for o, s in zip(outs, single))
    cpu = _load(keydir, device="cpu")
    cpu_outs, cpu_meta = cpu.executor.run_encrypted_batch([(data.cpu(), nl, scale)])
    torch.cuda.synchronize()
    assert cpu_meta == meta
    assert all(torch.equal(o.cpu(), c) for o, c in zip(outs, cpu_outs))


@pytest.mark.cuda
def test_preprocess_again_captures_again(keydir):
    vm = _load(keydir)
    ex = vm.executor
    args = _args(vm, 1)
    want, _ = ex.run_encrypted(args)
    want = [w.clone() for w in want]
    first, pool = ex._captured[-1], ex._pt_pool
    ex.preprocess()
    assert ex._captured is None and ex._pt_pool is not pool and not ex._pt_groups
    got, _ = ex.run_encrypted(args)
    torch.cuda.synchronize()
    assert ex._captured[-1] is not first
    assert all(torch.equal(a, b) for a, b in zip(got, want))
