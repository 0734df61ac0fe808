"""The mesh on the card at world size 1 (an in-process NCCL group): the
committed test_n11 MLP (artifacts/mlp_pars25_test_n11) as a batch of 4 on
two HEVMs over one keyset, one with mesh=None and one with
runBatch(mesh=make_mesh(1)), whose batch graphs record the mp all-gathers;
the dryrun program (one oracle bootstrap, whose dp all-gather runs between
replays) against its mesh=None batch; and the shard arithmetic at mp 2, 3
and 4 with the row-subset kernels and tables on the card. Imports no JAX:
    python -m pytest --noconftest tests/test_torch_mesh_cuda.py -m cuda
Without a card every case skips (NCCL and CUDA graphs have no CPU mode)."""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.models.mlp import make_input
from dacapo_tpu_torch.parallel import mesh as mesh_mod

ART = Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts" / "mlp_pars25_test_n11"
B = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and graphs have no CPU mode")
    init = "file://" + str(tmp_path_factory.mktemp("nccl") / "init")
    mesh_mod.init_world(0, 1, init, "cuda:0")
    yield mesh_mod.make_mesh(1)
    dist.destroy_process_group()


def _vm(keydir):
    vm = HEVM("test_n11", keyset_dir=str(keydir))
    vm.load(str(ART / "MLP.cst"), str(ART / "MLP.hevm"))
    return vm


@pytest.mark.cuda
def test_world_one_batch_equals_mesh_none(world, tmp_path):
    plain, meshed = _vm(tmp_path), _vm(tmp_path)
    plain.setInputBatch(0, np.stack([make_input(seed) for seed in range(B)]))
    meshed._arg_cts_batch = dict(plain._arg_cts_batch)
    want = plain.runBatch()
    want_cts = [o.clone() for o in plain.executor._last_outputs[0]]
    ex = meshed.executor
    assert meshed.precompile_batch(B, mesh=world) >= 1
    stats = ex.batch_capture_stats
    assert stats["batch"] == B and stats["collectives"] >= 1      # gathers in the graphs
    assert meshed.scheme.keys.shard == (1, 0)
    before = ex.mesh_collectives
    got = meshed.runBatch(mesh=world)
    torch.cuda.synchronize()
    assert ex.mesh_collectives - before == stats["collectives"]
    np.testing.assert_array_equal(got, want)
    for g, w in zip(ex._last_outputs[0], want_cts):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_world_one_oracle_program_equals_mesh_none(world):
    _, rms, outs = mesh_mod.dryrun_program(1, batch=3, device="cuda")
    assert rms < 5e-2
    ex, _, rng = mesh_mod.dryrun_executor(device="cuda")
    s = ex.s
    nl = (ex.prog.arg_level[0] + 1) * s.ctx.config.rescale_rows
    scale = float(2.0 ** ex.prog.arg_scale[0])
    xs = rng.uniform(-1, 1, (3, s.ctx.config.n_slots))
    cts = torch.stack([s.encrypt(x, scale=scale, nl=nl).data for x in xs])
    want, _ = ex.run_encrypted_batch([(cts, nl, scale)])
    np.testing.assert_array_equal(to_host(outs), to_host(want[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [2, 3, 4])
def test_shard_arithmetic_on_the_card(mp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = Scheme("test_n11", device="cuda")
    s.generate_keys(rot_steps=(1, 2))
    for nl in (8, 3):
        got = mesh_mod.shard_check(s, mp, nl=nl)
        assert got["mismatches"] == 0, nl
