"""What the ranks of tests/test_torch_mesh.py run (parallel.mesh.launch
pickles these functions by name, so each rank imports this module and not
the test file). It imports numpy, torch and the port only: each rank
reports the modules of JAX and of the JAX package it finds loaded, which
must be none."""

import os
import sys

import numpy as np
import torch

from dacapo_tpu_torch.crypto.ops import RowShard
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.parallel import mesh as mesh_mod

STEP_BATCH = 4          # the batched step's batch (a multiple of the JAX mesh's dp)
HOST_BATCH = 4          # the host-RNG program's batch (the same)
DEVICE_BATCH = 3        # the device-oracle program's: blocks 2 and 1 over dp=2


def reference_modules():
    return sorted(m for m in sys.modules if m in ("jax", "jaxlib", "dacapo_tpu")
                  or m.startswith(("jax.", "jaxlib.", "dacapo_tpu.")))


def _key_shards(device, mesh):
    """This rank's rows of rlk and of galois key 1 after shard_keys, with
    the device bytes its store holds."""
    s = Scheme("test_n10", device=device)
    s.generate_keys(rot_steps=(1, 2))
    s.shard_keys(RowShard(mesh.mp, mesh.mp_rank, mesh.mp_group))
    g = s.keys.galois
    return dict(rlk=to_host(s.keys.rlk), gk1=to_host(g[1]), rows=s.ev.key_rows(),
                key_bytes=s.galois_key_bytes(), device_bytes=g.device_bytes,
                shard=s.keys.shard)


def world(device, n, dp):
    """The batched step, the program on both oracles and the key shards on
    an n-rank (dp, n // dp) mesh."""
    step = mesh_mod.dryrun(n, profile="test_n8", batch=STEP_BATCH, device=device, dp=dp)
    _, host_rms, host = mesh_mod.dryrun_program(n, batch=HOST_BATCH, dp=dp, device=device,
                                                host_rng=True)
    res, dev_rms, dev = mesh_mod.dryrun_program(n, batch=DEVICE_BATCH, dp=dp, device=device)
    mesh = mesh_mod.make_mesh(n, dp=dp)
    return dict(coords=(mesh.dp_rank, mesh.mp_rank), step=to_host(step),
                host=to_host(host), host_rms=host_rms, device=to_host(dev), dev_rms=dev_rms,
                res=res, keys=_key_shards(device, mesh), reference=reference_modules())


def budget(device, n, dp, hbm_bytes):
    """The host-RNG program under a device-memory plan that budgets the
    galois keys: the arena and the LRU hold key shards."""
    os.environ["DACAPO_TPU_HBM_BYTES"] = str(hbm_bytes)
    ex, golden, rng = mesh_mod.dryrun_executor(device=device, host_rng=True)
    s = ex.s
    nl = (ex.prog.arg_level[0] + 1) * s.ctx.config.rescale_rows
    scale = float(2.0 ** ex.prog.arg_scale[0])
    mesh = mesh_mod.make_mesh(n, dp=dp, limbs=nl)
    xs = rng.uniform(-1, 1, (HOST_BATCH, s.ctx.config.n_slots))
    cts = torch.stack([s.encrypt(x, scale=scale, nl=nl).data for x in xs])
    full_budget = s.keys.galois.budget
    outs, _ = ex.run_encrypted_batch([(cts, nl, scale)], mesh=mesh)
    g = s.keys.galois
    arena = ex._arena
    return dict(out=to_host(outs[0]), budget=g.budget, full_budget=full_budget,
                key_bytes=s.galois_key_bytes(), n_keys=ex.n_keys,
                slots=len(arena["held"]), arena_rows=arena["data"].shape[3],
                peak=g.peak_bytes, staged=dict(ex.key_staging),
                reference=reference_modules())
