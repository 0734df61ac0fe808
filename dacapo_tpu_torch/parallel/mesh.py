"""Multi-device execution: ciphertext batches over "dp", key-switch rows over
"mp", on torch.distributed.

Port of dacapo_tpu/parallel/mesh.py. The reference lays a jax Mesh over its
devices and leaves the collectives to the XLA partitioner; here every
device is one process (a rank) of an initialized torch.distributed world,
NCCL between CUDA devices and gloo between CPU ranks, and the collectives
are explicit:

* axis "dp": each rank runs its contiguous block of a ciphertext batch
  (np.array_split order, `batch_rows`); the blocks meet in an all-gather
  over the dp group (`gather_batch`) where the whole batch is needed: the
  oracle's refresh and the results.
* axis "mp": the QP rows of the key switch are split cyclically, rank m
  owning the rows g with g % mp == m (crypto/ops.py `RowShard`): each rank
  holds only its rows of every key-switch key, extends ModUp only into
  them, and one all-gather of the accumulators per key switch feeds a
  replicated ModDown. Everything else is replicated within the mp group.

The reference's placements map so: `batch_sharding` -> `batch_rows`/
`batch_shard` and `gather_batch`; `key_sharding` -> Evaluator.shard_key
(always on the row axis, cyclic, so no row count has to divide mp);
`plain_sharding` -> Evaluator.own_rows (a mask's rows inside the key
switch); `replicated` -> a tensor every rank holds whole, as it is.

`launch` spawns the ranks of a world on one host (rank r on cuda:r, or on
the CPU with device="cpu"); `make_mesh` lays (dp, mp) over the world it is
called in. Nothing here falls back to the CPU: a CUDA mesh without cards
raises.
"""

import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from ..crypto.modmath import add_mod, mul_mod
from ..crypto.ops import RowShard


def mesh_shape(n, dp=None, limbs=None):
    """(dp, mp) of n devices, the reference's rule (mesh.py:25-39): mp is
    the first of 4, 3, 2, 1 that divides n and the sharded limb count
    `limbs`; or dp as given, mp = n // dp."""
    if dp is None:
        mp = next(c for c in (4, 3, 2, 1) if n % c == 0 and (limbs is None or limbs % c == 0))
        return n // mp, mp
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    return dp, n // dp


class Mesh:
    """A (dp, mp) mesh over the initialized torch.distributed world: rank
    r sits at (r // mp, r % mp), the reference's reshape(dp, mp) order.
    mp_group: the ranks of this rank's dp row (its mp axis); dp_group: the
    ranks of its mp column. `dp_gathers` counts the dp all-gathers."""

    def __init__(self, dp, mp):
        world = dist.get_world_size()
        if dp * mp != world:
            raise ValueError(f"a {dp}x{mp} mesh needs {dp * mp} ranks, the world has {world}")
        self.dp, self.mp = dp, mp
        self.rank = dist.get_rank()
        self.dp_rank, self.mp_rank = divmod(self.rank, mp)
        # every rank makes every group, in one order (new_group's contract)
        for i in range(dp):
            g = dist.new_group([i * mp + j for j in range(mp)])
            if i == self.dp_rank:
                self.mp_group = g
        for j in range(mp):
            g = dist.new_group([i * mp + j for i in range(dp)])
            if j == self.mp_rank:
                self.dp_group = g
        self.dp_gathers = 0


def make_mesh(n_devices=None, dp=None, limbs=None):
    """Mesh over (dp, mp) of the current world (n_devices: its size, the
    default); mp divides the sharded limb count `limbs` (mesh_shape). Runs
    inside an initialized process group (`launch`, `init_world`), in every
    rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs in an initialized torch.distributed world "
                           "(parallel.mesh.launch or init_world)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks")
    return Mesh(*mesh_shape(n, dp, limbs))


def init_world(rank, n, init_method, device):
    """Join rank `rank` of an n-rank world at init_method (e.g.
    "file:///path" or "tcp://localhost:<port>") on `device`: NCCL for a
    CUDA device (which becomes the current one), gloo for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card: torch.cuda.is_available() is False")
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n)
    return dev


def _rank_main(fn, rank, n, init_method, device, args, out):
    try:
        if device == "cpu":
            torch.set_num_threads(1)      # the ranks share the host's cores
        dev = init_world(rank, n, init_method, "cpu" if device == "cpu" else f"cuda:{rank}")
        try:
            res = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def launch(fn, n, *args, device="cuda", timeout=None):
    """Run fn(device, *args) in n spawned ranks of a new world (a file://
    init method in a temporary directory): rank r on cuda:r, or every rank
    on the CPU with device="cpu" (gloo, one thread each). fn must be
    importable by name (it is pickled); so are args and its results.
    Returns the ranks' results in rank order. Raises RuntimeError with the
    tracebacks if a rank fails, TimeoutError after `timeout` seconds; every
    rank is stopped before it returns."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: CUDA ranks need cards (torch.cuda.is_available() is "
                               "False); pass device='cpu' for gloo ranks on the CPU")
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"launch: {n} ranks, {torch.cuda.device_count()} cards")
    ctx = tmp.get_context("spawn")
    out = ctx.Queue()
    work = tempfile.mkdtemp(prefix="dacapo_mesh_")
    init = "file://" + os.path.join(work, "init")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, init, device, args, out))
             for r in range(n)]
    results, errors = {}, {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < n:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"launch: {n - len(results) - len(errors)} of {n} ranks "
                                   f"did not finish in {timeout} s")
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results and r not in errors]
                for r in dead:
                    errors[r] = f"rank {r} exited with code {procs[r].exitcode}"
                continue
            (results if ok else errors)[rank] = val
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(work, ignore_errors=True)
    if errors:
        raise RuntimeError("launch: " + "\n".join(f"[rank {r}] {e}" for r, e in
                                                   sorted(errors.items())))
    return [results[r] for r in range(n)]


# ------------------------------------------------------------- placement
def _blocks(b, dp):
    """The dp blocks of b rows, np.array_split order (the first b % dp one
    row longer)."""
    if b < dp:
        raise ValueError(f"a batch of {b} rows over dp={dp}: every rank needs a row")
    base, extra = divmod(b, dp)
    starts = [i * base + min(i, extra) for i in range(dp + 1)]
    return [slice(starts[i], starts[i + 1]) for i in range(dp)]


def batch_rows(mesh, b):
    """This rank's contiguous block of a batch of b rows on the dp axis."""
    return _blocks(b, mesh.dp)[mesh.dp_rank]


def batch_shard(mesh, x):
    """This rank's rows of a batch x [B, ...] (batch_rows)."""
    return x[batch_rows(mesh, x.shape[0])]


def gather_batch(mesh, x, b):
    """The whole batch [b, ...] from every rank's block x (batch_rows): one
    all-gather over the dp group, issued whatever its size."""
    sizes = [blk.stop - blk.start for blk in _blocks(b, mesh.dp)]
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))])
    out = x.new_empty((mesh.dp * top,) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=mesh.dp_group)
    mesh.dp_gathers += 1
    return torch.cat([out[i * top: i * top + s] for i, s in enumerate(sizes)])


# ------------------------------------------------------- the batched step
class BatchedEvaluator:
    """Evaluator ops over a ciphertext batch on a mesh: this rank's block of
    the batch, this rank's rows of the keys (the scheme's keys are split
    when it is made)."""

    def __init__(self, scheme, mesh):
        self.s = scheme
        self.ev = scheme.ev
        self.mesh = mesh
        scheme.shard_keys(RowShard(mesh.mp, mesh.mp_rank, mesh.mp_group))

    def eval_step(self, batch, nl, rot_steps=1):
        """The reference's batched step (mesh.py:76-97) over a batch [B, 2,
        nl, N] given whole to every rank: y = rescale(a*a + rot(a, k) * pt)
        with pt = 1 (a mul and relinearization key switch, a rotation key
        switch, a plaintext mul and a rescale). Returns the whole [B, 2,
        nl - 1, N] on every rank."""
        ev, s = self.ev, self.s
        a = batch_shard(self.mesh, batch)
        q = ev._q(range(nl))
        pt = torch.ones_like(a[0, 0])
        m = ev.mul_ct(a, a, nl, s.keys.rlk)
        r = mul_mod(ev.rotate(a, nl, rot_steps, s.keys.galois[rot_steps]), pt, q)
        y = ev.rescale(add_mod(m, r, q), nl)
        return gather_batch(self.mesh, y, batch.shape[0])


def dryrun(n_devices, profile="test_n8", batch=None, device=None, dp=None):
    """One batched step (BatchedEvaluator.eval_step) on an n-device mesh at
    a tiny profile, in every rank of the world: the reference's dryrun
    (keys from the profile's seed, batch of max(2, dp) encryptions of
    uniform [-1, 1) draws from default_rng(0)). Returns the output batch."""
    from ..crypto.scheme import Scheme

    s = Scheme(profile, device=device)
    s.generate_keys(rot_steps=(1,))
    nl = s.ctx.config.num_q
    mesh = make_mesh(n_devices, dp=dp, limbs=nl)
    b = batch or max(2, mesh.dp)
    rng = np.random.default_rng(0)
    cts = torch.stack([s.encrypt(rng.uniform(-1, 1, s.ctx.config.n_slots)).data
                       for _ in range(b)])
    out = BatchedEvaluator(s, mesh).eval_step(cts, nl)
    if tuple(out.shape) != (b, 2, nl - 1, s.ctx.n):
        raise AssertionError(f"batched step: shape {tuple(out.shape)}")
    return out


def dryrun_executor(profile="test_n10", waterline=25, device=None, host_rng=False):
    """The reference dryrun_program's program (mesh.py:120-184: an 8-tap
    rotation matvec, a square, one bootstrap, a mask) traced and compiled
    with the port's planner (pars) on keys from the profile's seed.
    Returns (executor after preprocess, golden(x), the numpy RNG that drew
    the weights, which draws the inputs next)."""
    from ..crypto.params import COMPILER_PROFILES
    from ..crypto.scheme import Scheme
    from ..ir import trace as hc
    from ..ir.config import load_profile
    from ..passes.pipeline import compile_function
    from ..passes.rewrite import canonicalize, cse, elide_constants, privatize_constants
    from ..vm.executor import HEVMExecutor

    load_profile(COMPILER_PROFILES[profile])
    s = Scheme(profile, device=device)
    s.generate_keys()
    n = s.ctx.config.n_slots
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.3, (8, n))

    def model(x):
        acc = None
        for i in range(8):
            t = x.rotate(i) * hc.Plain(w[i])
            acc = t if acc is None else acc + t
        h = acc + 0.1
        h = h * h
        h = hc.bootstrap(h)     # the batched bootstrap window
        return h * hc.Plain(w[0])

    def golden(x):
        acc = sum(np.roll(x, -i) * w[i] for i in range(8))
        h = acc + 0.1
        return h * h * w[0]

    hc._module.reset()
    fn = hc.func("c")(model).eval()
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    privatize_constants(fn)
    canonicalize(fn)
    prog = compile_function(fn, "pars", waterline)
    ex = HEVMExecutor(s, prog, payloads, host_rng=host_rng)
    ex.preprocess()
    return ex, golden, rng


def dryrun_program(n_devices, profile="test_n10", batch=None, waterline=25, dp=None,
                   device=None, host_rng=False):
    """The reference's integrated multi-device path (mesh.py:120-184): the
    dryrun_executor program over a batch of max(2, 2 * dp) uniform inputs,
    encrypted at its compiled level and scale and run with
    run_encrypted_batch over an n-device mesh, in every rank of the world.
    Checks the RMS against the plaintext model (< 5e-2). Returns the
    decrypted batch [B, slots], the RMS and the output ciphertexts [B, 2,
    nl, N]."""
    from ..crypto.scheme import Ciphertext

    ex, golden, rng = dryrun_executor(profile, waterline, device, host_rng)
    s = ex.s
    nl = (ex.prog.arg_level[0] + 1) * s.ctx.config.rescale_rows
    scale = float(2.0 ** ex.prog.arg_scale[0])
    mesh = make_mesh(n_devices, dp=dp, limbs=nl)
    b = batch or max(2, 2 * mesh.dp)
    xs = rng.uniform(-1, 1, (b, s.ctx.config.n_slots))
    cts = torch.stack([s.encrypt(x, scale=scale, nl=nl).data for x in xs])
    outs, out_meta = ex.run_encrypted_batch([(cts, nl, scale)], mesh=mesh)
    res = np.stack([s.decrypt(Ciphertext(outs[0][i], out_meta[0][1])) for i in range(b)])
    want = np.stack([golden(x) for x in xs])
    rms = float(np.sqrt(np.mean((res - want) ** 2)))
    if not rms < 5e-2:
        raise AssertionError(f"mesh-batched program wrong: rms={rms}")
    return res, rms, outs[0]


def shard_check(scheme, mp, nl=None, taps=2, seed=0):
    """The mp axis's row-subset arithmetic in one process, without a
    collective: for each rank m of an mp axis, the sharded ModUp and key
    inner product of one mul_ct key switch (the relinearization key) and
    the accumulators of one rot-mac group (`taps` rotations by 1..taps with
    random QP masks) at nl rows (default: the top level), each rank's rows
    assembled with Evaluator.assemble_rows as the all-gather's are. The
    scheme holds full keys, galois keys 1..taps among them. Returns
    dict(mismatches: elements where an assembled accumulator differs from
    the unsharded one (0: bit-equal), rows: each rank's key rows, key_bytes:
    each rank's bytes of one key)."""
    ev, keys = scheme.ev, scheme.keys
    if ev.shard is not None:
        raise ValueError("shard_check takes a scheme whose keys are whole")
    cfg = scheme.ctx.config
    nl = cfg.num_q if nl is None else nl
    qp = list(range(nl)) + [cfg.num_q + i for i in range(cfg.alpha)]
    rng = np.random.default_rng(seed)
    primes = np.array([scheme.ctx.primes[r] for r in qp], dtype=np.uint64)[:, None]

    def residues(shape, rows):
        u = rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % primes[:rows]
        return torch.from_numpy(u.astype(np.int64)).to(torch.int32).to(scheme.device)

    n = scheme.ctx.n
    ct = residues((2, nl, n), nl)
    pts = [residues((len(qp), n), len(qp)) for _ in range(taps)]
    gks = [keys.galois[st] for st in range(1, taps + 1)]

    def accumulators(rlk, gks):
        ks = ev._ks_inner(ev.modup(ct[1], nl), nl, rlk)
        digits = ev.modup(ct[1], nl)
        accs = None
        for i, gk in enumerate(gks):
            accs = ev._rot_mac_tap(digits, ct[0], i + 1, gk, pts[i], nl, accs)
        return list(ks) + list(accs)          # acc0, acc1, rc, r0, r1

    want = accumulators(keys.rlk, gks)
    parts, rows = [], []
    try:
        for m in range(mp):
            ev.shard = RowShard(mp, m)
            parts.append(accumulators(ev.shard_key(keys.rlk), [ev.shard_key(k) for k in gks]))
            rows.append(ev.key_rows())
    finally:
        ev.shard = None
    bad = 0
    for i, w in enumerate(want):
        if i == 2:                            # rc: Q rows, replicated
            got = [p[i] for p in parts]
            bad += sum(int((g != w).sum()) for g in got)
            continue
        ev.shard = RowShard(mp, 0)
        try:
            got = ev.assemble_rows([p[i] for p in parts], nl)
        finally:
            ev.shard = None
        bad += int((got != w).sum())
    return dict(mismatches=bad, rows=rows,
                key_bytes=[cfg.dnum * 2 * r * n * 4 for r in rows])
