"""The port's mesh (dacapo_tpu_torch/parallel/mesh.py) on the CPU: gloo ranks
spawned by parallel.mesh.launch (tests/torch_mesh_ranks.py runs in them),
held against the JAX package's mesh on the 8 virtual CPU devices of
tests/conftest.py and against the port's own batch with mesh=None:

(a) mesh_shape gives the JAX make_mesh's (dp, mp) for n in {1, 2, 4, 8};
(b) the batched step (test_n8, keys from the profile seed, the same input
    ciphertexts) at world 2 (1x2) and world 4 (2x2) is bit-equal to JAX's
    BatchedEvaluator.compile_step (parallel.mesh.dryrun) on its 8-device mesh;
(c) dryrun_program's test_n10 program: on the host-RNG oracle bit-equal to
    JAX's run_encrypted_batch(mesh=make_mesh(8)) with DACAPO_TPU_ORACLE_JIT=0,
    on the device oracle (B=3: blocks of 2 and 1 rows) bit-equal to the
    port's mesh=None batch, RMS < 5e-2, at both worlds;
(d) mp=2 under a galois-key budget (DACAPO_TPU_HBM_BYTES): the arena and
    the LRU hold key shards, and the outputs equal mesh=None's;
(e) each rank's key shards hold at most ceil(rows/mp) rows and add up to
    the full keys byte for byte;
and, in this process, the row-subset arithmetic of a key switch and a
rot-mac group at mp 2, 3 and 4 assembles to the unsharded accumulators.
Every rank checks that it loaded no JAX and nothing of dacapo_tpu. Each
world is one launch with its own timeout; the three run at once."""

import concurrent.futures
import math

import jax
import numpy as np
import pytest
import torch

import dacapo_tpu as hc
import torch_mesh_ranks as R
from dacapo_tpu.crypto.params import COMPILER_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.ir import trace as trace_mod
from dacapo_tpu.ir.config import load_profile
from dacapo_tpu.parallel import mesh as ref_mesh
from dacapo_tpu.passes.pipeline import compile_function
from dacapo_tpu.passes.rewrite import cse, canonicalize, elide_constants, privatize_constants
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch.crypto.ops import RowShard
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.parallel import mesh as port_mesh

LAUNCH_TIMEOUT = 120
WORLDS = {"1x2": (2, 1), "2x2": (4, 2)}
# a plan whose galois-key budget (55 %, 880,000 B) is passed by the
# program's 7 full test_n10 keys (196,608 B each), which one window reads
# together, and holds an arena of their 7 halves at mp=2 and a key of LRU
HBM_BYTES = 1_600_000


def _ref_program_batch(batch):
    """The JAX package's dryrun_program flow (mesh.py:120-184) on its
    8-device mesh with the host-RNG oracle: its output ciphertexts."""
    profile = "test_n10"
    load_profile(COMPILER_PROFILES[profile])
    s = RefScheme(profile)
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
        h = hc.bootstrap(h)
        return h * hc.Plain(w[0])

    trace_mod._module.reset()
    fn = hc.func("c")(model).eval()
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    privatize_constants(fn)
    canonicalize(fn)
    prog = compile_function(fn, "pars", 25)
    ex = RefExecutor(s, prog, payloads)
    ex.preprocess()
    nl = (prog.arg_level[0] + 1) * s.ctx.config.rescale_rows
    scale = float(2.0 ** prog.arg_scale[0])
    mesh = ref_mesh.make_mesh(8, limbs=nl)
    xs = rng.uniform(-1, 1, (batch, n))
    cts = np.stack([np.asarray(s.encrypt(x, scale=scale, nl=nl).data) for x in xs])
    outs, _ = ex.run_encrypted_batch([(cts, nl, scale)], mesh=mesh)
    return np.asarray(outs[0])


def _port_program_batch(batch, host_rng):
    """The port's dryrun program over `batch` inputs with mesh=None."""
    ex, _, rng = port_mesh.dryrun_executor(device="cpu", host_rng=host_rng)
    s = ex.s
    nl = (ex.prog.arg_level[0] + 1) * s.ctx.config.rescale_rows
    scale = float(2.0 ** ex.prog.arg_scale[0])
    xs = rng.uniform(-1, 1, (batch, s.ctx.config.n_slots))
    cts = torch.stack([s.encrypt(x, scale=scale, nl=nl).data for x in xs])
    outs, _ = ex.run_encrypted_batch([(cts, nl, scale)])
    return to_host(outs[0])


@pytest.fixture(scope="module")
def runs(monkeypatch_module):
    """Both worlds and the budget world, spawned at once, while this
    process computes the references."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {name: pool.submit(port_mesh.launch, R.world, n, n, dp, device="cpu",
                                  timeout=LAUNCH_TIMEOUT)
                for name, (n, dp) in WORLDS.items()}
        futs["budget"] = pool.submit(port_mesh.launch, R.budget, 2, 2, 1, HBM_BYTES,
                                     device="cpu", timeout=LAUNCH_TIMEOUT)
        ref_step = np.asarray(ref_mesh.dryrun(8, profile="test_n8", batch=R.STEP_BATCH))
        monkeypatch_module.setenv("DACAPO_TPU_ORACLE_JIT", "0")
        ref_host = _ref_program_batch(R.HOST_BATCH)
        port_host = _port_program_batch(R.HOST_BATCH, host_rng=True)
        port_device = _port_program_batch(R.DEVICE_BATCH, host_rng=False)
        out = {name: f.result() for name, f in futs.items()}
    s = Scheme("test_n10", device="cpu")
    s.generate_keys(rot_steps=(1, 2))
    return dict(out, ref_step=ref_step, ref_host=ref_host, port_host=port_host,
                port_device=port_device, rlk=to_host(s.keys.rlk),
                gk1=to_host(s.keys.galois[1]))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


# ------------------------------------------------------------ (a) the shape
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_is_jax_make_mesh(n):
    for limbs in (None, 1, 2, 3, 6, 8, 9, 12, 35):
        ref = ref_mesh.make_mesh(n, limbs=limbs).shape
        assert port_mesh.mesh_shape(n, limbs=limbs) == (ref["dp"], ref["mp"]), limbs
    for dp in (d for d in (1, 2, 4, 8) if n % d == 0):
        ref = ref_mesh.make_mesh(n, dp=dp).shape
        assert port_mesh.mesh_shape(n, dp=dp) == (ref["dp"], ref["mp"])


def test_batch_rows_in_array_split_order():
    for b, dp in ((3, 2), (4, 2), (8, 4), (7, 3), (5, 1)):
        want = np.array_split(np.arange(b), dp)
        for i in range(dp):
            pos = type("Pos", (), dict(dp=dp, dp_rank=i))
            assert list(range(b))[port_mesh.batch_rows(pos, b)] == want[i].tolist()
    with pytest.raises(ValueError, match="every rank needs a row"):
        port_mesh.batch_rows(type("Pos", (), dict(dp=4, dp_rank=0)), 3)


def test_mesh_refuses_without_a_world_or_a_card():
    with pytest.raises(RuntimeError, match="initialized"):
        port_mesh.make_mesh(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_mesh.launch(R.world, 1, 1, 1)


# ------------------------------------------------- the ranks load no JAX
def test_ranks_load_no_jax(runs):
    reports = [r["reference"] for name in (*WORLDS, "budget") for r in runs[name]]
    assert len(reports) == 8
    assert all(rep == [] for rep in reports), reports


# ------------------------------------------------------ (b) the batched step
@pytest.mark.parametrize("world", list(WORLDS))
def test_batched_step_bit_equal_to_jax(runs, world):
    want = runs["ref_step"]
    assert want.shape[0] == R.STEP_BATCH
    for r in runs[world]:
        np.testing.assert_array_equal(r["step"], want)


# ------------------------------------------------------- (c) the program
@pytest.mark.parametrize("world", list(WORLDS))
def test_host_oracle_program_bit_equal_to_jax(runs, world):
    want = runs["ref_host"]
    np.testing.assert_array_equal(runs["port_host"], want)
    for r in runs[world]:
        np.testing.assert_array_equal(r["host"], want)
        assert r["host_rms"] < 5e-2


@pytest.mark.parametrize("world", list(WORLDS))
def test_device_oracle_program_equals_mesh_none(runs, world):
    want = runs["port_device"]
    assert want.shape[0] == R.DEVICE_BATCH
    n, dp = WORLDS[world]
    assert sorted(r["coords"] for r in runs[world]) == [(i, j) for i in range(dp)
                                                      for j in range(n // dp)]
    for r in runs[world]:
        np.testing.assert_array_equal(r["device"], want)
        assert r["dev_rms"] < 5e-2
        assert r["res"].shape[0] == R.DEVICE_BATCH


# ----------------------------------------------------- (d) under a key budget
def test_key_budget_on_shards_equals_mesh_none(runs):
    full_key = 2 * 2 * 12 * 1024 * 4               # dnum 2, 12 QP rows, N = 1024
    for r in runs["budget"]:
        np.testing.assert_array_equal(r["out"], runs["port_host"])
        assert r["budget"] == r["full_budget"] == int(0.55 * HBM_BYTES)
        assert r["key_bytes"] == full_key // 2 and r["arena_rows"] == 6
        assert r["n_keys"] * full_key > r["budget"]   # load chose host-backed keys
        # the arena's slots are shard-sized: they fit where full keys do not
        assert r["slots"] == r["n_keys"] == 7
        assert (r["slots"] + 1) * r["key_bytes"] <= r["budget"] < r["slots"] * full_key
        assert r["peak"] <= r["budget"]
        assert r["staged"]["host"] > 0


# --------------------------------------------------------- (e) key shards
@pytest.mark.parametrize("world", list(WORLDS))
def test_key_shards_add_up_to_the_full_keys(runs, world):
    n, dp = WORLDS[world]
    mp = n // dp
    for row in range(dp):
        ranks = [r for r in runs[world] if r["coords"][0] == row]
        for name in ("rlk", "gk1"):
            full = runs[name]
            got = np.empty_like(full)
            for r in ranks:
                part = r["keys"][name]
                m = r["coords"][1]
                assert r["keys"]["shard"] == (mp, m)
                assert part.shape[2] == r["keys"]["rows"] <= math.ceil(full.shape[2] / mp)
                assert r["keys"]["key_bytes"] == part.nbytes
                got[:, :, m::mp] = part
            assert got.tobytes() == full.tobytes()
        for r in ranks:
            assert r["keys"]["device_bytes"] <= 2 * r["keys"]["key_bytes"]


# ------------------------------------------- the row-subset arithmetic
@pytest.mark.parametrize("mp", [2, 3, 4])
def test_shard_arithmetic_assembles_to_the_unsharded(mp):
    s = Scheme("test_n10", device="cpu")
    s.generate_keys(rot_steps=(1, 2))
    for nl in (8, 5, 1):
        got = port_mesh.shard_check(s, mp, nl=nl)
        assert got["mismatches"] == 0, nl
        assert sum(got["rows"]) == 12 and max(got["rows"]) == math.ceil(12 / mp)
    # a shard keeps its rows of a key made later, and another split raises
    s.shard_keys(RowShard(mp, 1))
    s.ensure_galois([3])
    assert s.keys.galois[3].shape[2] == len(range(1, 12, mp))
    with pytest.raises(ValueError, match="mp axis"):
        s.shard_keys(RowShard(mp, 0))
