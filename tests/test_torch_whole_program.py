"""The whole-program path (`jit=True`) on the CPU, held against the JAX
package's `run_encrypted(jit=True)` on the same keys (same seed) and the same
input ciphertext, byte for byte, for two programs:

* bootstrap-free: the MLP (pars, waterline 25, test_n11) the JAX package
  compiles (tests/test_torch_mlp_e2e.py), the port's windows cut at 5 ops so
  that the walk crosses several windows and a tiny eager one; the JAX
  package compiles the request into one XLA function;
* native-bootstrapped: the deep circuit of tests/test_torch_executor_native.py
  (test_boot with 40 Q primes, one native bootstrap). The JAX package's rule
  sends it down the same whole-program function; XLA's compile of that
  function with a whole bootstrap inside takes more than 5 minutes on the
  CPU, so here it runs op by op: `jax.jit` is the identity for that one
  function (its ops keep their own compiled functions), which leaves its
  arithmetic as it is.

The port's whole-program walk runs eagerly here ("cpu": no graphs exist)
and equals its segment and per-op outputs. The path rule: streaming, the
oracle, debug, a galois-key budget and a bootstrap signature the plane bound
cannot pin each send a jit=True request elsewhere and say why
(`last_path`); the bootstrapper's counts after a whole-program request equal
those after a segment request, and `count_replay` (the card's bookkeeping of
a bootstrap inside the whole-program graph) keeps them as an eager
bootstrap does. The card's capture, replay and recapture are
tests/test_torch_whole_cuda.py's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import dacapo_tpu
import dacapo_tpu_torch
from dacapo_tpu.crypto.bootstrap_native import BootstrapConfig as RefConfig
from dacapo_tpu.crypto.params import PROFILES as REF_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.vm import executor as ref_executor
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.ir import config as port_config, trace as port_trace
from dacapo_tpu_torch.models.mlp import make_input
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram
from test_torch_executor_boot import compile_deep, PROFILE as ORACLE_PROFILE
from test_torch_executor_native import CFG, SEED, WIDER, compile_test_boot, PROFILE as BOOT
from test_torch_mlp_e2e import compile_mlp, PROFILE as MLP

WINDOW_OPS = 5        # the MLP's windows: several, the last one tiny


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_whole_op_by_op(monkeypatch):
    """jax.jit as the identity for the JAX executor's whole-program function
    alone (module docstring)."""
    real = jax.jit

    def jit(fn, *a, **k):
        if fn.__qualname__.endswith("_get_compiled.<locals>.f"):
            return fn
        return real(fn, *a, **k)

    monkeypatch.setattr(ref_executor.jax, "jit", jit)


def _arg(ref_s, port_s, prog, x, rr):
    """The argument ciphertext, encrypted by both packages from the same
    generator state: (JAX triple, port triple)."""
    nl = (prog.arg_level[0] + 1) * rr
    scale = float(2.0 ** prog.arg_scale[0])
    ref_ct = ref_s.encrypt(x, scale=scale, nl=nl)
    port_ct = port_s.encrypt(x, scale=scale, nl=nl)
    np.testing.assert_array_equal(to_host(port_ct.data), np.asarray(ref_ct.data))
    return (ref_ct.data, nl, scale), (port_ct.data, nl, scale)


@pytest.fixture(scope="module", params=["free", "native"])
def program(request, tmp_path_factory):
    """The JAX package's jit=True request and the port's executor (before
    any request) on the same keys and argument."""
    tmp = tmp_path_factory.mktemp(request.param)
    if request.param == "free":
        prog, payloads, _, path, _ = compile_mlp(tmp)
        ref_s, port_s = RefScheme(MLP), Scheme(MLP, device="cpu")
        x = make_input(0)
    else:
        prog, payloads, path, _ = compile_test_boot(tmp)
        ref_s = RefScheme(BOOT, config=dataclasses.replace(REF_PROFILES[BOOT], **WIDER),
                          seed=SEED)
        port_s = Scheme(BOOT, config=dataclasses.replace(params.PROFILES[BOOT], **WIDER),
                        seed=SEED, device="cpu")
        x = np.random.default_rng(0).uniform(0.5, 0.55, port_s.ctx.config.n_slots)
    ref_s.generate_keys()
    port_s.generate_keys()
    if request.param == "native":
        ref_s.enable_native_bootstrap(RefConfig(**CFG))
        port_s.enable_native_bootstrap(BootstrapConfig(**CFG))
    ref = RefExecutor(ref_s, prog, payloads)
    ref.preprocess()
    port = HEVMExecutor(port_s, HEVMProgram.load(path), payloads)
    port.preprocess()
    if request.param == "free":
        port.SEGMENT_MAX_OPS, port._seg_plan = WINDOW_OPS, None
    ref_arg, port_arg = _arg(ref_s, port_s, prog, x, port.rr)
    mp = pytest.MonkeyPatch()
    try:
        if request.param == "native":
            _ref_whole_op_by_op(mp)
        ref_outs, ref_meta = ref.run_encrypted([ref_arg], jit=True)
    finally:
        mp.undo()
    assert ref._compiled is not None            # the JAX rule chose its whole program
    return dict(name=request.param, port=port, arg=port_arg, prog=prog, payloads=payloads,
                path=path, ref_cts=[np.asarray(c) for c in ref_outs],
                ref_meta=[tuple(m) for m in ref_meta])


def _host(outs):
    return [to_host(c) for c in outs]


def test_whole_equals_jax_whole(program):
    port = program["port"]
    assert port.whole_path() == ("whole", "cpu")
    outs, meta = port.run_encrypted([program["arg"]], jit=True)
    assert port.last_path == ("whole", "cpu")
    assert [tuple(m) for m in meta] == program["ref_meta"]
    for got, want in zip(_host(outs), program["ref_cts"]):
        np.testing.assert_array_equal(got, want)
    if program["name"] == "free":
        plan = port._segment_plan()
        assert len(plan) > 2 and not port._graph_window(plan[-1])


@pytest.mark.parametrize("jit", ["segment", False])
def test_whole_equals_segment_and_per_op(program, jit):
    port = program["port"]
    whole, _ = port.run_encrypted([program["arg"]], jit=True)
    other, _ = port.run_encrypted([program["arg"]], jit=jit)
    assert port.last_path == ("segment" if jit else "per_op", None)
    for a, b in zip(_host(whole), _host(other)):
        np.testing.assert_array_equal(a, b)


def _counts(bs):
    return dict(calls=bs.calls, pos=bs._pos, evictions=bs.evictions, reencodes=bs.reencodes,
                replays=bs.replays)


def test_bootstrap_counts_equal_segment(program):
    """A whole-program request leaves the bootstrapper's counts and the
    request's as a segment request does (on the CPU both bootstrap eagerly,
    "cpu")."""
    port = program["port"]
    bs = port.bootstrapper
    deltas = []
    for jit in (True, "segment"):
        before = _counts(bs) if bs is not None else {}
        port.run_encrypted([program["arg"]], jit=jit)
        deltas.append(({k: v - before[k] for k, v in _counts(bs).items()} if bs else {},
                       port.last_bootstraps))
    assert deltas[0] == deltas[1]
    if program["name"] == "native":
        assert deltas[0][0]["calls"] == 1 and deltas[0][1] == dict(replayed=0,
                                                                  eager={"cpu": 1})


def test_count_replay_keeps_an_eager_bootstraps_books(program):
    """NativeBootstrapper.count_replay, the bookkeeping of a bootstrap
    inside the whole-program graph: the count and the planned sequence's
    position move as an eager bootstrap of the same signature moves them,
    and the replay and its recorded NTT calls are counted."""
    if program["name"] != "native":
        pytest.skip("no bootstrap in the program")
    port = program["port"]
    bs = port.bootstrapper
    seq = port._boot_sequence()
    bs.set_plane_budget(None, [(nl, sc) for nl, sc, _ in seq])
    nl, sc, target = seq[0]
    start = _counts(bs)
    data = torch.zeros((2, nl, bs.s.ctx.n), dtype=torch.int32)
    bs.bootstrap(data, nl, sc, target)
    eager = _counts(bs)
    bs.calls, bs._pos = start["calls"], start["pos"]
    ntt = dict.fromkeys(bs.replayed_ntt, 3)
    before_ntt, inlined = dict(bs.replayed_ntt), bs.inlined
    bs.count_replay(nl, sc, ntt)
    replayed = _counts(bs)
    assert (replayed["calls"], replayed["pos"]) == (eager["calls"], eager["pos"])
    assert replayed["replays"] == eager["replays"] + 1 and bs.inlined == inlined + 1
    assert bs.replayed_ntt == {k: v + 3 for k, v in before_ntt.items()}


def test_dropped_group_takes_the_segment_path(program):
    """A bound on the planes below one signature's: the whole-program graph
    could not pin them, so jit=True takes the segment path and says so."""
    if program["name"] != "native":
        pytest.skip("no bootstrap in the program")
    port = program["port"]
    bs = port.bootstrapper
    seq = [(nl, sc) for nl, sc, _ in port._boot_sequence()]
    try:
        bs.set_plane_budget(0, seq)
        assert port.whole_path() == ("segment", "dropped_group")
        outs, _ = port.run_encrypted([program["arg"]], jit=True)
        assert port.last_path == ("segment", "dropped_group")
    finally:
        bs.set_plane_budget(None)
    assert port.whole_path() == ("whole", "cpu")


def test_debug_takes_the_per_op_path(program):
    if program["name"] != "free":
        pytest.skip("the bootstrap-free program covers it")
    port = program["port"]
    port.setDebug(True)
    try:
        outs, _ = port.run_encrypted([program["arg"]], jit=True)
    finally:
        port.setDebug(False)
    assert port.last_path == ("per_op", "debug")
    want, _ = port.run_encrypted([program["arg"]], jit=False)
    for a, b in zip(_host(outs), _host(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("why", ["streaming", "key_budget"])
def test_blockers_take_the_segment_path(program, why):
    """Plaintexts in the compact pool (the JAX rule's fallback) and a
    galois-key budget (the port's): a jit=True request runs the segment
    plan, says why, and gives the whole-program output."""
    if program["name"] != "free":
        pytest.skip("the bootstrap-free program covers both")
    port = program["port"]
    want, _ = port.run_encrypted([program["arg"]], jit=True)
    s = Scheme(MLP, device="cpu")
    s.generate_keys()
    ex = HEVMExecutor(s, HEVMProgram.load(program["path"]), program["payloads"])
    if why == "streaming":
        ex._pt_budget = 1
    else:
        s.set_key_budget(4 * s.galois_key_bytes())
        ex.key_arena()
    ex.preprocess()
    assert ex.streaming == (why == "streaming")
    assert ex.whole_path() == ("segment", why)
    got, _ = ex.run_encrypted([program["arg"]], jit=True)
    assert ex.last_path == ("segment", why)
    for a, b in zip(_host(got), _host(want)):
        np.testing.assert_array_equal(a, b)


def test_oracle_takes_the_segment_path(tmp_path):
    """The emulated bootstrap (host-RNG here, the device oracle alike) sends
    jit=True to the segment path, as the JAX package's rule does; the same
    draws give the segment request's output."""
    n = Scheme(ORACLE_PROFILE, device="cpu").ctx.config.n_slots
    prog, payloads, path = compile_deep(tmp_path, n)
    s = Scheme(ORACLE_PROFILE, device="cpu")
    s.generate_keys()
    ex = HEVMExecutor(s, HEVMProgram.load(path), payloads, host_rng=True)
    ex.preprocess()
    assert ex.whole_path() == ("segment", "oracle")
    nl = (ex.prog.arg_level[0] + 1) * ex.rr
    scale = float(2.0 ** ex.prog.arg_scale[0])
    x = np.random.default_rng(0).uniform(0.4, 0.9, n)
    arg = [(s.encrypt(x, scale=scale, nl=nl).data, nl, scale)]
    rng = s.keygen.rng.bit_generator
    state = rng.state
    got, _ = ex.run_encrypted(arg, jit=True)
    assert ex.last_path == ("segment", "oracle")
    rng.state = state
    want, _ = ex.run_encrypted(arg, jit="segment")
    for a, b in zip(_host(got), _host(want)):
        np.testing.assert_array_equal(a, b)


def test_whole_path_needs_no_graph_on_the_cpu(program):
    """precompile_whole captures nothing off the card, and raises where the
    requests would not take the whole-program path."""
    port = program["port"]
    assert port.precompile_whole() == 0
    port.setDebug(True)
    try:
        with pytest.raises(RuntimeError, match="debug"):
            port.precompile_whole()
    finally:
        port.setDebug(False)


HC_NAMES = ["func", "Plain", "Empty", "Expr", "save", "bootstrap", "resolve", "load_profile",
            "current_config", "set_config", "CompilerConfig"]


@pytest.mark.parametrize("name", HC_NAMES)
def test_top_level_hc_names(name):
    """The port's top level carries the JAX package's `hc` names, from its
    own tracer and configuration."""
    assert hasattr(dacapo_tpu, name)
    got = getattr(dacapo_tpu_torch, name)
    assert got is getattr(port_trace if hasattr(port_trace, name) else port_config, name)
    assert name in dacapo_tpu_torch.__all__
