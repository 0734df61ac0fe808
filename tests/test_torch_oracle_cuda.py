"""The device oracle's CUDA graphs (crypto/bootstrap.py), on the card, at
test_n11c: one graph per cache key, captured once, whose replays draw fresh
randomness (the oracle's generator is registered with the graph), a replay
equals the eager refresh from the same generator state, and the card's
draws have the intended distribution. Imports no JAX:
    python -m pytest tests/test_torch_oracle_cuda.py -m cuda
Without a card every case skips (a CUDA graph has no CPU mode)."""

import numpy as np
import pytest
import torch

from dacapo_tpu_torch.crypto import bootstrap as bs
from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext

PROFILE = "test_n11c"
HOT = 2.0 ** 60


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")


@pytest.fixture(scope="module")
def scheme(card):
    s = Scheme(PROFILE, device="cuda")
    s.generate_keys()
    return s


def _input(s, nl, scale):
    vals = np.random.default_rng(11).uniform(-1, 1, s.ctx.config.n_slots)
    return vals, s.encrypt(vals, scale=scale, nl=nl).data


@pytest.mark.cuda
@pytest.mark.parametrize("nl, scale, target", [(6, HOT, 5), (4, 2.0 ** 40, 3)])
def test_replays_draw_afresh_and_equal_the_eager_path(scheme, nl, scale, target):
    vals, data = _input(scheme, nl, scale)
    ob = bs.EmulatedBootstrapper(scheme)
    rec = ob.capture(nl, scale, target)
    assert ob.capture(nl, scale, target) is rec and len(ob._graphs) == 1
    state = ob.gen.get_state()
    a, (nl2, sc2) = ob.bootstrap(data, nl, scale, target)
    b, _ = ob.bootstrap(data, nl, scale, target)
    torch.cuda.synchronize()
    assert ob.replays == 2 and len(ob._graphs) == 1
    assert not torch.equal(a[1], b[1])
    ob.gen.set_state(state)
    eager = ob._refresh(data[:, :nl], *ob._key(nl, scale, target)[1:])
    assert torch.equal(eager, a)
    assert sc2 == scale
    for out in (a, b):
        got = scheme.decrypt(Ciphertext(out, sc2))
        assert float(np.sqrt(np.mean((got - vals) ** 2))) < 5e-4


@pytest.mark.cuda
def test_noise_draws_on_the_card(scheme):
    """The card's draws: v in {-1, 0, 1}; e0, e1 integers with a sample
    standard deviation within 10 % of 3.2 over N = 2^11."""
    d = bs.EmulatedBootstrapper(scheme).draw()
    assert d.shape == (3, scheme.ctx.n) and d.device.type == "cuda"
    assert set(d[0].tolist()) == {-1, 0, 1}
    for e in d[1:].double():
        assert abs(float(e.std()) - 3.2) < 0.32


@pytest.mark.cuda
def test_capture_draws_nothing_and_outputs_survive(scheme):
    """Capturing restores the generator: a bootstrap after the capture draws
    what it would have drawn without it. The returned ciphertext is a copy
    that the next replay does not overwrite."""
    _, data = _input(scheme, 6, HOT)
    ob = bs.EmulatedBootstrapper(scheme)
    state = ob.gen.get_state()
    ob.capture(6, HOT, 5)
    assert torch.equal(ob.gen.get_state(), state)
    first, _ = ob.bootstrap(data, 6, HOT, 5)
    kept = first.clone()
    ob.bootstrap(data, 6, HOT, 5)
    torch.cuda.synchronize()
    assert torch.equal(first, kept)


@pytest.mark.cuda
def test_executor_replays_the_oracle_graphs(card, tmp_path):
    """A bootstrapped program the port compiles (the deep circuit, dacapo,
    test_n10) served by HEVM on the card: the load captures one oracle
    graph per cache key, every bootstrap of a request replays one, and the
    per-op path, from the same generator states, gives the segment path's
    ciphertexts bit for bit."""
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.crypto.params import PROFILES
    from dacapo_tpu_torch.models.deep import deep_golden, trace_deep
    from dacapo_tpu_torch.runtime.harness import compile_traced
    from dacapo_tpu_torch.vm.hevm import OP_BOOTSTRAP

    profile, depth = "test_n10", 10
    n = PROFILES[profile].n_slots
    traced = str(tmp_path / "traced")
    trace_deep(traced, n, depth)
    hv = compile_traced("Deep", "dacapo", 25, profile, traced_dir=traced,
                        out_dir=str(tmp_path / "optimized"))
    vm = HEVM(profile, keyset_dir=str(tmp_path / "keys"), device="cuda")
    vm.load(f"{traced}/_hecate_Deep.cst", hv)
    ex = vm.executor
    ob = ex.bootstrapper
    n_boot = sum(op.opcode == OP_BOOTSTRAP for op in vm.prog.ops)
    assert "oracle_capture" in vm.load_seconds and n_boot >= 1
    graphs = dict(ob._graphs)
    assert 1 <= len(graphs) <= n_boot
    x = np.random.default_rng(0).uniform(0.4, 0.9, n)
    vm.setInput(0, x)
    args = [vm._arg_cts[0]]
    state = ob.gen.get_state()
    seg, _ = ex.run_encrypted(args, jit="segment")
    seg = [c.clone() for c in seg]
    assert ob.replays == n_boot and ob._graphs == graphs
    ob.gen.set_state(state)
    per_op, _ = ex.run_encrypted(args, jit=False)
    torch.cuda.synchronize()
    assert ob.replays == 2 * n_boot and ob._graphs == graphs
    assert all(torch.equal(a, b) for a, b in zip(seg, per_op))
    out = ex.decrypt_outputs()[0]
    assert float(np.sqrt(np.mean((out - deep_golden(x, depth)) ** 2))) < 5e-2
