"""The native bootstrap on the card: the test_boot bootstrap of
tests/test_torch_bootstrap_native.py (same seed, config and calls) on the
card is bit-equal to the same calls with device="cpu", and its output
ciphertext's SHA-256 equals the digest committed from the JAX package
(dacapo_tpu_torch/artifacts/native_test_boot/expected.json). Its CUDA graph
(NativeBootstrapper.capture): replays byte-equal to eager bootstraps over
two inputs, a capture that fails raises; and the committed deep tpu_n15b
program (artifacts/deep_dacapo40_tpu_n15b, 2 bootstraps) served by HEVM: a
per-op request between two segment requests drops the graphs and the
second segment request captures them again, the three outputs byte-equal.
Imports no JAX:
    python -m pytest tests/test_torch_native_cuda.py -m cuda
Without a card every case skips (the NTT kernel has no CPU mode)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig
from dacapo_tpu_torch.crypto.cuda import ntt_kernel
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext

ARTIFACTS = Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts"
EXPECTED = ARTIFACTS / "native_test_boot" / "expected.json"
SEED = 6
CFG = dict(K=16, r=3, degree=36, baby=8)


def run_test_boot(device):
    """(output ciphertext uint32 [2, 2, N], decrypted slots, input slots)."""
    s = Scheme("test_boot", seed=SEED, device=device)
    s.generate_keys()
    bs = s.enable_native_bootstrap(BootstrapConfig(**CFG))
    vals = np.random.default_rng(3).uniform(-1, 1, s.ctx.config.n_slots)
    ct = s.encrypt(vals, scale=2.0 ** 25, nl=2)
    data, (_, scale) = bs.bootstrap(ct.data, 2, ct.scale, 1)
    return to_host(data), s.decrypt(Ciphertext(data, scale)), vals


@pytest.fixture(scope="module")
def card_and_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NTT kernel has no CPU mode")
    for k in ntt_kernel.LAUNCHES:
        ntt_kernel.LAUNCHES[k] = 0
    card = run_test_boot("cuda")
    launches = dict(ntt_kernel.LAUNCHES)
    return card, run_test_boot("cpu"), launches


@pytest.mark.cuda
def test_test_boot_bootstrap_card_equals_cpu(card_and_cpu):
    (got, out, vals), (want, _, _), launches = card_and_cpu
    np.testing.assert_array_equal(got, want)
    assert min(launches.values()) > 0, launches
    assert float(np.sqrt(np.mean((out - vals) ** 2))) < 5e-4


@pytest.mark.cuda
def test_test_boot_digest_is_the_jax_packages(card_and_cpu):
    (got, _, _), _, _ = card_and_cpu
    expected = json.loads(EXPECTED.read_text())
    assert hashlib.sha256(got.astype("<u4").tobytes()).hexdigest() == \
        expected["output_ct_sha256"]


@pytest.fixture(scope="module")
def boot_graph():
    """test_boot on the card: two inputs bootstrapped eagerly, then through
    the signature's CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    s = Scheme("test_boot", seed=SEED, device="cuda")
    s.generate_keys()
    bs = s.enable_native_bootstrap(BootstrapConfig(**CFG))
    cts = [s.encrypt(np.random.default_rng(seed).uniform(-1, 1, s.ctx.config.n_slots),
                     scale=2.0 ** 25, nl=2) for seed in (3, 4)]
    eager = [to_host(bs.bootstrap(ct.data, 2, ct.scale, 1)[0]) for ct in cts]
    rec = bs.capture(2, 2.0 ** 25, 1)
    calls, replays = bs.calls, bs.replays
    replayed = [to_host(bs.bootstrap(ct.data, 2, ct.scale, 1)[0]) for ct in cts]
    return bs, rec, eager, replayed, bs.calls - calls, bs.replays - replays


@pytest.mark.cuda
def test_replayed_bootstrap_byte_equal_to_eager(boot_graph):
    bs, rec, eager, replayed, calls, replays = boot_graph
    assert calls == replays == 2
    for a, b in zip(eager, replayed):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(replayed[0], replayed[1])
    assert min(rec["ntt"].values()) > 0 and bs._pinned
    assert bs.replayed_ntt == {k: 2 * v for k, v in rec["ntt"].items()}


@pytest.mark.cuda
def test_failed_capture_raises(boot_graph, monkeypatch):
    """A host-to-device copy under capture fails it: capture raises, keeps
    no graph and pins nothing more; the card still bootstraps eagerly."""
    bs = boot_graph[0]
    eager = bs._bootstrap
    pinned = dict(bs._pinned)

    def uploads_under_capture(*args):
        out = eager(*args)
        if torch.cuda.is_current_stream_capturing():
            torch.ones(4).to("cuda")
        return out

    monkeypatch.setattr(bs, "_bootstrap", uploads_under_capture)
    with pytest.raises(RuntimeError):
        bs.capture(2, 2.0 ** 24, 1)
    monkeypatch.undo()
    assert (2, 2.0 ** 24, 1) not in bs._graphs and bs._pinned == pinned
    zero = torch.zeros((2, 2, bs.s.ctx.n), dtype=torch.int32, device="cuda")
    out, (nl2, _) = bs.bootstrap(zero, 2, 2.0 ** 24, 1)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, nl2, bs.s.ctx.n)


@pytest.mark.cuda
def test_per_op_between_segment_requests(tmp_path):
    """The deep tpu_n15b program: the load captures its bootstrap graphs;
    segment, per-op, segment on one ciphertext: every bootstrap of a segment
    request a replay, every per-op one eager ("per_op"); the per-op request
    drops the graphs and their pins, the next segment request captures them
    again; the three outputs byte-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs have no CPU mode")
    from dacapo_tpu_torch.runtime.runner import HEVM
    art = ARTIFACTS / "deep_dacapo40_tpu_n15b"
    vm = HEVM("tpu_n15b", keyset_dir=str(tmp_path / "keys"))
    vm.load(str(art / "Deep.cst"), str(art / "Deep.hevm"))
    ex = vm.executor
    bs = ex.bootstrapper
    assert "boot_capture" in vm.load_seconds and bs._graphs
    graphs = dict(bs._graphs)
    x = np.random.default_rng(0).uniform(0.5, 0.55, vm.scheme.ctx.config.n_slots)
    nl, scale = (ex.prog.arg_level[0] + 1) * ex.rr, float(2.0 ** ex.prog.arg_scale[0])
    args = [(vm.scheme.encrypt(x, scale=scale, nl=nl).data, nl, scale)]
    outs, counts = [], []
    for jit in ("auto", False, "auto"):
        outs.append([to_host(c) for c in ex.run_encrypted(args, jit=jit)[0]])
        counts.append(ex.last_bootstraps)
        if jit is False:
            assert not bs._graphs and not bs._pinned
    assert counts == [dict(replayed=2, eager={}), dict(replayed=0, eager={"per_op": 2}),
                      dict(replayed=2, eager={})]
    assert set(bs._graphs) == set(graphs) and all(
        bs._graphs[k] is not graphs[k] for k in graphs)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)
