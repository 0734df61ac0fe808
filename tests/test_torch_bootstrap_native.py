"""The port's native bootstrap (crypto/bootstrap_native.py, dft_factor.py and
the Evaluator ops and keys it calls) against the JAX package's, bit for bit,
at test_boot on the CPU.

Both schemes share a seed and make the same keygen calls in the same order
(keys, the conjugation key, the encryption, the bootstrap's lazily made
galois keys), so their RNGs stay in step. The JAX bootstrap runs once per
module (~100 s on one core) and every comparison shares it."""

import json
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dacapo_tpu.crypto import dft_factor as ref_dft
from dacapo_tpu.crypto import keys as ref_keys
from dacapo_tpu.crypto.bootstrap_native import BootstrapConfig as RefConfig
from dacapo_tpu.crypto.scheme import Scheme as RefScheme, Ciphertext as RefCt
from dacapo_tpu_torch.crypto import dft_factor, keys
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext

PROFILE = "test_boot"
SEED = 6
CFG = dict(K=16, r=3, degree=36, baby=8)     # tests/test_bootstrap.py's
EXPECTED = os.path.join(os.path.dirname(__file__), "..", "dacapo_tpu_torch",
                        "artifacts", "native_test_boot", "expected.json")


def U(t):
    return to_host(t)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def ct_digest(t):
    """SHA-256 of the little-endian uint32 bytes of a ciphertext."""
    return hashlib.sha256(U(t).astype("<u4").tobytes()).hexdigest()


def rand_planes(ctx, shape_lead, nl, seed):
    """Uniform residues [*shape_lead, nl, N] below each row's prime."""
    qs = np.array([int(q) for q in ctx.q_primes[:nl]], dtype=np.uint64)
    rng = np.random.default_rng(seed)
    return rng.integers(0, qs[:, None], size=tuple(shape_lead) + (nl, ctx.n)).astype(np.uint32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: N=2^11 planes gain nothing from more, and the
    tests run beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX scheme, port scheme, JAX bootstrapper, port bootstrapper)."""
    ref = RefScheme(PROFILE, seed=SEED)
    ref.generate_keys()
    rbs = ref.enable_native_bootstrap(RefConfig(**CFG))
    port = Scheme(PROFILE, seed=SEED, device="cpu")
    port.generate_keys()
    pbs = port.enable_native_bootstrap(BootstrapConfig(**CFG))
    return ref, port, rbs, pbs


@pytest.fixture(scope="module")
def boot(pair):
    """One bootstrap of uniform(-1, 1) at scale 2^25, nl=2, to level 1 on
    each side, as tests/test_bootstrap.py runs it."""
    ref, port, rbs, pbs = pair
    vals = np.random.default_rng(3).uniform(-1, 1, port.ctx.config.n_slots)
    delta = 2.0 ** port.ctx.config.scale_bits
    cr = ref.encrypt(vals, scale=delta, nl=2)
    cp = port.encrypt(vals, scale=delta, nl=2)
    np.testing.assert_array_equal(U(cp.data), np.asarray(cr.data))
    want, want_meta = rbs.bootstrap(cr.data, 2, delta, 1)
    got, got_meta = pbs.bootstrap(cp.data, 2, delta, 1)
    return dict(vals=vals, want=np.asarray(want), want_meta=want_meta,
                got=got, got_meta=got_meta,
                ref_out=ref.decrypt(RefCt(want, want_meta[1])),
                port_out=port.decrypt(Ciphertext(got, got_meta[1])))


# --------------------------------------------------------------- dft_factor
@pytest.mark.parametrize("radix", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [16, 64, 256, 1 << 11])
@pytest.mark.parametrize("inverse", [False, True])
def test_build_levels_equal(n, radix, inverse):
    got = dft_factor.build_levels(n, radix, inverse)
    want = ref_dft.build_levels(n, radix, inverse)
    assert len(got) == len(want) == -(-((n // 2).bit_length() - 1) // radix)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for off in w:
            np.testing.assert_array_equal(g[off], w[off])


# ------------------------------------------------------------ evaluator ops
def test_ensure_conj_bit_equal(pair):
    ref, port, _, _ = pair
    np.testing.assert_array_equal(U(port.keys.conj), np.asarray(ref.keys.conj))
    before = port.keys.conj
    assert port.keygen.ensure_conj(port.keys).conj is before   # kept, no draw


def test_ensure_conj_without_secret_raises(pair):
    _, port, _, _ = pair
    server = keys.KeySet(s_ntt=None, pk=port.keys.pk, rlk=port.keys.rlk,
                         galois=port.keys.galois)
    with pytest.raises(RuntimeError, match="no secret key"):
        port.keygen.ensure_conj(server)
    server.conj = port.keys.conj
    assert port.keygen.ensure_conj(server).conj is port.keys.conj


# levels the test_boot bootstrap also runs: the JAX package compiles each op
# once per level
@pytest.mark.parametrize("nl", [32, 12])
def test_square_ct_bit_equal(pair, nl):
    ref, port, _, _ = pair
    a = rand_planes(port.ctx, (2,), nl, 10 + nl)
    got = port.ev.square_ct(T(a), nl, port.keys.rlk)
    want = ref.ev.square_ct(jnp.asarray(a), nl, ref.keys.rlk)
    np.testing.assert_array_equal(U(got), np.asarray(want))


@pytest.mark.parametrize("up_bits", [1, 31, 47])
def test_upscale_bit_equal(pair, up_bits):
    ref, port, _, _ = pair
    a = rand_planes(port.ctx, (2,), 2, up_bits)
    got = port.ev.upscale(T(a), 2, up_bits)
    want = ref.ev.upscale(jnp.asarray(a), 2, up_bits)
    np.testing.assert_array_equal(U(got), np.asarray(want))


def test_conj_apply_bit_equal(pair):
    ref, port, _, _ = pair
    a = rand_planes(port.ctx, (2, 3), 4, 21)
    np.testing.assert_array_equal(U(port.ev.conj_apply(T(a))),
                                  np.asarray(ref.ev.conj_apply(jnp.asarray(a))))
    np.testing.assert_array_equal(U(port.ev.conj_apply(port.ev.conj_apply(T(a)))), a)


def test_conjugate_bit_equal(pair):
    ref, port, _, _ = pair
    nl = 32
    a = rand_planes(port.ctx, (2,), nl, 30 + nl)
    got = port.ev.conjugate(T(a), nl, port.keys.conj)
    want = ref.ev.conjugate(jnp.asarray(a), nl, ref.keys.conj)
    np.testing.assert_array_equal(U(got), np.asarray(want))


def test_mod_raise_pair_bit_equal(pair):
    ref, port, rbs, pbs = pair
    a = rand_planes(port.ctx, (2,), 2, 41)
    got = pbs.mod_raise_pair(T(a), 2)
    want = rbs.mod_raise_pair(jnp.asarray(a), 2)
    assert tuple(got.shape) == (2, port.ctx.config.num_q, port.ctx.n)
    np.testing.assert_array_equal(U(got), np.asarray(want))


@pytest.mark.parametrize("nl", [1, 3])
def test_mod_raise_bit_equal(pair, nl):
    ref, port, rbs, pbs = pair
    a = rand_planes(port.ctx, (2,), nl, 50 + nl)
    np.testing.assert_array_equal(U(pbs.mod_raise(T(a), nl)),
                                  np.asarray(rbs.mod_raise(jnp.asarray(a), nl)))


# --------------------------------------------------------------- bootstrap
def test_bootstrap_bit_equal(boot):
    np.testing.assert_array_equal(U(boot["got"]), boot["want"])
    assert boot["got_meta"] == tuple(boot["want_meta"]) == (2, 2.0 ** 25)
    np.testing.assert_array_equal(boot["port_out"], boot["ref_out"])
    err = boot["port_out"] - boot["vals"]
    assert float(np.sqrt(np.mean(err * err))) < 5e-4     # tests/test_bootstrap.py:68
    assert np.max(np.abs(err)) < 5e-3


def test_bootstrap_digest_committed(boot):
    with open(EXPECTED) as f:
        expected = json.load(f)
    assert ct_digest(boot["got"]) == expected["output_ct_sha256"]
    assert [2, 2, 1 << 11] == expected["output_ct_shape"] == list(boot["got"].shape)


def test_rotation_steps_are_the_keys_made(pair, boot):
    """rotation_steps (what the executor counts) names exactly the galois
    keys the bootstrap made; both packages made the same ones."""
    ref, port, _, pbs = pair
    assert set(pbs.rotation_steps()) == set(port.keys.galois.keys()) \
        == set(ref.keys.galois.keys())
    for st in pbs.rotation_steps():
        np.testing.assert_array_equal(port.keys.galois.peek_host(st),
                                      np.asarray(ref.keys.galois.peek(st)))


@pytest.mark.parametrize("case", ["one_row", "hot"])
def test_bootstrap_value_errors(pair, case):
    ref, port, rbs, pbs = pair
    nl, scale = (1, 2.0 ** 25) if case == "one_row" else (2, 2.0 ** 58)
    zero = np.zeros((2, nl, port.ctx.n), np.uint32)
    match = "bottom prime pair" if case == "one_row" else "still hot"
    calls = pbs.calls
    with pytest.raises(ValueError, match=match):
        pbs.bootstrap(T(zero), nl, scale, 1)
    with pytest.raises(ValueError, match=match):
        rbs.bootstrap(jnp.asarray(zero), nl, scale, 1)
    assert pbs.calls == calls + (case == "hot")


# ------------------------------------------------------------------ keysets
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_keyset_with_conj_crosses_packages(pair, tmp_path, writer):
    ref, port, _, _ = pair
    if writer == "jax":
        ref_keys.save_keyset(ref.keys, str(tmp_path))
        got = keys.load_keyset(str(tmp_path), "cpu")
        np.testing.assert_array_equal(U(got.conj), np.asarray(ref.keys.conj))
        np.testing.assert_array_equal(U(got.rlk), np.asarray(ref.keys.rlk))
    else:
        keys.save_keyset(port.keys, str(tmp_path))
        got = ref_keys.load_keyset(str(tmp_path))
        np.testing.assert_array_equal(np.asarray(got.conj), U(port.keys.conj))
        np.testing.assert_array_equal(np.asarray(got.rlk), U(port.keys.rlk))
    assert os.path.exists(tmp_path / "conj.npy")
