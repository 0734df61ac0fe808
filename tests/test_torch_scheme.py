"""The port's Scheme/KeyGenerator against the JAX package's with the same
seed: bit-equal keys and ciphertexts, equal decryptions, and keysets that
load in either package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dacapo_tpu.crypto import keys as ref_keys
from dacapo_tpu.crypto.scheme import Scheme as RefScheme, Ciphertext as RefCt
from dacapo_tpu_torch.crypto import keys
from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext

PROFILE = "test_n10"
STEPS = (5, 17)


def U(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def pair():
    ref = RefScheme(PROFILE)
    ref.generate_keys(rot_steps=STEPS)
    port = Scheme(PROFILE, device="cpu")
    port.generate_keys(rot_steps=STEPS)
    return ref, port


@pytest.mark.parametrize("name", ["s_ntt", "pk", "rlk"])
def test_keygen_bit_equal(pair, name):
    ref, port = pair
    np.testing.assert_array_equal(U(getattr(port.keys, name)),
                                  np.asarray(getattr(ref.keys, name)))


@pytest.mark.parametrize("step", STEPS)
def test_galois_bit_equal(pair, step):
    ref, port = pair
    np.testing.assert_array_equal(U(port.keys.galois[step]),
                                  np.asarray(ref.keys.galois[step]))


def test_encrypt_bit_equal_decrypt_equal(pair):
    ref, port = pair
    v = np.random.default_rng(1).uniform(-1, 1, port.ctx.config.n_slots)
    cr, cp = ref.encrypt(v, nl=6), port.encrypt(v, nl=6)
    np.testing.assert_array_equal(U(cp.data), np.asarray(cr.data))
    np.testing.assert_array_equal(port.decrypt(cp), ref.decrypt(cr))
    assert np.sqrt(np.mean((port.decrypt(cp) - v) ** 2)) < 1e-4


def test_conjugate_bit_equal():
    """Scheme.conjugate: the conjugation key made at first use, in the JAX
    package's draw order, and the conjugated ciphertext bit-equal."""
    ref, port = RefScheme(PROFILE), Scheme(PROFILE, device="cpu")
    ref.generate_keys()
    port.generate_keys()
    rng = np.random.default_rng(2)
    v = rng.uniform(-1, 1, port.ctx.config.n_slots)
    cr, cp = ref.encrypt(v, nl=6), port.encrypt(v, nl=6)
    assert port.keys.conj is None
    gr, gp = ref.conjugate(cr), port.conjugate(cp)
    np.testing.assert_array_equal(U(port.keys.conj), np.asarray(ref.keys.conj))
    np.testing.assert_array_equal(U(gp.data), np.asarray(gr.data))
    assert gp.scale == gr.scale and not torch.equal(gp.data, cp.data)
    np.testing.assert_array_equal(port.decrypt(gp), ref.decrypt(gr))
    assert np.sqrt(np.mean((port.decrypt(gp) - v) ** 2)) < 1e-3    # a keyswitch at 2^25


def test_keyset_cross_load(pair, tmp_path):
    ref, port = pair
    ref_keys.save_keyset(ref.keys, str(tmp_path / "jax"))
    keys.save_keyset(port.keys, str(tmp_path / "torch"))
    into_port = keys.load_keyset(str(tmp_path / "jax"), "cpu")
    into_ref = ref_keys.load_keyset(str(tmp_path / "torch"))
    for name in ("s_ntt", "pk", "rlk"):
        np.testing.assert_array_equal(U(getattr(into_port, name)),
                                      np.asarray(getattr(ref.keys, name)))
        np.testing.assert_array_equal(np.asarray(getattr(into_ref, name)),
                                      U(getattr(port.keys, name)))
    for st in STEPS:
        np.testing.assert_array_equal(U(into_port.galois[st]),
                                      np.asarray(ref.keys.galois[st]))
        np.testing.assert_array_equal(np.asarray(into_ref.galois[st]),
                                      U(port.keys.galois[st]))


def test_keyset_from_numpy_decrypts_reference_ct(pair):
    ref, port = pair
    d = dict(s_ntt=np.asarray(ref.keys.s_ntt), pk=np.asarray(ref.keys.pk),
             rlk=np.asarray(ref.keys.rlk),
             galois={st: np.asarray(ref.keys.galois[st]) for st in STEPS})
    other = Scheme(PROFILE, seed=99, device="cpu")
    other.keys = keys.keyset_from_numpy(d, "cpu")
    v = np.random.default_rng(2).uniform(-1, 1, port.ctx.config.n_slots)
    ct = ref.rotate(ref.encrypt(v), 5)
    data = torch.from_numpy(np.array(ct.data).view(np.int32))
    got = other.decrypt(Ciphertext(data, ct.scale))
    np.testing.assert_array_equal(got, ref.decrypt(RefCt(ct.data, ct.scale)))
    # and the port evaluates with the imported keys as the reference does
    pct = other.rotate(Ciphertext(torch.from_numpy(
        np.array(ref.encrypt(v).data).view(np.int32)), ct.scale), 17)
    assert np.sqrt(np.mean((other.decrypt(pct) - np.roll(v, -17)) ** 2)) < 1e-3


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheme(PROFILE)
