"""The port's modular arithmetic (dacapo_tpu_torch.crypto.modmath) against
the JAX package's (dacapo_tpu.crypto.modmath): bit-equal on random residues
of the test_n11 primes, including the edge values 0 and q-1."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dacapo_tpu.crypto import modmath as ref
from dacapo_tpu.crypto.params import CKKSContext, PROFILES
from dacapo_tpu_torch.crypto import modmath as port

CTX = CKKSContext(PROFILES["test_n11"])
N = 4096


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, len(CTX.primes), N)
    q = np.array(CTX.primes, dtype=np.int64)[rows]
    a = rng.integers(0, q)
    b = rng.integers(0, q)
    a[:4], b[:4] = [0, 0, q[2] - 1, q[3] - 1], [0, q[1] - 1, 0, q[3] - 1]
    return rows, q, a, b


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64).astype(np.int32))


def _u(x):
    return jnp.asarray(np.asarray(x, np.int64).astype(np.uint32))


def _got(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("op", ["add_mod", "sub_mod"])
def test_binary(data, op):
    _, q, a, b = data
    want = np.asarray(getattr(ref, op)(_u(a), _u(b), _u(q)))
    got = getattr(port, op)(_t(a), _t(b), _t(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_got(got), want)


def test_neg_mod(data):
    _, q, a, _ = data
    want = np.asarray(ref.neg_mod(_u(a), _u(q)))
    np.testing.assert_array_equal(_got(port.neg_mod(_t(a), _t(q))), want)


def test_mul_mod(data):
    rows, q, a, b = data
    h = CTX.host_tables
    want = np.asarray(ref.mul_mod(_u(a), _u(b), _u(q), jnp.asarray(h["qinv_neg"][rows]),
                                  jnp.asarray(h["rconst"][rows]),
                                  jnp.asarray(h["rconst_shoup"][rows])))
    np.testing.assert_array_equal(_got(port.mul_mod(_t(a), _t(b), _t(q))), want)


def test_mul_mod_shoup(data):
    _, q, a, w = data
    ws = (w << 32) // q
    want = np.asarray(ref.mul_mod_shoup(_u(a), _u(w), _u(ws), _u(q)))
    got = port.mul_mod_shoup(_t(a), _t(w), _t(ws), _t(q))
    np.testing.assert_array_equal(_got(got), want)


@pytest.mark.parametrize("helper", ["host_shoup", "host_qinv_neg"])
def test_host_helpers(helper):
    for q in CTX.primes:
        args = (q,) if helper == "host_qinv_neg" else (q - 12345, q)
        assert getattr(port, helper)(*args) == getattr(ref, helper)(*args)
