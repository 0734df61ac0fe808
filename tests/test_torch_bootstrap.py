"""The port's oracle bootstrap and CRT lift against the JAX package's, bit for
bit, at test_n10 (and the composite test_n11c) on the CPU. Both sides run
their host-RNG oracle (host_rng=True here, DACAPO_TPU_ORACLE_JIT=0 there);
both schemes share a seed and make the same calls in the same order, so their
RNGs stay in step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dacapo_tpu.crypto import bootstrap as ref_bs
from dacapo_tpu.crypto import crt_lift as ref_crt
from dacapo_tpu.crypto.scheme import Scheme as RefScheme, Ciphertext as RefCt
from dacapo_tpu_torch.crypto import bootstrap as bs
from dacapo_tpu_torch.crypto import crt_lift as crt
from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext

PROFILE = "test_n10"


def U(t):
    return t.numpy().view(np.uint32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _centered(v, q):
    """Python-integer centered representative of v in [0, q)."""
    return v - q if v > (q - 1) // 2 else v


_PAIRS = {}


def _pair(profile):
    """(JAX scheme, port scheme) of one profile and seed, keys generated."""
    if profile not in _PAIRS:
        ref = RefScheme(profile)
        ref.generate_keys()
        port = Scheme(profile, device="cpu")
        port.generate_keys()
        assert [int(q) for q in ref.ctx.q_primes] == [int(q) for q in port.ctx.q_primes]
        _PAIRS[profile] = ref, port
    return _PAIRS[profile]


@pytest.fixture(scope="module")
def pair():
    return _pair(PROFILE)


@pytest.fixture
def host_oracle(monkeypatch):
    monkeypatch.setenv("DACAPO_TPU_ORACLE_JIT", "0")


def test_pair_crt_expand_bit_equal(pair):
    ref, port = pair
    q0, q1 = (int(q) for q in port.ctx.q_primes[:2])
    half = (q0 * q1 - 1) // 2
    t_half, v0_half = half // q0, half % q0
    # the centering boundary: (t, v0) around (t_half, v0_half), v around 0
    vals = [t * q0 + v0 for t in (t_half - 1, t_half, t_half + 1)
            for v0 in (v0_half - 1, v0_half, v0_half + 1)]
    vals += [0, 1, q0 * q1 - 1, half, half + 1, q0, q1]
    rng = np.random.default_rng(3)
    vals += [int(x) for x in rng.integers(0, q0 * q1, port.ctx.n - len(vals),
                                          dtype=np.int64)]
    v0 = np.array([v % q0 for v in vals], np.uint32)
    v1 = np.array([v % q1 for v in vals], np.uint32)
    rows = port.ctx.config.num_q
    got = U(crt.pair_crt_expand(port.ctx, T(v0), T(v1), rows))
    want = np.asarray(ref_crt.pair_crt_expand(ref.ctx, jnp.asarray(v0),
                                              jnp.asarray(v1), rows))
    np.testing.assert_array_equal(got, want)
    for i in range(rows):
        q = int(port.ctx.q_primes[i])
        assert [int(x) for x in got[i, :20]] == \
            [_centered(v, q0 * q1) % q for v in vals[:20]]


def test_single_crt_expand_bit_equal(pair):
    ref, port = pair
    q0 = int(port.ctx.q_primes[0])
    edge = np.array([0, 1, q0 // 2 - 1, q0 // 2, q0 // 2 + 1, q0 - 1], np.int64)
    rest = np.random.default_rng(4).integers(0, q0, port.ctx.n - edge.size)
    v0 = np.concatenate([edge, rest]).astype(np.uint32)
    rows = port.ctx.config.num_q
    got = U(crt.single_crt_expand(port.ctx, T(v0), rows))
    want = np.asarray(ref_crt.single_crt_expand(ref.ctx, jnp.asarray(v0), rows))
    np.testing.assert_array_equal(got, want)
    for i in range(rows):
        q = int(port.ctx.q_primes[i])
        assert [int(x) for x in got[i, :6]] == [_centered(int(v), q0) % q for v in edge]


def test_reheat_bit_equal_two_dropped_primes(pair):
    ref, port = pair
    qs = [int(q) for q in port.ctx.q_primes]
    K = qs[-1] * qs[-2]                      # above 2^31: reduced in Python ints
    rows = 6
    lifted = np.stack([np.random.default_rng(5 + i).integers(0, qs[i], port.ctx.n)
                       for i in range(rows)]).astype(np.uint32)
    got = U(bs._reheat(port.ctx, T(lifted), rows, K))
    want = np.asarray(ref_bs._reheat(ref.ctx, jnp.asarray(lifted), rows, K))
    np.testing.assert_array_equal(got, want)


def _encrypt_both(ref, port, v, nl, up_bits=0):
    cr, cp = ref.encrypt(v, nl=nl), port.encrypt(v, nl=nl)
    if up_bits:
        cr, cp = ref.upscale(cr, up_bits), port.upscale(cp, up_bits)
    np.testing.assert_array_equal(U(cp.data), np.asarray(cr.data))
    assert cp.scale == cr.scale
    return cr, cp


@pytest.mark.parametrize("profile, nl, up_bits, n_drop, target", [
    (PROFILE, 8, 0, 0, 5),       # cool, scale 2^25: lifts as it is
    (PROFILE, 8, 60, 2, 5),      # hot, scale 2^85: two single-row rescales, reheat
    (PROFILE, 1, 0, 0, 5),       # one row left: the single-base lift
    ("test_n11c", 16, 30, 1, 3),  # composite chain (2 rows a level), hot at 2^70:
                                  # one row dropped leaves an odd row count
])
def test_bootstrap_bit_equal(host_oracle, profile, nl, up_bits, n_drop, target):
    ref, port = _pair(profile)
    v = np.random.default_rng(7).uniform(-0.5, 0.5, port.ctx.config.n_slots)
    cr, cp = _encrypt_both(ref, port, v, nl, up_bits)

    ob = bs.Bootstrapper(port, host_rng=True)
    assert ob._plan(nl, cp.scale, target)[0] == n_drop
    if n_drop:
        _, nl_c, _, K = bs._cool_input(port, cp.data, nl, cp.scale, bs._lift_limit(port.ctx))
        assert nl_c == nl - n_drop
        assert K == ob._plan(nl, cp.scale, target)[1] == \
            int(np.prod([int(q) for q in port.ctx.q_primes[nl - n_drop: nl]], dtype=object))
    got, (nl2, sc2) = ob.bootstrap(cp.data, nl, cp.scale, target)
    want, (rnl2, rsc2) = ref_bs.Bootstrapper(ref).bootstrap(cr.data, nl, cr.scale, target)
    rr = port.ctx.config.rescale_rows
    assert (nl2, sc2) == (rnl2, rsc2) == ((target + 1) * rr, cp.scale)
    np.testing.assert_array_equal(U(got), np.asarray(want))
    out = port.decrypt(Ciphertext(got, sc2))
    np.testing.assert_array_equal(out, ref.decrypt(RefCt(want, rsc2)))
    assert np.max(np.abs(out - v)) < 1e-3
