"""Every Evaluator op of the port (dacapo_tpu_torch.crypto.ops) against the
JAX package's Evaluator on the same random residues: bit-equal on test_n10
and on the composite-rescale profile test_n11c."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dacapo_tpu.crypto.ops import Evaluator as RefEv
from dacapo_tpu.crypto.params import CKKSContext as RefCtx, PROFILES
from dacapo_tpu_torch.crypto.ops import Evaluator
from dacapo_tpu_torch.crypto.params import CKKSContext

STEPS = (3, 17, 100)


class Pair:
    """Both evaluators of one profile plus random residue inputs."""

    def __init__(self, profile):
        cfg = PROFILES[profile]
        self.ref = RefEv(RefCtx(cfg))
        self.ev = Evaluator(CKKSContext(cfg, device="cpu"))
        self.cfg, self.n = cfg, cfg.n
        self.primes = np.array(self.ref.ctx.primes, dtype=np.uint64)
        self.rng = np.random.default_rng(5)
        self.nl = cfg.num_q
        self.a = self.planes(self.nl, lead=(2,))
        self.b = self.planes(self.nl, lead=(2,))
        self.pt = self.planes(self.nl)
        self.rlk = self.key()
        self.gks = [self.key() for _ in STEPS]

    def planes(self, nl, lead=(), rows=None):
        rows = list(range(nl)) if rows is None else rows
        q = self.primes[rows][:, None]
        return (self.rng.integers(0, 1 << 62, lead + (len(rows), self.n),
                                  dtype=np.uint64) % q).astype(np.uint32)

    def key(self):
        cfg = self.cfg
        return self.planes(0, lead=(cfg.dnum, 2), rows=list(range(cfg.num_all)))

    def qp_rows(self, nl):
        return list(range(nl)) + [self.cfg.num_q + i for i in range(self.cfg.alpha)]


@pytest.fixture(scope="module", params=["test_n10", "test_n11c"])
def P(request):
    return Pair(request.param)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def J(x):
    return jnp.asarray(x)


def same(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt(P, inverse):
    rows = [0, 3, 1, 3, 2]
    x = P.planes(0, rows=rows)
    f = "intt" if inverse else "ntt"
    same(getattr(P.ev, f)(T(x), rows), getattr(P.ref, f)(J(x), rows))


@pytest.mark.parametrize("op", ["add_ct", "sub_ct"])
def test_binary_ct(P, op):
    same(getattr(P.ev, op)(T(P.a), T(P.b), P.nl), getattr(P.ref, op)(J(P.a), J(P.b), P.nl))


def test_neg_ct(P):
    same(P.ev.neg_ct(T(P.a), P.nl), P.ref.neg_ct(J(P.a), P.nl))


@pytest.mark.parametrize("op", ["add_pt", "mul_pt"])
def test_plain_ops(P, op):
    same(getattr(P.ev, op)(T(P.a), T(P.pt), P.nl), getattr(P.ref, op)(J(P.a), J(P.pt), P.nl))


def test_upscale_and_mod_drop(P):
    k = (1 << 40) + 12345
    rows = P.ev.scalar_rows(k, P.nl)
    np.testing.assert_array_equal(rows, P.ref.scalar_rows(k, P.nl))
    same(P.ev.upscale_res(T(P.a), P.nl, T(rows)), P.ref.upscale_res(J(P.a), P.nl, J(rows)))
    same(P.ev.mod_drop(T(P.a), 2), P.ref.mod_drop(J(P.a), 2))


def test_rescale(P):
    rr = P.cfg.rescale_rows
    same(P.ev.rescale(T(P.a), P.nl), P.ref.rescale(J(P.a), P.nl))
    same(P.ev.rescale_k(T(P.a), P.nl, 2), P.ref.rescale_k(J(P.a), P.nl, 2))
    rows = P.ev.scalar_rows(1 << 20, P.nl)
    same(P.ev.upscale_rescale_res(T(P.a), P.nl, T(rows), rr),
         P.ref.upscale_rescale_res(J(P.a), P.nl, J(rows), rr))


@pytest.mark.parametrize("drop", [0, 3])
def test_keyswitch(P, drop):
    nl = P.nl - drop
    c = P.a[1, :nl]
    same(P.ev.modup(T(c), nl), P.ref.modup(J(c), nl))
    got = P.ev.keyswitch(T(c), nl, T(P.rlk))
    want = P.ref.keyswitch(J(c), nl, J(P.rlk))
    same(got[0], want[0])
    same(got[1], want[1])


def test_mul_ct(P):
    same(P.ev.mul_ct(T(P.a), T(P.b), P.nl, T(P.rlk)),
         P.ref.mul_ct(J(P.a), J(P.b), P.nl, J(P.rlk)))


def test_rotate(P):
    same(P.ev.automorphism(T(P.a), 17), P.ref.automorphism(J(P.a), 17))
    same(P.ev.rotate(T(P.a), P.nl, 17, T(P.gks[1])),
         P.ref.rotate(J(P.a), P.nl, 17, J(P.gks[1])))


def test_rotate_batch(P):
    nl = P.nl - 2
    a = P.a[:, :nl]
    got = P.ev.rotate_batch(T(a), nl, list(STEPS), [T(g) for g in P.gks])
    want = P.ref.rotate_batch(J(a), nl, jnp.asarray(STEPS, jnp.int32),
                              jnp.stack([J(g) for g in P.gks]))
    same(got, want)


@pytest.mark.parametrize("variant", ["taps", "extras_rescale", "extras_post", "plain_taps"])
def test_rot_mac(P, variant):
    nl = P.nl
    rr = P.cfg.rescale_rows
    pts = [P.planes(0, rows=P.qp_rows(nl)) for _ in STEPS]
    kw_ref, kw = {}, {}
    if variant == "extras_rescale":
        e = P.planes(nl, lead=(2,))
        kw_ref = dict(extras=[J(e)], fold_rescale_rows=rr)
        kw = dict(extras=[T(e)], fold_rescale_rows=rr)
    elif variant == "extras_post":
        e = P.planes(nl - rr, lead=(2,))
        kw_ref = dict(extras=[J(e)], fold_rescale_rows=rr, extras_post=True)
        kw = dict(extras=[T(e)], fold_rescale_rows=rr, extras_post=True)
    elif variant == "plain_taps":
        pv, pp = P.planes(nl, lead=(2,)), P.planes(nl)
        kw_ref = dict(plain_vals=[J(pv), J(P.b)], plain_pts=[J(pp), J(P.pt)])
        kw = dict(plain_vals=[T(pv), T(P.b)], plain_pts=[T(pp), T(P.pt)])
    got = P.ev.rot_mac(T(P.a), nl, list(STEPS), [T(g) for g in P.gks],
                       [T(p) for p in pts], **kw)
    want = P.ref.rot_mac(J(P.a), nl, jnp.asarray(STEPS, jnp.int32),
                         [J(g) for g in P.gks], [J(p) for p in pts], **kw_ref)
    same(got, want)
