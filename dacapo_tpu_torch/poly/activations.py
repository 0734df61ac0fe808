"""Activation polynomials (copy of dacapo_tpu/poly/activations.py; SiLU coefficients pinned).

The reference ships pretrained Chebyshev coefficient files
(python/poly/poly/data/sgn151527.txt, tree15/27.txt; loaded by Poly.py:10-29)
for a 15/15/27-degree composite sign. Here the coefficient sets are fitted
numerically at first use (iteratively-reweighted least squares on odd
Chebyshev bases — near-minimax) and cached, so no external data is needed.

Composition contract (matching the reference's usage, Func.py:74-86):
  sign(x) ~ returns ±0.5 for |x| in [d1, 1];  HE_ReLU = (0.5 + sign(x)) * x.
Each stage's series is stored pre-divided by 2 so stage outputs live near
±0.5 and the next stage's fit domain is centered at 0.5.
"""

import os

import numpy as np

from .mpcb import gen_poly_from_cheb
from ..ir import trace as hc

_CACHE = os.path.join(os.path.dirname(__file__), "_signpoly_cache.npz")
_D1 = 0.02          # smallest resolvable |x| for the sign composite


def _fit_odd_sign(lo, hi, deg, n_iter=40):
    """Odd Chebyshev series approximating 1 on [lo, hi] (and -1 on mirror).

    Iteratively reweighted LS pushes toward equioscillation.
    """
    xs = np.concatenate([
        np.linspace(lo, hi, 4000),
        lo * np.linspace(1.0, 1.02, 50),    # guard the inner edge
    ])
    odd_degs = np.arange(1, deg + 1, 2)
    basis = np.stack([np.cos(k * np.arccos(np.clip(xs, -1, 1)))
                      for k in odd_degs], axis=1)
    w = np.ones_like(xs)
    coef = None
    for _ in range(n_iter):
        a = basis * w[:, None]
        b = np.ones_like(xs) * w
        sol, *_ = np.linalg.lstsq(a, b, rcond=None)
        err = basis @ sol - 1.0
        w = w * (1.0 + np.abs(err) / (np.abs(err).max() + 1e-12))
        w /= w.max()
        coef = sol
    full = np.zeros(deg + 1)
    full[odd_degs] = coef
    emax = float(np.abs(basis @ coef - 1.0).max())
    return full, emax


def _fit_stages():
    """Fit the 15/15/27 composite; each stored series already includes the
    /2 output scaling."""
    c1, e1 = _fit_odd_sign(_D1, 1.0, 15)
    lo2, hi2 = (1 - e1) / 2, (1 + e1) / 2
    c2, e2 = _fit_odd_sign(lo2, hi2, 15)
    lo3, hi3 = (1 - e2) / 2, (1 + e2) / 2
    c3, e3 = _fit_odd_sign(lo3, hi3, 27)
    return c1 / 2, c2 / 2, c3 / 2, e3 / 2


def _load_or_fit():
    if os.path.exists(_CACHE):
        z = np.load(_CACHE)
        return z["c1"], z["c2"], z["c3"]
    c1, c2, c3, _ = _fit_stages()
    try:
        np.savez(_CACHE, c1=c1, c2=c2, c3=c3)
    except OSError:
        pass
    return c1, c2, c3


_polys = None


def _stage_polys():
    global _polys
    if _polys is None:
        c1, c2, c3 = _load_or_fit()
        _polys = (
            gen_poly_from_cheb(c1, 4),
            gen_poly_from_cheb(c2, 4),
            gen_poly_from_cheb(c3, 8),
        )
    return _polys


def poly1(x):
    return _stage_polys()[0](x)


def poly2(x):
    return _stage_polys()[1](x)


def poly3(x):
    return _stage_polys()[2](x)


def sign(x):
    """Plain composite (no bootstrap) — returns ~±0.5 (Poly.py:33-34)."""
    return poly3(poly2(poly1(x)))


def maxx(a, b):
    """max(a, b) via sign with an embedded bootstrap (Poly.py:41-49)."""
    d = a - b
    s = poly2(poly1(d))
    s = hc.bootstrap(s) if isinstance(s, hc.Expr) else s
    s = poly3(s)
    return (0.5 * (a + b)) + d * s


def relua(x, a):
    return (sign(x) * x) + (sign(x - a) * (a - x)) + (a / 2)


def genRelu6(b):
    return lambda x: relua(x, 6 / b)


# ---------------------------------------------------------------- SiLU
_silu_polys = {}
# Fitted coefficients of the default SiLU series, as the JAX package's numpy
# fits them (scripts/make_resnet_artifact.py writes the file): the lstsq
# behind chebfit rounds differently on other LAPACK builds, and the traced
# constants (the .cst) must not depend on the machine that traces.
_SILU_CACHE = os.path.join(os.path.dirname(__file__), "_silu_cache.npz")


def silu_fit(bb, degree):
    """Odd Chebyshev least-squares fit of sigmoid(bb*x) - 0.5 on [-1, 1]."""
    xs = np.cos(np.pi * (np.arange(4001) + 0.5) / 4001)   # cheb nodes
    ys = 1.0 / (1.0 + np.exp(-bb * xs)) - 0.5
    coef = np.polynomial.chebyshev.chebfit(xs, ys, degree)
    coef[::2] = 0.0
    return coef


def silu_cache_key(bb, degree):
    return f"bb{float(bb)!r}_deg{degree}"


def _silu_coef(bb, degree):
    if os.path.exists(_SILU_CACHE):
        with np.load(_SILU_CACHE) as z:
            if silu_cache_key(bb, degree) in z.files:
                return z[silu_cache_key(bb, degree)]
    return silu_fit(bb, degree)


def silu_half_poly(length=16, bb=32.0, degree=127):
    """Odd Chebyshev fit of sigmoid(bb*x) - 0.5 on [-1, 1].

    The reference's coeffStr.txt data is a degree-95 series fitting the
    slot-domain sigmoid at block scale bb=32 (the whole model runs on x/bb,
    so HE_SiLU(u) = u*(sigma(bb*u)-0.5+0.5) = silu(bb*u)/bb). We default to
    degree 127: the BSGS top divisor (64) and hence the multiplicative depth
    (14) are IDENTICAL to degree 95, but the trained-checkpoint ResNet plain
    RMS drops 1.23e-3 -> 2.99e-5 (measured, scripts/trained_plain_probe.py)
    — the reference's 95 leaves the SiLU fit as the dominant error term.
    `length` is the BSGS baby count (reference GenPoly degree=16).
    """
    key = (length, float(bb), degree)
    p = _silu_polys.get(key)
    if p is None:
        p = _silu_polys[key] = gen_poly_from_cheb(_silu_coef(bb, degree), length)
    return p


def GenPoly(degree=16, bb=32.0):
    return silu_half_poly(length=degree, bb=bb)


# numpy reference helpers (Poly.py:51-58)
def ReLU(z):
    return np.maximum(0, z)


def rms(z):
    return np.sqrt(np.mean(np.square(z)))


def nprelu(x):
    return np.array([np.maximum(xx, 0) for xx in x], dtype=object)
