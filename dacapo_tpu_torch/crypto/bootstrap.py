"""Bootstrapping: the emulated oracle and the dispatch (PyTorch).

Port of dacapo_tpu/crypto/bootstrap.py. `Bootstrapper` picks the native
bootstrapper (crypto/bootstrap_native.py: ModRaise, CoeffToSlot, EvalMod,
SlotToCoeff) or the `EmulatedBootstrapper`, ported on its
host-RNG path: decrypt at the chain bottom -> exact CRT lift to the target
chain -> re-encrypt with fresh randomness. It is the insecure functional
oracle the reference ships for SEAL (SEAL_HEVM.cpp:324-334, README.md:160-173
"not privacy-safe"): the server holds the secret key here, exactly as in the
reference's SEAL build. The ciphertext never leaves the device; only the
fresh encryption randomness (v, e0, e1) is drawn on the host, from the key
generator's numpy RNG in the reference's order, so the refreshed ciphertext
is bit-equal to the reference's host-RNG path.
"""

import numpy as np
import torch

from .crt_lift import pair_crt_expand, single_crt_expand
from .modmath import add_mod, mul_mod

# Headroom for the exact integer lift: polynomial COEFFICIENTS of the raw
# message (~scale * slot-bound) must stay below the lift base q0*q1/2, so
# inputs that arrive hot (zero-depth boundaries leave them at up to
# Delta~2^60 ~ q0*q1) are first cooled by exact single-row rescales.
_LIFT_VMAX_BITS = 13


def _lift_limit(ctx):
    return np.log2(float(ctx.q_primes[0]) * float(ctx.q_primes[1])) - 1


def _cool_input(s, data, nl, scale, limit_log2):
    """Rescale single RNS rows (exact division) until log2(scale) +
    _LIFT_VMAX_BITS <= limit_log2. Returns (data, nl, scale, K) where K is
    the exact integer product of the dropped primes (1 if none)."""
    data = data[:, :nl, :]
    K = 1
    while nl > 2 and np.log2(scale) + _LIFT_VMAX_BITS > limit_log2:
        data = s.ev.rescale_k(data, nl, 1)
        K *= int(s.ctx.q_primes[nl - 1])
        scale /= float(s.ctx.q_primes[nl - 1])
        nl -= 1
    return data, nl, scale, K


def _reheat(ctx, lifted, num_rows, K):
    """Multiply lifted coefficient planes [..., num_rows, N] by the exact
    integer K (mod each prime): restores the pre-cooling scale, so the oracle
    is scale-preserving like the reference SEAL oracle and like the
    executor's OP_BOOTSTRAP meta rule. K (a product of dropped primes, above
    2^31 for two or more) is reduced mod each q in Python integers."""
    qs = [int(ctx.q_primes[i]) for i in range(num_rows)]
    # exactness: |K * centered| < prod(qs)/2 (message stayed under q0*q1/2)
    assert np.log2(float(K)) + np.log2(float(qs[0])) + np.log2(float(qs[1])) \
        < sum(np.log2(float(q)) for q in qs), \
        "reheat would overflow the target chain modulus"
    dev = lifted.device
    km = torch.tensor([K % q for q in qs], dtype=torch.int64, device=dev)[:, None]
    q = torch.tensor(qs, dtype=torch.int64, device=dev)[:, None]
    return mul_mod(lifted, km, q)


class EmulatedBootstrapper:
    def __init__(self, scheme):
        self.s = scheme
        assert scheme.keys is not None and scheme.keys.s_ntt is not None, \
            "emulated bootstrapping needs the secret key (full VM mode)"
        self.calls = 0          # bootstraps run, for the chip smoke's check

    def _plan(self, nl, scale, target_level):
        """Static cooling plan for (nl, scale): returns (n_drop, K, nl2)."""
        ctx = self.s.ctx
        nl2 = (target_level + 1) * ctx.config.rescale_rows
        limit = _lift_limit(ctx)
        K, n_drop, nlc, sc = 1, 0, nl, scale
        while nlc > 2 and np.log2(sc) + _LIFT_VMAX_BITS > limit:
            K *= int(ctx.q_primes[nlc - 1])
            sc /= float(ctx.q_primes[nlc - 1])
            nlc -= 1
            n_drop += 1
        return n_drop, K, nl2

    def bootstrap(self, data, nl, scale, target_level):
        """Refresh int32 [2, >=nl, N] at `nl` rows to the chain of
        `target_level`: cool, m = c0 + c1*s at the bottom row(s), iNTT,
        exact CRT lift, reheat, NTT, plus a fresh encryption. Returns
        (data [2, nl2, N], (nl2, scale)); the scale is kept."""
        self.calls += 1
        s = self.s
        ctx = s.ctx
        ev = s.ev
        nl2 = (target_level + 1) * ctx.config.rescale_rows
        orig_scale = scale
        data, nl, scale, K = _cool_input(s, data, nl, scale, _lift_limit(ctx))
        nb = 2 if nl >= 2 else 1                       # base rows for the lift
        rows = list(range(nb))
        q = ev._q(rows)
        m_ntt = add_mod(data[0, :nb], mul_mod(data[1, :nb], s.keys.s_ntt[:nb], q), q)
        c = ev.intt(m_ntt, rows)                       # [nb, N] coeffs
        if nb == 2:
            lifted = pair_crt_expand(ctx, c[0], c[1], nl2)
        else:
            lifted = single_crt_expand(ctx, c[0], nl2)
        if K != 1:
            lifted = _reheat(ctx, lifted, nl2, K)
            scale = orig_scale
        rows2 = list(range(nl2))
        m2 = ev.ntt(lifted, rows2)

        # fresh encryption of m2: host RNG for v/e in the reference's order
        kg = s.keygen
        v = kg._ntt_planes(kg._ternary(), rows2)
        e0 = kg._ntt_planes(kg._gauss(), rows2)
        e1 = kg._ntt_planes(kg._gauss(), rows2)
        q2 = ev._q(rows2)
        pk = s.keys.pk[:, :nl2, :]
        c0 = add_mod(add_mod(mul_mod(v, pk[0], q2), e0, q2), m2, q2)
        c1 = add_mod(mul_mod(v, pk[1], q2), e1, q2)
        return torch.stack([c0, c1]), (nl2, scale)


def Bootstrapper(scheme, native=None):
    """The scheme's native bootstrapper once enable_native_bootstrap ran
    (unless native=False), a new one for native=True, else the oracle.

    Unlike the JAX package, a profile made for native bootstrapping
    (config.native_bootstrap) never falls back to the oracle by itself: it
    raises until the native path is enabled, or the caller asks for the
    oracle with native=False."""
    nb = scheme._native_bs
    if nb is not None and native is not False:
        return nb
    if native:
        from .bootstrap_native import NativeBootstrapper
        return NativeBootstrapper(scheme)
    if native is None and scheme.ctx.config.native_bootstrap:
        raise RuntimeError(
            "this profile bootstraps natively: call scheme.enable_native_bootstrap() "
            "first (HEVM does), or pass native=False for the oracle")
    return EmulatedBootstrapper(scheme)
