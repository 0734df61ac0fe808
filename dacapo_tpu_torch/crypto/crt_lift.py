"""Centered CRT lift of coefficient planes to a longer RNS chain (PyTorch).

Port of dacapo_tpu/crypto/crt_lift.py, used by the oracle bootstrap
(bootstrap.py): given residues modulo the bottom prime (or the bottom prime
PAIR, the ~2^60 composite base), produce the centered representative modulo
every prime of the target chain. Residues are int32 tensors holding canonical
values below 2^31; products go through int64 like the rest of the port
(modmath.py), so every result is the canonical residue the reference's
uint32 Shoup arithmetic gives.
"""

import torch


def _col(values, like):
    """int64 [len(values), 1] tensor on the device of `like`."""
    return torch.tensor(values, dtype=torch.int64, device=like.device)[:, None]


def pair_crt_expand(ctx, v0, v1, num_rows):
    """Residues (v0 mod q0, v1 mod q1) [..., N] -> centered v mod q_i for
    i < num_rows, int32 [..., num_rows, N].

    v = v0 + q0*t with t = (v1 - v0) * q0^{-1} mod q1; per-row
    v mod q_i = v0 + (q0 mod q_i)*t (mod q_i), minus q0*q1 when
    (t, v0) > (t_half, v0_half) lexicographically (the centering)."""
    q0, q1 = int(ctx.q_primes[0]), int(ctx.q_primes[1])
    v0 = v0.to(torch.int64)
    t = (v1.to(torch.int64) - v0) % q1 * pow(q0, -1, q1) % q1

    half = (q0 * q1 - 1) // 2
    t_half, v0_half = half // q0, half % q0
    neg = (t > t_half) | ((t == t_half) & (v0 > v0_half))

    qs = [int(ctx.q_primes[i]) for i in range(num_rows)]
    q_r = _col(qs, v0)
    q0m = _col([q0 % q for q in qs], v0)
    q01m = _col([(q0 * q1) % q for q in qs], v0)
    r = (v0[..., None, :] + q0m * t[..., None, :]) % q_r       # [..., rows, N]
    r = torch.where(neg[..., None, :], (r - q01m) % q_r, r)
    return r.to(torch.int32)


def single_crt_expand(ctx, v0, num_rows):
    """Residue v0 mod q0 [..., N] -> centered v mod q_i, int32
    [..., num_rows, N] (single-prime base; requires q_i > q0/2 so one
    corrective add suffices)."""
    q0 = int(ctx.q_primes[0])
    qs = [int(ctx.q_primes[i]) for i in range(num_rows)]
    assert all(q > q0 // 2 for q in qs), "single-base lift needs q_i > q0/2"
    v = v0.to(torch.int64)[..., None, :]
    corr = _col([q - q0 for q in qs], v0)
    return torch.where(v > q0 // 2, v + corr, v).to(torch.int32)
