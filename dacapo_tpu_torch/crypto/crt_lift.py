"""Centered CRT lift of coefficient planes to a longer RNS chain (PyTorch).

Port of dacapo_tpu/crypto/crt_lift.py, used by the oracle bootstrap
(bootstrap.py) and the native bootstrap's ModRaise: given residues modulo the
bottom prime (or the bottom prime PAIR, the ~2^60 composite base, or, for the
device oracle's exact lift, the bottom k primes), produce the centered
representative modulo every prime of the target chain. Residues are int32 tensors holding canonical
values below 2^31; products go through int64 like the rest of the port
(modmath.py), so every result is the canonical residue the reference's
uint32 Shoup arithmetic gives.
"""

import torch

from .params import upload


def _col(ctx, values):
    """int64 [len(values), 1] tensor on the context's device, made once per
    context and values: a call under CUDA graph capture (the device oracle,
    crypto/bootstrap.py) finds its constants already there, since no upload
    from host memory may run under capture."""
    key = tuple(values)
    t = ctx._col_cache.get(key)
    if t is None:
        t = ctx._col_cache[key] = upload(torch.tensor(values, dtype=torch.int64),
                                         ctx.device)[:, None]
    return t


def crt_expand(ctx, vs, num_rows):
    """Residues v_i mod q_i of the bottom k primes (vs: k tensors [..., N])
    -> the centered v mod q_j for j < num_rows, int32 [..., num_rows, N].

    Garner's mixed radix: v = x_0 + q_0 x_1 + q_0 q_1 x_2 + ... with digits
    x_i < q_i; v mod q_j = sum_i (q_0...q_{i-1} mod q_j) x_i (mod q_j), minus
    Q = q_0...q_{k-1} when the digits exceed those of (Q - 1) / 2, compared
    from the top (the centering). Every product is below 2^62."""
    qb = [int(ctx.q_primes[i]) for i in range(len(vs))]
    radix = [1]                                      # q_0 ... q_{i-1}
    for q in qb[:-1]:
        radix.append(radix[-1] * q)
    xs = []
    for i, v in enumerate(vs):
        q = qb[i]
        lower = sum((radix[j] % q) * x % q for j, x in enumerate(xs))
        xs.append((v.to(torch.int64) - lower) % q * pow(radix[i], -1, q) % q)

    Q = radix[-1] * qb[-1]
    half, neg, eq = (Q - 1) // 2, None, None
    for i in reversed(range(len(xs))):
        h = half // radix[i] % qb[i]
        gt, same = xs[i] > h, xs[i] == h
        neg = gt if neg is None else neg | (eq & gt)
        eq = same if eq is None else eq & same

    qs = [int(ctx.q_primes[j]) for j in range(num_rows)]
    q_r = _col(ctx, qs)
    r = sum(_col(ctx, [radix[i] % q for q in qs]) * x[..., None, :] % q_r
            for i, x in enumerate(xs)) % q_r        # [..., rows, N]
    r = torch.where(neg[..., None, :], (r - _col(ctx, [Q % q for q in qs])) % q_r, r)
    return r.to(torch.int32)


def pair_crt_expand(ctx, v0, v1, num_rows):
    """Residues (v0 mod q0, v1 mod q1) [..., N] -> centered v mod q_i for
    i < num_rows, int32 [..., num_rows, N]: crt_expand of the bottom pair,
    the ~2^60 composite base."""
    return crt_expand(ctx, [v0, v1], num_rows)


def single_crt_expand(ctx, v0, num_rows):
    """Residue v0 mod q0 [..., N] -> centered v mod q_i, int32
    [..., num_rows, N] (single-prime base; requires q_i > q0/2 so one
    corrective add suffices)."""
    q0 = int(ctx.q_primes[0])
    qs = [int(ctx.q_primes[i]) for i in range(num_rows)]
    assert all(q > q0 // 2 for q in qs), "single-base lift needs q_i > q0/2"
    v = v0.to(torch.int64)[..., None, :]
    corr = _col(ctx, [q - q0 for q in qs])
    return torch.where(v > q0 // 2, v + corr, v).to(torch.int32)
