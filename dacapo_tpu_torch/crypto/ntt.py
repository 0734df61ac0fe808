"""Batched negacyclic NTT / inverse NTT over RNS limb planes: the plain
PyTorch version.

Port of dacapo_tpu/crypto/ntt.py. Cooley-Tukey forward (natural ->
bit-reversed evaluation order) with the negacyclic twist merged into the
twiddle table; the inverse runs the stages backwards with the inverse table
and a final N^-1. Each stage is one int64 pass over the whole batch.

This is the plain version of the hand-written CUDA kernel
(crypto/cuda/ntt_kernel.py, csrc/ntt.cu): the Evaluator runs it for tensors
on the CPU, and chip_smoke.py holds the kernel against it on the card.

Shapes: x int32 or int64 [B, N], one (prime, poly) plane per row; tw rows
gathered per plane by the caller ([B, N]); q, ninv [B, 1]. Returns int32.
"""

import torch

# calls of the plain version (the main path on a card must show 0)
CALLS = {"fwd": 0, "inv": 0}


def ntt_fwd(x, tw, q):
    """Forward negacyclic NTT. x, tw: [B, N]; q: [B, 1]."""
    CALLS["fwd"] += 1
    b, n = x.shape
    x = x.to(torch.int64)
    tw = tw.to(torch.int64)
    qe = q.to(torch.int64)[:, :, None]
    m = 1
    while m < n:
        t = n // (2 * m)
        xr = x.reshape(b, m, 2, t)
        u = xr[:, :, 0, :]
        wv = xr[:, :, 1, :] * tw[:, m: 2 * m, None] % qe
        x = torch.stack([(u + wv) % qe, (u - wv) % qe], dim=2).reshape(b, n)
        m *= 2
    return x.to(torch.int32)


def ntt_inv(x, itw, q, ninv):
    """Inverse NTT (bit-reversed evaluation order -> natural coefficients).
    itw is the elementwise inverse of the forward table; ninv = N^-1 mod q."""
    CALLS["inv"] += 1
    b, n = x.shape
    x = x.to(torch.int64)
    itw = itw.to(torch.int64)
    q = q.to(torch.int64)
    qe = q[:, :, None]
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        xr = x.reshape(b, m, 2, t)
        y0 = xr[:, :, 0, :]
        y1 = xr[:, :, 1, :]
        u = (y0 + y1) % qe
        v = (y0 - y1) % qe * itw[:, m: 2 * m, None] % qe
        x = torch.stack([u, v], dim=2).reshape(b, n)
        m //= 2
    return (x * ninv.to(torch.int64) % q).to(torch.int32)
