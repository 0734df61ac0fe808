"""Modular arithmetic on RNS residue planes (PyTorch).

Every residue is a canonical value in [0, q) with q < 2^31, stored as
torch.int32 (the bits of the reference's uint32 planes). Additions stay in
int32 without overflow by subtracting the complement; products go through
int64, where a product of two residues fits in 62 bits.

The reference (dacapo_tpu/crypto/modmath.py) builds each product from 16-bit
half-words with Shoup or Montgomery+Shoup reduction; all of its results are
canonical residues, so `(a * b) % q` in int64 gives the same bits.
"""

import torch


def add_mod(a, b, q):
    r = a - (q - b)          # in (-q, q): no int32 overflow
    return torch.where(r < 0, r + q, r)


def sub_mod(a, b, q):
    r = a - b
    return torch.where(r < 0, r + q, r)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def mul_mod(a, b, q):
    """a * b mod q as int32 (inputs int32 or int64 residues)."""
    return (a.to(torch.int64) * b.to(torch.int64) % q).to(torch.int32)


def mul_mod_shoup(a, w, w_shoup, q):
    """a * w mod q. The Shoup companion of the reference's signature is not
    needed: the int64 product reduces exactly."""
    del w_shoup
    return mul_mod(a, w, q)


# ---------------------------------------------------------------------------
# Host-side (python int) helpers, used for table precomputation.
# ---------------------------------------------------------------------------

def host_shoup(w: int, q: int) -> int:
    return (w << 32) // q


def host_qinv_neg(q: int) -> int:
    return (-pow(q, -1, 1 << 32)) % (1 << 32)
