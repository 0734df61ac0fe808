"""NTT-friendly prime generation and root-of-unity tables (host side).

Copy of dacapo_tpu/crypto/primes.py.

Generates chains of distinct primes q = k*2N + 1 close to a target bit size so
that Z_q contains a primitive 2N-th root of unity (negacyclic NTT support).
Pure python ints — runs once at context construction.
"""

import random

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(n_ring: int, count: int, bits: int, skip=()) -> list:
    """`count` distinct primes ≡ 1 (mod 2*n_ring), descending from 2**bits.

    All primes must stay below 2**31 for the u32 arithmetic in modmath.py.
    """
    assert bits <= 31, "primes must fit u32 Montgomery arithmetic (q < 2^31)"
    two_n = 2 * n_ring
    out = []
    skipset = set(skip)
    q = (1 << bits) + 1 - two_n  # largest candidate < 2^bits with q ≡ 1 mod 2N
    while ((1 << bits) - q) % two_n != ((1 << bits) - 1) % two_n:
        q -= 1  # unreachable; kept for clarity
    # align: find largest q < 2^bits with q % two_n == 1
    q = (1 << bits) - 1
    q -= (q - 1) % two_n
    while len(out) < count:
        if q < (1 << (bits - 1)):
            raise RuntimeError("ran out of primes in the requested bit range")
        if q not in skipset and is_prime(q):
            out.append(q)
        q -= two_n
    return out


def ntt_prime_candidates(n_ring: int, bits: int, band: float, skip=()) -> list:
    """All primes ≡ 1 (mod 2N) in [2^bits(1-band), min(2^bits(1+band), 2^31))."""
    two_n = 2 * n_ring
    center = 1 << bits
    lo = int(center * (1 - band))
    hi = min(int(center * (1 + band)), (1 << 31) - 1)
    skipset = set(skip)
    out = []
    q = hi - ((hi - 1) % two_n)
    while q >= lo:
        if q not in skipset and is_prime(q):
            out.append(q)
        q -= two_n
    return out


def gen_balanced_pairs(n_ring: int, num_pairs: int, bits: int = 30,
                       band: float = 0.10, skip=()) -> list:
    """Prime pairs whose products sit maximally close to 2^(2*bits).

    This is the composite-rescale parameter trick for 32-bit-limb RNS-CKKS:
    no single NTT prime (q ≡ 1 mod 2N) lies within ~1e-3 of 2^30 at large N,
    so single-prime rescale drifts the scale by ~1% per level and add
    operands stop matching. Dropping PAIRS q_a*q_b ≈ 2^60 recovers SEAL-class
    exactness (|log2(q_a*q_b) - 60| ~ 1e-4) while keeping u32 arithmetic.

    Returns a flat list [hi_0, lo_0, hi_1, lo_1, ...] (pair k at positions
    2k, 2k+1), pairs ordered with the *best-balanced* pair FIRST (the bottom
    pair survives longest and carries the output scale).
    """
    import math

    cands = ntt_prime_candidates(n_ring, bits, band, skip)
    if len(cands) < 2 * num_pairs:
        raise RuntimeError(
            f"not enough NTT primes near 2^{bits} (have {len(cands)}, "
            f"need {2 * num_pairs}); widen the band")
    devs = sorted((math.log2(c) - bits, c) for c in cands)
    # greedy closest-to-zero-sum matching over the deviation-sorted list
    pairs = []
    pool = devs[:]
    for _ in range(num_pairs):
        best = None
        # for each candidate, binary-search its best partner
        import bisect
        for i, (d, q) in enumerate(pool):
            j = bisect.bisect_left(pool, (-d, 0))
            for k in (j - 1, j, j + 1):
                if 0 <= k < len(pool) and k != i:
                    s = abs(d + pool[k][0])
                    if best is None or s < best[0]:
                        best = (s, i, k)
        s, i, k = best
        a, b = pool[i], pool[k]
        pairs.append((s, max(a[1], b[1]), min(a[1], b[1])))
        for item in sorted((i, k), reverse=True):
            pool.pop(item)
    # best-balanced first (bottom of the chain)
    pairs.sort(key=lambda p: p[0])
    out = []
    for _, hi, lo in pairs:
        out.extend((hi, lo))
    return out


def primitive_root_2n(q: int, n_ring: int) -> int:
    """A primitive 2N-th root of unity psi mod q (psi^N = -1)."""
    two_n = 2 * n_ring
    assert (q - 1) % two_n == 0
    rng = random.Random(q)  # deterministic per prime
    while True:
        x = rng.randrange(2, q - 1)
        psi = pow(x, (q - 1) // two_n, q)
        if pow(psi, n_ring, q) == q - 1:
            return psi


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
