"""FFT factorization of the CKKS slot<->coefficient transform as sparse
diagonals.

Copy of dacapo_tpu/crypto/dft_factor.py (host numpy; no device code).

The dense "twisted DFT" A[j,k] = zeta^{5^j * k} (zeta = exp(i*pi/N), slots
s = N/2) used by bootstrapping's CoeffToSlot / SlotToCoeff is O(s) diagonals —
prohibitive beyond toy sizes. Like HEaaN/Lattigo (the component the reference
licenses out, lib/Runtime/HEAAN_HEVM.cpp:386-399), we use the classical
radix-2 factorization

    A = S_{log s} .. S_2 S_1 P_brv

where P_brv is the bit-reversal permutation and each butterfly stage S_i has
at most 3 nonzero diagonals (offsets {0, +t, -t}, t = s / 2^i; stage 1 has 2
since +-s/2 coincide). The derivation rides the group structure of 5 mod 2N:
ord(5 mod N) = s/2, and 5^(s/2) = N+1 (mod 2N), so zeta^(5^(j+s/2)) =
-zeta^(5^j) — exactly a Cooley-Tukey butterfly on the odd/even coefficient
split with twiddles w_j = zeta^(5^j * (N / 2^i ... )) per stage.

The bit-reversal permutation is never materialized: CoeffToSlot applies the
inverse stages (S_1^-1 .. S_{log s}^-1), leaving slot j holding coefficient
brv(j) — EvalMod is pointwise so the order is irrelevant — and SlotToCoeff
re-applies the forward stages, undoing it.

Stages are merged `radix` at a time into level matrices (diagonal-dict
products, never dense), trading depth ceil(log s / radix) against
O(2^radix) diagonals per level, each evaluated with BSGS + hoisted
rotations. Verified against the dense matrix for small s in
tests/test_dft_factor.py.
"""

import numpy as np


def _brv_perm(logs):
    s = 1 << logs
    out = np.zeros(s, dtype=np.int64)
    for i in range(s):
        r = 0
        x = i
        for _ in range(logs):
            r = (r << 1) | (x & 1)
            x >>= 1
        out[i] = r
    return out


def five_powers(n, s):
    """e[j] = 5^j mod 2N for j in [0, s)."""
    e = np.empty(s, dtype=np.int64)
    g = 1
    for j in range(s):
        e[j] = g
        g = (g * 5) % (2 * n)
    return e


def forward_stage_diags(n, i):
    """Diagonals of butterfly stage S_i (1-indexed), acting on slot vectors
    of size s = n/2; convention (M u)_j = sum_d diag[d][j] * u[(j+d) % s].

    Stage i combines blocks of size 2t, t = s/2^i: within each block
      out[j]     = u[j] + w_j * u[j+t]        (j in top half of block)
      out[j+t]   = u[j] - w_j * u[j+t]
    with twiddle w_j = zeta^(e5[j] * 2^(i-1) mod 2N). Derivation: the CT
    split on even/odd coefficients gives z_j = E_j + zeta^(e5[j]) O_j and,
    because 5^(s/2) = N+1 (mod 2N) and e5[j] is odd,
    zeta^(e5[j+s/2]) = -zeta^(e5[j]) — the classical butterfly. Each
    recursion depth squares the root (zeta -> zeta^2), so depth d = i-1
    uses zeta^(e5[j]*2^d); the pattern is 2t-periodic in j (ord(5 mod
    N/2^(d-1)) = s/2^d), so indexing by the global j is exact.
    """
    s = n // 2
    t = s >> i
    # Evaluation points of the size-(s / 2^(i-1)) sub-transforms at stage i:
    # the recursion halves the point set by squaring: after (i-1) splits the
    # block containing global row j evaluates at zeta^(e5[j] * 2^(i-1)) of
    # the reduced root; the odd-part twiddle multiplying u[j+t] is
    # zeta^(e5[j] * 2^(i-1)).
    e = five_powers(n, s)
    two_n = 2 * n
    w = np.exp(1j * np.pi / n * ((e * (1 << (i - 1))) % two_n))
    d0 = np.ones(s, dtype=np.complex128)
    dp = np.zeros(s, dtype=np.complex128)   # offset +t
    dm = np.zeros(s, dtype=np.complex128)   # offset -t (== s-t)
    jj = np.arange(s)
    top = (jj % (2 * t)) < t               # rows taking u[j] + w u[j+t]
    dp[top] = w[top]
    d0[~top] = -w[jj[~top] - t]
    dm[~top] = 1.0
    d0[top] = 1.0
    if t * 2 == s:
        # +t and -t are the same rotation; merge
        return {0: d0, t: dp + dm}
    out = {0: d0}
    if np.any(dp):
        out[t] = dp
    if np.any(dm):
        out[(s - t) % s] = dm
    return out


def inverse_stage_diags(n, i):
    """Diagonals of S_i^{-1}: butterfly inverse
       u[j]   = (z[j] + z[j+t]) / 2
       u[j+t] = (z[j] - z[j+t]) * w_j^{-1} / 2
    """
    s = n // 2
    t = s >> i
    e = five_powers(n, s)
    two_n = 2 * n
    winv = np.exp(-1j * np.pi / n * ((e * (1 << (i - 1))) % two_n))
    d0 = np.zeros(s, dtype=np.complex128)
    dp = np.zeros(s, dtype=np.complex128)
    dm = np.zeros(s, dtype=np.complex128)
    jj = np.arange(s)
    top = (jj % (2 * t)) < t
    d0[top] = 0.5
    dp[top] = 0.5
    d0[~top] = -0.5 * winv[jj[~top] - t]
    dm[~top] = 0.5 * winv[jj[~top] - t]
    if t * 2 == s:
        return {0: d0, t: dp + dm}
    out = {0: d0}
    if np.any(dp):
        out[t] = dp
    if np.any(dm):
        out[(s - t) % s] = dm
    return out


def diag_mul(a, b, s, tol=0.0):
    """Diagonal dict of (A @ B): (AB)u_j = sum A_j,k B_k,l u_l.
    With (M u)_j = sum_d diag[d][j] u[(j+d)%s]:
      (AB) diag at offset (da+db): d[j] += A_da[j] * B_db[(j+da) % s].
    """
    out = {}
    jj = np.arange(s)
    for da, va in a.items():
        for db, vb in b.items():
            off = (da + db) % s
            term = va * vb[(jj + da) % s]
            if off in out:
                out[off] = out[off] + term
            else:
                out[off] = term.copy()
    if tol:
        out = {d: v for d, v in out.items() if np.max(np.abs(v)) > tol}
    return out


def dense_from_diags(diags, s):
    m = np.zeros((s, s), dtype=np.complex128)
    jj = np.arange(s)
    for d, v in diags.items():
        m[jj, (jj + d) % s] = v
    return m


def build_levels(n, radix, inverse):
    """Merged level transforms, returned in APPLICATION order.

    Stage i has butterfly span t = s/2^i: i = log s is the innermost
    (adjacent pairs), i = 1 the outermost (combines the two halves). The
    forward transform (SlotToCoeff direction) applies innermost first:

        z = S_1 @ S_2 @ ... @ S_{log s} @ u'      (u' = bit-reversed coeffs)

    so forward application order is i = log s .. 1, and the inverse
    (CoeffToSlot) order is i = 1 .. log s with S_i^{-1}.

    Consecutive stages in application order are merged `radix` at a time
    into level matrices via diagonal-dict products (never dense). Returns
    a list of {offset: complex [s]} dicts; apply list[0] first.
    """
    s = n // 2
    logs = s.bit_length() - 1
    if inverse:
        order = list(range(1, logs + 1))
        stage_fn = inverse_stage_diags
    else:
        order = list(range(logs, 0, -1))
        stage_fn = forward_stage_diags
    levels = []
    for k in range(0, logs, radix):
        acc = None
        for i in order[k: k + radix]:   # in application order
            d = stage_fn(n, i)
            # matrix applied later goes on the LEFT: acc_new = S @ acc
            acc = d if acc is None else diag_mul(d, acc, s, tol=1e-12)
        levels.append(acc)
    return levels


def dense_reference(n):
    """Dense A and P_brv for verification (small n only)."""
    s = n // 2
    e = five_powers(n, s)
    k = np.arange(s, dtype=np.int64)
    A = np.exp(1j * np.pi / n * ((e[:, None] * k[None, :]) % (2 * n)))
    return A, _brv_perm(s.bit_length() - 1)
