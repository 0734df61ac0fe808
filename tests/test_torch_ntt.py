"""The port's plain NTT (dacapo_tpu_torch.crypto.ntt) against the JAX
package's portable NTT and its Pallas kernel in interpret mode, bit for bit
on test_n8, test_n11 and two primes of tpu_n16 (rows repeated and out of
order). The CUDA kernel is held against the plain version on the card in
test_torch_ntt_cuda.py; here two test-only models of its split (below) are
held against the plain version, so the kernel's index and twiddle arithmetic
is checked without a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dacapo_tpu.crypto.ntt import ntt_fwd as ref_fwd, ntt_inv as ref_inv
from dacapo_tpu.crypto.pallas.ntt_kernel import PallasNTT
from dacapo_tpu.crypto.params import CKKSContext, PROFILES
from dacapo_tpu_torch.crypto.ntt import ntt_fwd, ntt_inv
from dacapo_tpu_torch.crypto.params import (CKKSConfig as TCfg, CKKSContext as TCtx,
                                            PROFILES as TPROFILES)

# profile -> plane rows (repeated and out of order)
ROWS = {"test_n8": [0, 2, 1, 2], "test_n11": [0, 2, 1, 2], "tpu_n16": [40, 3, 40]}


@pytest.fixture(scope="module", params=list(ROWS))
def case(request):
    return request.param, CKKSContext(PROFILES[request.param]), ROWS[request.param]


def _planes(ctx, rows, seed):
    rng = np.random.default_rng(seed)
    qv = np.array([ctx.primes[r] for r in rows], dtype=np.uint64)
    return (rng.integers(0, 1 << 62, (len(rows), ctx.n)) % qv[:, None]).astype(np.uint32)


def _port(ctx, x, rows, inverse):
    h = ctx.host_tables
    idx = np.asarray(rows)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    q = t(h["q"][idx][:, None])
    if inverse:
        out = ntt_inv(t(x), t(h["itw"][idx]), q, t(h["ninv"][idx][:, None]))
    else:
        out = ntt_fwd(t(x), t(h["tw"][idx]), q)
    assert out.dtype == torch.int32
    return out.numpy().view(np.uint32)


def _ref(ctx, x, rows, inverse):
    h = ctx.host_tables
    idx = np.asarray(rows)
    q = jnp.asarray(h["q"][idx][:, None])
    if inverse:
        return np.asarray(ref_inv(jnp.asarray(x), h["itw"][idx], h["itw_shoup"][idx], q,
                                  h["ninv"][idx][:, None], h["ninv_shoup"][idx][:, None]))
    return np.asarray(ref_fwd(jnp.asarray(x), h["tw"][idx], h["tw_shoup"][idx], q))


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_portable(case, inverse):
    _, ctx, rows = case
    x = _planes(ctx, rows, 7)
    np.testing.assert_array_equal(_port(ctx, x, rows, inverse), _ref(ctx, x, rows, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_pallas_interpret(case, inverse):
    _, ctx, rows = case
    x = _planes(ctx, rows, 8)
    want = np.asarray(PallasNTT(ctx, interpret=True)(jnp.asarray(x), rows, inverse=inverse))
    np.testing.assert_array_equal(_port(ctx, x, rows, inverse), want)


def test_plain_roundtrip(case):
    _, ctx, rows = case
    x = _planes(ctx, rows, 3)
    y = _port(ctx, x, rows, False)
    np.testing.assert_array_equal(_port(ctx, y, rows, True), x)


def test_tables_match_reference(case):
    name, ctx, _ = case
    tctx = TCtx(TPROFILES[name], device="cpu")
    for k, v in ctx.host_tables.items():
        np.testing.assert_array_equal(tctx.host_tables[k], v)
    np.testing.assert_array_equal(tctx.orbit_perm, ctx.orbit_perm)


# ---------------------------------------------------------------------------
# Test-only models of the CUDA kernel's split (csrc/ntt.cu). N = 2^n, forward
# stage s has distance t = 2^(n-1-s) and its butterfly at i uses
# tw[2^s + (i >> (n-s))]. Split at k, L = 2^(n-k):
#   pass A (stages s < k) on columns c: elements x[c + r*L]; stage s pairs r
#     with r + 2^(k-1-s) and uses tw[2^s + (r >> (k-s))];
#   pass B (stages s >= k) on segments g: elements x[g*L + u]; the element at
#     u uses tw[2^s + g*2^(s-k) + (u >> (n-s))].
# Forward runs A then B; the inverse runs B' then A' and multiplies by N^-1.

def _small_ctx(logn):
    """Port context with three primes at N = 2^logn (tables only matter)."""
    return TCtx(TCfg(n=1 << logn, num_q=2, alpha=1, prime_bits=30, scale_bits=25),
                device="cpu")


def _inputs(ctx, rows, seed):
    h = ctx.host_tables
    idx = np.asarray(rows)
    x = _planes(ctx, rows, seed).astype(np.int64)
    tabs = {k: h[k][idx].astype(np.int64) for k in ("tw", "itw")}
    return x, tabs, h["q"][idx].astype(np.int64), h["ninv"][idx].astype(np.int64)


def _plain(ctx, x, rows, inverse):
    return _port(ctx, x.astype(np.uint32), rows, inverse).astype(np.int64)


def _ct(u, v, w, q):
    t = v * w % q
    return (u + t) % q, (u - t) % q


def _gs(u, v, w, q):
    return (u + v) % q, (u - v) % q * w % q


def _stage_model(x, tw, q, ninv, k, inverse):
    """Pass A then B (B' then A' for the inverse), stage by stage."""
    bsz, n = x.shape
    logn = n.bit_length() - 1
    rl = 1 << (n.bit_length() - 1 - k)
    qe = q[:, None, None]
    y = x.copy().reshape(bsz, 1 << k, rl)      # [B, r or g, c or u]

    def pass_a(stages):
        r = np.arange(1 << k)
        for s in stages:
            lo = r[(r & (1 << (k - 1 - s))) == 0]
            hi = lo + (1 << (k - 1 - s))
            w = tw[:, (1 << s) + (lo >> (k - s))][:, :, None]
            bf = _gs if inverse else _ct
            y[:, lo], y[:, hi] = bf(y[:, lo], y[:, hi], w, qe)

    def pass_b(stages):
        u = np.arange(rl)
        g = np.arange(1 << k)[:, None]
        for s in stages:
            t = 1 << (logn - 1 - s)
            lo = u[(u & t) == 0]
            w = tw[:, (1 << s) + g * (1 << (s - k)) + (lo >> (logn - s))]
            bf = _gs if inverse else _ct
            y[:, :, lo], y[:, :, lo + t] = bf(y[:, :, lo], y[:, :, lo + t], w, qe)

    if inverse:
        pass_b(range(logn - 1, k - 1, -1))
        pass_a(range(k - 1, -1, -1))
        return y.reshape(bsz, n) * ninv[:, None] % q[:, None]
    pass_a(range(k))
    pass_b(range(k, logn))
    return y.reshape(bsz, n)


def _pass_threads(logn, pass_b):
    """Every thread of one plane's pass as ntt_pass computes it: the
    sequence length, the thread's group, the global offset and stride of its
    sequence, its shared-memory offset and stride, its tile, and its root."""
    k = logn // 2
    logl = logn - k
    rl, rr = 1 << logl, 1 << k
    len_log = logl if pass_b else k
    seqs = min(rr, max(1, 1024 >> logl)) if pass_b else min(rl, max(8, 1024 >> k))
    tiles = (rr if pass_b else rl) // seqs
    grps = (1 << len_log) // 4
    tile, tid = (a.ravel() for a in np.meshgrid(np.arange(tiles), np.arange(grps * seqs),
                                                 indexing="ij"))
    seq = tid // grps if pass_b else tid % seqs
    grp = tid % grps if pass_b else tid // seqs
    col = tile * seqs + seq
    if pass_b:
        return len_log, grp, col * rl, 1, seq * (1 << len_log), 1, tile, rr + col
    return len_log, grp, col, rl, seq, seqs, tile, np.ones_like(col)


def _kernel_model(x, tw, q, ninv, inverse):
    """The kernel's steps at k = n // 2, vectorised over its threads: radix-4
    steps (radix 2 for an odd last stage), the same positions, twiddle
    indices and pass order, with shared memory replaced by the plane. Also
    checks that every step touches each element once, that the shared-memory
    addresses of a tile are a permutation, and that the contiguous end of
    pass B is 16-byte aligned."""
    bsz, n = x.shape
    logn = n.bit_length() - 1
    y = x.copy()
    for pass_b in ((True, False) if inverse else (False, True)):
        len_log, grp, gbase, gstride, sbase, sstride, tile, root = _pass_threads(logn, pass_b)
        steps = (len_log + 1) // 2
        for st in (range(steps - 1, -1, -1) if inverse else range(steps)):
            s = 2 * st
            r4 = s + 1 < len_log
            lq = len_log - 2 - s if r4 else 0
            jj = grp >> lq
            b = (jj << (lq + 2)) | (grp & ((1 << lq) - 1))
            pos = b[:, None] + (np.arange(4) << lq)
            gi = gbase[:, None] + pos * gstride
            assert np.array_equal(np.sort(gi.ravel()), np.arange(n))
            si = sbase[:, None] + pos * sstride
            for t in np.unique(tile):
                sel = si[tile == t].ravel()
                assert np.array_equal(np.sort(sel), np.arange(sel.size))
            if pass_b and lq == 0:
                assert (gi[:, 0] % 4 == 0).all() and (np.diff(gi, axis=1) == 1).all()
                assert (si[:, 0] % 4 == 0).all() and (np.diff(si, axis=1) == 1).all()
            a = [y[:, gi[:, e]] for e in range(4)]
            i2 = (root << (s + 1 if r4 else s)) + 2 * jj
            w2a, w2b = tw[:, i2], tw[:, i2 + 1]
            w1 = tw[:, (root << s) + jj]
            qe = q[:, None]
            if not inverse:
                if r4:
                    a[0], a[2] = _ct(a[0], a[2], w1, qe)
                    a[1], a[3] = _ct(a[1], a[3], w1, qe)
                a[0], a[1] = _ct(a[0], a[1], w2a, qe)
                a[2], a[3] = _ct(a[2], a[3], w2b, qe)
            else:
                a[0], a[1] = _gs(a[0], a[1], w2a, qe)
                a[2], a[3] = _gs(a[2], a[3], w2b, qe)
                if r4:
                    a[0], a[2] = _gs(a[0], a[2], w1, qe)
                    a[1], a[3] = _gs(a[1], a[3], w1, qe)
            for e in range(4):
                y[:, gi[:, e]] = a[e]
    return y * ninv[:, None] % q[:, None] if inverse else y


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("logn", [8, 11, 15, 16])
def test_two_pass_stage_model_every_k(logn, inverse):
    ctx = _small_ctx(logn)
    rows = [2, 0]
    x, tabs, q, ninv = _inputs(ctx, rows, logn)
    want = _plain(ctx, x, rows, inverse)
    tw = tabs["itw" if inverse else "tw"]
    for k in range(1, logn):
        np.testing.assert_array_equal(_stage_model(x, tw, q, ninv, k, inverse), want,
                                      err_msg=f"k={k}")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("logn", range(8, 17))
def test_kernel_model_matches_plain(logn, inverse):
    ctx = _small_ctx(logn)
    rows = [1, 2, 1]
    x, tabs, q, ninv = _inputs(ctx, rows, 100 + logn)
    got = _kernel_model(x, tabs["itw" if inverse else "tw"], q, ninv, inverse)
    np.testing.assert_array_equal(got, _plain(ctx, x, rows, inverse))


def test_kernel_model_roundtrip():
    ctx = _small_ctx(15)
    rows = [0, 1]
    x, tabs, q, ninv = _inputs(ctx, rows, 5)
    y = _kernel_model(x, tabs["tw"], q, ninv, False)
    np.testing.assert_array_equal(_kernel_model(y, tabs["itw"], q, ninv, True), x)


def test_umin_reductions():
    """The kernel's reductions (ntt.cu add_mod, sub_mod, mul_shoup's last
    step) in uint32: umin(v, v - q) for v in [0, 2q), umin(d, d + q) for a
    wrapped difference, at the primes of test_n8 and the largest and
    smallest of tpu_n15 (a special prime just below 2^31)."""
    rng = np.random.default_rng(11)
    primes = TCtx(TPROFILES["test_n8"], device="cpu").primes + [2147352577, 976355329]
    for q in map(np.uint32, primes):
        a = np.r_[0, q - 1, q - 1, rng.integers(0, q, 1 << 16)].astype(np.uint32)
        b = np.r_[q - 1, 0, q - 1, rng.integers(0, q, 1 << 16)].astype(np.uint32)
        v = np.r_[0, q - 1, q, 2 * q - 1, rng.integers(0, 2 * q, 1 << 16)].astype(np.uint32)
        with np.errstate(over="ignore"):
            s, d = a + b, a - b
            np.testing.assert_array_equal(np.minimum(s, s - q), (a.astype(np.int64) + b) % q)
            np.testing.assert_array_equal(np.minimum(d, d + q), (a.astype(np.int64) - b) % q)
            np.testing.assert_array_equal(np.minimum(v, v - q), v.astype(np.int64) % q)


class _TraceRow:
    """One key_averages() row of a torch.profiler trace."""

    def __init__(self, key, count, device_type="DeviceType.CUDA"):
        self.key, self.count, self.device_type = key, count, device_type


def test_launches_in_profile():
    """NTT calls counted from a trace's kernel names (how the kernels that
    run inside CUDA graphs are counted): one pass-A kernel per call, pass B
    equal, host rows ignored, a trace with unequal passes refused."""
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import TraceLossError, launches_in_profile
    name = "void (anonymous namespace)::ntt_pass<{}, {}, {}>(unsigned int const*, unsigned int*)"
    rows = [_TraceRow(name.format(15, "false", "false"), 7),
            _TraceRow(name.format(15, "true", "false"), 7),
            _TraceRow(name.format(11, "true", "true"), 3),
            _TraceRow(name.format(11, "false", "true"), 3),
            _TraceRow(name.format(16, "false", "true"), 2),
            _TraceRow(name.format(16, "true", "true"), 2),
            _TraceRow("ntt_pass<15, false, false> (host)", 9, "DeviceType.CPU"),
            _TraceRow("cudaGraphLaunch", 4, "DeviceType.CPU")]
    assert launches_in_profile(rows) == {"ntt_fwd_cuda": 7, "ntt_inv_cuda": 5}
    assert launches_in_profile([]) == {"ntt_fwd_cuda": 0, "ntt_inv_cuda": 0}
    with pytest.raises(TraceLossError, match="pass-A"):
        launches_in_profile(rows[:1])


def test_passes_in_profile():
    """Each mode's pass-A and pass-B kernels as a trace holds them, unequal
    ones too (a trace that lost a record: what chip_smoke.py reports as a
    lower bound once every attempt at a trace lost records)."""
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import passes_in_profile
    name = "void (anonymous namespace)::ntt_pass<{}, {}, {}>(unsigned int const*, unsigned int*)"
    rows = [_TraceRow(name.format(14, "false", "false"), 593),
            _TraceRow(name.format(14, "true", "false"), 594),
            _TraceRow(name.format(14, "true", "true"), 5),
            _TraceRow(name.format(15, "true", "true"), 1),
            _TraceRow(name.format(14, "false", "true"), 6),
            _TraceRow("ntt_pass<14, false, false> (host)", 9, "DeviceType.CPU")]
    assert passes_in_profile(rows) == {"ntt_fwd_cuda": (593, 594), "ntt_inv_cuda": (6, 6)}
    assert passes_in_profile([]) == {"ntt_fwd_cuda": (0, 0), "ntt_inv_cuda": (0, 0)}
