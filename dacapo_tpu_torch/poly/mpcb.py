"""MPCB channel packing for HE CNN inference (copy of dacapo_tpu/poly/mpcb.py).

Reimplementation (numpy, torch-free core) of the reference HE-CNN ops
library python/poly/poly/MPCB.py — same packing layout and closure API, so
models written against the reference port directly.

Slot layout: a CNN tensor [c, h, w] packs into slots ordered
(t, h, s1, w, s2) where the channel c = t*ki*ki + s1*ki + s2 is multiplexed
into a ki x ki sub-block interleaved with the spatial dims
(MPCB.py:86-106 MultParPack). Tensors larger than one ciphertext split into
`ni` ciphertexts; small ones are replicated `pi` times. Convolution =
rotations of the packed input x plaintext filter masks + SumSlots
rotate-reduce; stride/downsample = masked re-packing (DownSelecting).

All mask/weight construction is host-side numpy f64; the ciphertext ops go
through the tracer's operator overloading (Expr), so `roll(A, i)` is
`A.rotate(-i)` on ciphertexts and np.roll on plain masks.
"""

import numpy as np
import einops

from ..ir import trace as hc


Empty = hc.Empty


def cint(x):
    return int(np.ceil(x))


def fint(x):
    return int(np.floor(x))


def roll(a, i):
    if isinstance(a, hc.Expr):
        return a.rotate(-i)
    return np.roll(np.asarray(a), i)


def _np(t):
    """torch tensor / array-like -> numpy float64."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def _pad_axis(a, axis, count):
    if count <= 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, count)
    return np.pad(a, widths)


# The module-level maximum hook: HE_Max swaps this for the polynomial
# max (Func.py:31-45 monkeypatching pattern).
def _np_maximum(a, b):
    return np.maximum(a, b)


maximum = _np_maximum


# --------------------------------------------------------------------------
# BSGS Chebyshev polynomial evaluation (GenPoly, MPCB.py:24-80)
# --------------------------------------------------------------------------

def gen_poly_from_cheb(coef, length, scale=1.0):
    """Build an HE evaluator for an ODD Chebyshev series `coef`.

    Baby-step/giant-step over Chebyshev polynomials: babies T_1,T_3,..,T_{L-1}
    (L = `length`), giants T_L, T_2L, ... built by T_2k = 2 T_k^2 - 1; the
    series is recursively split by quotient/remainder against giant T_deg.
    Same evaluation structure as the reference's tree files, but the division
    tree is derived here instead of read from data.
    """
    cheb = np.polynomial.Chebyshev(np.asarray(coef, dtype=np.float64) / scale)

    # recursive q/r decomposition: leaves have degree < length
    nodes = []   # (node_id, divisor_deg or 0, payload/children)

    def split(poly, node_id):
        deg = poly.degree()
        if deg < length:
            nodes.append((node_id, 0, poly, None, None))
            return
        d = 1 << max(int(np.ceil(np.log2(max(deg + 1, 2)) - 1)), 0)
        d = max(d, length)
        td = np.polynomial.Chebyshev([0] * d + [1])
        q, r = divmod(poly, td)
        qid, rid = len(nodes) + 1, None
        nodes.append((node_id, d, None, None, None))  # placeholder
        idx = len(nodes) - 1
        split(q, ("q", node_id))
        split(r, ("r", node_id))
        nodes[idx] = (node_id, d, None, ("q", node_id), ("r", node_id))

    split(cheb, "root")
    node_map = {n[0]: n for n in nodes}

    def evaluate(x):
        giants = {1: x}

        def giant(d):
            if d not in giants:
                h = giant(d // 2)
                giants[d] = 2 * h * h + -1.0
            return giants[d]

        n_baby = fint(np.log2(length))
        for i in range(1, n_baby):
            giant(1 << i)
        babies = [x]                       # T_1, T_3, ..., odd degrees
        for i in range(1, n_baby):
            g = giants[1 << i]
            grown = [2 * b * g for b in babies]
            babies = babies + [nb - ob for nb, ob in zip(grown, reversed(babies))]

        memo = {}

        def run(nid):
            if nid in memo:
                return memo[nid]
            _, d, leaf, qn, rn = node_map[nid]
            if d == 0:
                acc = 0
                for k in range(length // 2):
                    deg = 2 * k + 1
                    if len(leaf.coef) > deg and leaf.coef[deg] != 0.0:
                        acc = acc + leaf.coef[deg] * babies[k]
                memo[nid] = acc
                return acc
            out = run(qn) * giant(d) + run(rn)
            memo[nid] = out
            return out

        return run("root")

    return evaluate


def GenPoly(tree_lines=None, coeff_lines=None, length=16, scale=1.0):
    """Reference-signature wrapper: accepts the (treeStr, coeffStr) file
    contents but only uses the coefficients — the division tree is rebuilt."""
    coef = [float(tok.strip()) for tok in coeff_lines]
    return gen_poly_from_cheb(coef, length, scale)


# --------------------------------------------------------------------------
# Per-layer-shape closures (shapeClosure, MPCB.py:82-557)
# --------------------------------------------------------------------------

def shapeClosure(nt, bb, fh, fw, s, hi, ho, wi, wo, ni, no, ci, co,
                 ki, ko, ti, to, pi, po, q):
    """Returns the dict of packing/conv/pool closures for one layer shape."""

    kk = nt // (hi * ki * wi * ki)

    # Multiplex-units (ki*i2+i1 loop index) per input/output ciphertext:
    # tiles-per-ct * ki. The reference divides by nt//(hi*wi) or
    # cint(ci/ni/ki) here, which disagree (and are wrong) for uneven
    # multi-ciphertext splits; this form is exact for all of them.
    _upc_in = max(1, nt // (ki * hi * wi))
    # Output side: channels per output ct = (nt/(ko*ko*ho*wo)) * ko*ko, and
    # each loop unit spans ki channels, so units per output ct is
    # nt/(ki*ho*wo) — the loop index stays in *input* multiplex units.
    _upc_out = max(1, nt // (ki * ho * wo))

    # ---- plaintext mask builders ------------------------------------
    def _border_mask(value_in=1.0, value_out=0.0):
        """[fh*fw, nt] validity masks for each filter tap (spatial borders)."""
        m = np.full((hi, wi), value_in)
        m = np.pad(m, (((fh - 1) // 2,) * 2, ((fw - 1) // 2,) * 2),
                   constant_values=value_out)
        taps = np.stack([m[i:i + hi, j:j + wi]
                         for i in range(fh) for j in range(fw)])
        return einops.repeat(
            taps, "(fh fw) h w -> fh fw (kk h s1 w s2)",
            fh=fh, fw=fw, kk=kk, s1=ki, s2=ki)

    def MultParPack(a):
        a = _np(a) / bb
        a = a[0] if a.ndim == 4 else a
        a = _pad_axis(a, 0, ki * ki * ti - ci)
        a = einops.rearrange(a, "(ti s1 s2) h w -> (ti h s1 w s2)", s1=ki, s2=ki)
        a = _pad_axis(a, 0, ni * nt // pi - a.shape[0])
        return einops.repeat(
            einops.rearrange(a, "(ni x) -> ni x", ni=ni), "ni x -> ni (pi x)", pi=pi)

    def OutPack(a):
        a = _np(a) / bb
        a = a[0] if a.ndim == 4 else a
        a = _pad_axis(a, 0, ko * ko * to - co)
        a = einops.rearrange(a, "(to s1 s2) h w -> (to h s1 w s2)", s1=ko, s2=ko)
        a = _pad_axis(a, 0, no * nt // po - a.shape[0])
        return einops.rearrange(
            einops.repeat(a, "x -> (po x)", po=po), "(no x) -> no x", no=no)

    def ParMultWgt(u):
        """Conv weights -> [ni, q, fh, fw, nt] plaintext masks
        (MPCB.py:108-124 layout)."""
        u = _np(u)
        u = _pad_axis(_pad_axis(u, 1, ki * ki * ti - ci), 0, q * pi - co)
        u = einops.repeat(
            u, "(q pi) (ti s1 s2) fh fw -> (fh fw q pi) (ti h s1 w s2)",
            q=q, pi=pi, s1=ki, s2=ki, h=hi, w=wi)
        u = _pad_axis(u, 1, ni * nt // pi - u.shape[1])
        u = einops.rearrange(
            u, "(fh fw q pi) (ni x) -> ni q fh fw (pi x)",
            q=q, pi=pi, fh=fh, fw=fw, ni=ni)
        return u * _border_mask()[None, None]

    def DwMultWgt(u):
        u = _np(u)
        u = _pad_axis(u, 0, ki * ki * ti - ci)
        u = einops.repeat(
            u, "(ti s1 s2) i fh fw -> fh (fw i) (ti h s1 w s2)",
            s1=ki, s2=ki, h=hi, w=wi)
        u = _pad_axis(u, 2, ni * nt // pi - u.shape[2])
        u = einops.repeat(u, "fh fw (ni x) -> ni fh fw (pi x)", pi=pi, ni=ni)
        return u * _border_mask()

    def SumSlots(a, m, p):
        """log-depth strided rotate-reduce: sum of m slots at stride p."""
        levels = [a]
        for j in range(fint(np.log2(m))):
            levels.append(levels[j] + roll(levels[j], -(1 << j) * p))
        out = levels[fint(np.log2(m))]
        for j in range(fint(np.log2(m))):
            if (m >> j) % 2 == 1:
                out = out + roll(levels[j], -(m >> (j + 1)) * (1 << (j + 1)) * p)
        return out

    def Selecting():
        sel = np.eye(co, ko * ko * to)
        sel = einops.repeat(
            sel, "co (to s1 s2) -> co (to ho s1 wo s2)",
            s1=ko, s2=ko, to=to, ho=ho, wo=wo)
        sel = _pad_axis(sel, 1, no * nt - sel.shape[1])
        return einops.rearrange(sel, "co (no x) -> no co x", no=no)

    def ParBNConst(c):
        c = _pad_axis(_np(c), 0, ko * ko * to - co)
        c = einops.repeat(c, "(to s1 s2) -> (to ho s1 wo s2)",
                          to=to, s1=ko, s2=ko, ho=ho, wo=wo)
        c = _pad_axis(c, 0, no * nt // po - c.shape[0])
        return einops.repeat(
            einops.rearrange(c, "(no x) -> no x", no=no), "no x -> no (po x)", po=po)

    def ParInBNConst(c):
        c = _pad_axis(_np(c), 0, ki * ki * ti - ci)
        c = einops.repeat(c, "(ti s1 s2) -> (ti hi s1 wi s2)",
                          ti=ti, s1=ki, s2=ki, hi=hi, wi=wi)
        c = _pad_axis(c, 0, ni * nt // pi - c.shape[0])
        return einops.repeat(
            einops.rearrange(c, "(ni x) -> ni x", ni=ni), "ni x -> ni (pi x)", pi=pi)

    def DownSelecting():
        sel = np.eye(ki * ti)
        sel = einops.repeat(
            sel, "(k1 t1) (k2 t2) -> k1 t1 t2 hi s1 k2 wi s2 k",
            k1=ki, t1=ti, k2=ki, t2=ti, hi=hi // s, wi=wi // s, k=ki, s1=1, s2=1)
        sel = np.pad(sel, [(0, 0)] * 4 + [(0, s - 1), (0, 0), (0, 0), (0, s - 1), (0, 0)])
        sel = einops.rearrange(
            sel, "k1 t1 t2 hi s1 k2 wi s2 k -> k1 t1 t2 (hi s1) k2 (wi s2) k")
        sel = np.pad(sel, [(0, 0)] * 3 + [(0, hi % s), (0, 0), (0, wi % s), (0, 0)])
        sel = einops.rearrange(sel, "k1 t1 t2 hi k2 wi k -> k1 t1 (t2 hi k2 wi k)")
        sel = _pad_axis(sel, 2, ni * nt - sel.shape[2])
        return einops.rearrange(sel, "k t (ni x) -> ni k t x", ni=ni)

    def PoolSelecting():
        sel = np.eye(ki * ti) / (hi * wi)
        sel = einops.repeat(sel, "s1 s2 -> s1 (s2 k)", k=ki)
        sel = _pad_axis(sel, 1, ni * nt - sel.shape[1])
        return einops.rearrange(sel, "s1 (ni x) -> ni s1 x", ni=ni)

    # ------------------------------------------------------- conv kernels
    def _tap_rotations(a):
        """All fh*fw tap rotations of each input ciphertext."""
        taps = np.empty((ni, fh, fw), dtype=object)
        for ii in range(ni):
            for i1 in range(fh):
                for i2 in range(fw):
                    off = ki * ki * wi * (i1 - (fh - 1) // 2) + ki * (i2 - (fw - 1) // 2)
                    taps[ii, i1, i2] = roll(a[ii], -off)
        return taps

    def _repack_strided(b_of, sel_scale=None, extra=None):
        """Shared DownSelecting-based output re-packing used by Downsamp /
        pools / dwconv: gathers (i1, i2) multiplexed channels into the
        stride-adjusted output layout."""
        sel = DownSelecting()
        c = np.full((no,), Empty(), dtype=object)
        for i1 in range(ki):
            for i2 in range(ti):
                i3 = ((ki * i2 + i1) % (s * ko)) // s
                i4 = (ki * i2 + i1) % s
                i5 = (ki * i2 + i1) // (s * ko)
                i7 = (ki * i2 + i1) // _upc_in
                i8 = (ki * i2 + i1) // _upc_out
                # Mask BEFORE rolling: the DownSelecting mask addresses the
                # pre-roll (input-layout) slots (reference MaxPool/DwConvBN/
                # Downsamp all do roll(B * S, off)). `extra` is also in input
                # layout, so it is indexed by the input ct i7 (the reference
                # dwconv indexes P[i8], which is wrong when ni != no).
                mask = sel[i7, i1, i2, :]
                if sel_scale is not None:
                    mask = mask * sel_scale
                if extra is not None:
                    mask = mask * extra[i7]
                off = (ki * ki * hi * wi * (i2 - i5) + ki * wi * (i1 - i3)
                       - ki * i4 + (i8 - i7) * nt)
                c[i8] = c[i8] + roll(b_of(i7) * mask, -off)
        return c

    def _duplicate(c, count=None):
        for ii in range(no if count is None else count):
            for j in range(fint(np.log2(po))):
                c[ii] = c[ii] + roll(c[ii], (1 << j) * (nt // po))
        return c

    def MultParConvBN(a, u, g, h):
        return _conv_core(a, u, bn_g=g, bn_h=h)

    def MultParConv(a, u, bias):
        return _conv_core(a, u, bn_g=None, bn_h=bias)

    def _conv_core(a, u, bn_g, bn_h):
        """MPCB.py:471-557: taps x masks, SumSlots reduction over the ki/ti
        multiplex, then per-output-channel rotation into the output layout."""
        masks = ParMultWgt(u)
        sel = Selecting()
        p = ParBNConst(bn_g) if bn_g is not None else None
        taps = _tap_rotations(a)
        d = np.full((no,), Empty(), dtype=object)
        for i3 in range(q):
            b = Empty()
            for ii in range(ni):
                for i1 in range(fh):
                    for i2 in range(fw):
                        b = b + taps[ii, i1, i2] * masks[ii, i3, i1, i2, :]
            csum = SumSlots(b, ki, 1)
            csum = SumSlots(csum, ki, ki * wi)
            # When ni > 1, the per-ct partial sums already overlay tile j of
            # ct k with tile j + nt/plane of ct k+1 on the same slots, so the
            # tile reduction only spans the planes of ONE ciphertext. The
            # reference sums all `ti` tiles here (MPCB.py:499), which wraps
            # past nt and double-counts whenever ti*ki*ki*hi*wi > nt — its
            # multi-ciphertext convs are numerically wrong; we fix it.
            csum = SumSlots(csum, min(ti, nt // (ki * ki * hi * wi)),
                            ki * ki * hi * wi)
            for i4 in range(min(pi, co - pi * i3)):
                i = pi * i3 + i4
                i6 = i % (ko * ko * nt // (hi * wi * ki * ki))
                i8 = i // (ko * ko * nt // (hi * wi * ki * ki))
                off = ((i6 // (ko * ko)) * ko * ko * ho * wo
                       - (nt // pi) * (i6 % pi)
                       + ((i6 % (ko * ko)) // ko) * ko * wo + (i6 % ko)) - i8 * nt
                m = sel[i8, i] * p[i8] if p is not None else sel[i8, i]
                d[i8] = d[i8] + roll(csum, off) * m
        d = _duplicate(d)
        for ii in range(no):
            d[ii] = d[ii] + ParBNConst(bn_h)[ii, :] / bb
        return d

    def MultParBN(a, g, h):
        d = np.full((no,), Empty(), dtype=object)
        for ii in range(no):
            d[ii] = a[ii] * ParBNConst(g)[ii, :] + ParBNConst(h)[ii, :] / bb
        return d

    def DwConvBN(a, u, g, h):
        masks = DwMultWgt(u)
        p_in = ParInBNConst(g)
        taps = _tap_rotations(a)
        # Depthwise has no cross-channel sum, so collapsing the per-ct
        # masked taps into one vector (reference MPCB.py:440-444) corrupts
        # colliding tiles when ni > 1 — keep one partial sum per input ct.
        # NOTE: reference indexes i7/i8 with ceil(ci/ni) here (MPCB.py:448-455)
        b = np.full((ni,), Empty(), dtype=object)
        for ii in range(ni):
            for i1 in range(fh):
                for i2 in range(fw):
                    b[ii] = b[ii] + taps[ii, i1, i2] * masks[ii, i1, i2, :]
        c = _repack_strided(lambda i7: b[i7], extra=p_in)
        c = _duplicate(c)
        for ii in range(no):
            c[ii] = c[ii] + ParBNConst(h)[ii, :] / bb
        return c

    def Downsamp(a):
        sel = DownSelecting()
        c = np.full((no,), Empty(), dtype=object)
        for i1 in range(ki):
            for i2 in range(ti):
                i3 = ((ki * i2 + i1) % (2 * ko)) // 2
                i4 = (ki * i2 + i1) % 2
                i5 = (ki * i2 + i1) // (2 * ko)
                i7 = (ki * i2 + i1) // _upc_in
                i8 = (ki * i2 + i1) // _upc_out
                off = (ki * ki * hi * wi * (i2 - i5) + ki * wi * (i1 - i3)
                       - ki * i4 + (i8 - i7) * nt)
                c[i8] = c[i8] + roll(a[i7] * sel[i7, i1, i2, :], -off)
        for i in range(no):
            c[i] = roll(c[i], ko * ko * ho * wo * ti // 8)  # centering
            for j in range(fint(np.log2(po))):
                c[i] = c[i] + roll(c[i], (1 << j) * (nt // po))
        return c

    def _spatial_reduce(a, red=None):
        """Full-extent rotate-reduce over w then h (pool building block)."""
        red = red or (lambda x, y: x + y)
        b = np.full((ni,), Empty(), dtype=object)
        for ii in range(ni):
            b[ii] = a[ii]
            for j in range(fint(np.log2(wi))):
                b[ii] = red(b[ii], roll(b[ii], -(1 << j) * ki))
            for j in range(fint(np.log2(hi))):
                b[ii] = red(b[ii], roll(b[ii], -(1 << j) * ki * ki * wi))
        return b

    def AvgPool(a):
        b = _spatial_reduce(a)
        sel = PoolSelecting()
        c = np.full((no,), Empty(), dtype=object)
        for i1 in range(ki):
            for i2 in range(ti):
                i7 = (ki * i2 + i1) // _upc_in
                i8 = (ki * i2 + i1) // _upc_out
                off = (ki * ki * hi * wi * i2 + ki * wi * i1
                       - ki * (ki * i2 + i1) + (i8 - i7) * nt)
                c[i8] = c[i8] + roll(b[i7], -off) * sel[i7, ki * i2 + i1, :]
        return c

    def AvgMidPool(a):
        b = np.full((ni,), Empty(), dtype=object)
        if fw == 2:
            for ii in range(ni):
                b[ii] = a[ii]
                for j in range(fint(np.log2(fw))):
                    b[ii] = b[ii] + roll(b[ii], -(1 << j) * ki)
                for j in range(fint(np.log2(fh))):
                    b[ii] = b[ii] + roll(b[ii], -(1 << j) * ki * ki * wi)
        else:
            m = _border_mask()
            for ii in range(ni):
                for i1 in range(fh):
                    for i2 in range(fw):
                        off = (ki * ki * wi * (i1 - (fh - 1) // 2)
                               + ki * (i2 - (fw - 1) // 2))
                        b[ii] = b[ii] + roll(a[ii], -off) * m[i1, i2]
        sel = DownSelecting()
        c = np.full((no,), Empty(), dtype=object)
        for i1 in range(ki):
            for i2 in range(ti):
                i3 = ((ki * i2 + i1) % (2 * ko)) // 2
                i4 = (ki * i2 + i1) % 2
                i5 = (ki * i2 + i1) // (2 * ko)
                i7 = (ki * i2 + i1) // _upc_in
                i8 = (ki * i2 + i1) // _upc_out
                off = (ki * ki * hi * wi * (i2 - i5) + ki * wi * (i1 - i3)
                       - ki * i4 + (i8 - i7) * nt)
                c[i8] = c[i8] + roll(b[i7] * (sel[i7, i1, i2, :] / (fh * fw)), -off)
        # duplicate every output ct (reference MPCB.py only duplicates c[0])
        for i in range(no):
            for j in range(fint(np.log2(po))):
                c[i] = c[i] + roll(c[i], (1 << j) * (nt // po))
        return c

    def MaxPool(a):
        b = _spatial_reduce_window(a)
        c = _repack_strided(lambda i7: b[i7])
        return _duplicate(c)

    def _spatial_reduce_window(a):
        b = np.full((ni,), Empty(), dtype=object)
        for ii in range(ni):
            b[ii] = a[ii]
            for j in range(fint(np.log2(fw))):
                b[ii] = maximum(b[ii], roll(b[ii], -(1 << j) * ki))
            for j in range(fint(np.log2(fh))):
                b[ii] = maximum(b[ii], roll(b[ii], -(1 << j) * ki * ki * wi))
        return b

    def MaxPoolPad(a):
        m = _border_mask()
        dmask = _border_mask(value_in=0.0, value_out=-0.5).reshape(fh, fw, nt)
        b = np.full((ni,), Empty(), dtype=object)
        for ii in range(ni):
            b[ii] = a[ii]
            for j in range(fw):
                b[ii] = maximum(
                    b[ii], roll(b[ii], -(j - (fw - 1) // 2) * ki) * m[1, j] + dmask[1, j])
            for j in range(fh):
                b[ii] = maximum(
                    b[ii],
                    roll(b[ii], -(j - (fh - 1) // 2) * ki * ki * wi) * m[j, 1] + dmask[j, 1])
        c = _repack_strided(lambda i7: b[i7])
        return _duplicate(c)

    def ConcatSelecting():
        tt = min(co * wo * ho, nt)
        rem = (ci * wi * hi) % tt
        # `rem` is the occupied slot count of the first stream's last ct, so
        # the boundary ct keeps slots [0, rem) from it and fills [rem, tt)
        # from the (right-rolled) second stream. The reference builds the
        # masks the other way round (ones(tt-rem), MPCB.py:298) which
        # scrambles any concat whose streams don't end on a ct boundary
        # (SqueezeNet fire6/7 at nt=2^14); we fix the orientation.
        front = np.concatenate([np.ones(rem), np.zeros(tt - rem)])
        back = 1.0 - front
        front = _pad_axis(front, 0, nt // po - tt)
        back = _pad_axis(back, 0, nt // po - tt)
        return (einops.repeat(front, "x -> (po x)", po=po),
                einops.repeat(back, "x -> (po x)", po=po))

    def Concat(a, b):
        if (ci * wi * hi) % nt == 0:
            return np.concatenate((a, b))
        front, back = ConcatSelecting()
        tt = min(co * wo * ho, nt)
        shifted = np.full((ni,), Empty(), dtype=object)
        for i in range(ni):
            shifted[i] = roll(b[i], (ci * wi * hi) % tt)
        d = np.full((no,), Empty(), dtype=object)
        for i in range(ni - 1):
            d[i] = a[i]
        first = [a[ni - 1]] + [shifted[i] for i in range(ni)]
        second = [shifted[i] for i in range(ni)]
        for i in range(ni):
            d[ni - 1 + i] = first[i] * front + second[i] * back
        if ni != no:
            d[no - 1] = first[ni]
        return d

    return {
        "MPP": MultParPack, "OP": OutPack, "CC": Concat, "MPD": MaxPoolPad,
        "MPCB": MultParConvBN, "MPC": MultParConv, "BN": MultParBN,
        "DW": DwConvBN, "DS": Downsamp, "AP": AvgPool, "MP": MaxPool,
        "MA": AvgMidPool, "SumSlots": SumSlots,
    }


# --------------------------------------------------------------------------
# Dense layers and shape inference (MPCB.py:561-743)
# --------------------------------------------------------------------------

def abstractBN(bn):
    """Fold BatchNorm into (G, H): y = G*x + H."""
    g = _np(bn.weight) / np.sqrt(_np(bn.running_var) + bn.eps)
    h = _np(bn.bias) - g * _np(bn.running_mean)
    return g, h


def BN(a, g, h, nt):
    g = _pad_axis(_np(g), 0, nt - len(_np(g)))
    h = _pad_axis(_np(h), 0, nt - len(_np(h)))
    out = np.full((1,), Empty(), dtype=object)
    out[0] = a[0] * g + h
    return out


def Linear(a, u, bias, nt):
    """Diagonal-packed dense layer (MPCB.py:571-598)."""
    u = _np(u)
    bias = _np(bias)
    outdim, indim = u.shape
    sel = _pad_axis(np.ones(indim), 0, nt - indim)
    r = np.full((1,), Empty(), dtype=object)
    x = sel * a[0]
    x = x + roll(x, indim)
    it = (indim + outdim - 1) // outdim
    diag = np.stack([np.roll(u[i, :], -i) for i in range(outdim)])
    diag = _pad_axis(diag, 1, it * outdim - indim)
    diag = einops.rearrange(diag, "i1 (i2 i3) -> i3 (i2 i1)", i2=it, i3=outdim)
    diag = _pad_axis(diag, 1, nt - diag.shape[1])
    for i in range(outdim):
        r[0] = r[0] + roll(x, -i) * diag[i, :]
    for j in range(cint(np.log2(it))):
        r[0] = r[0] + roll(r[0], -(1 << j) * outdim)
    r[0] = r[0] + _pad_axis(bias, 0, nt - len(bias))
    return r


def Reshape(w, shape):
    return einops.rearrange(
        _np(w), "o (to k1 k2 ho wo) -> o (to ho k1 wo k2)",
        to=shape["to"], k1=shape["ko"], k2=shape["ko"],
        wo=shape["wo"], ho=shape["ho"])


def InferShapes(sh):
    sh["ho"] = sh["hi"] // sh["s"]
    sh["wo"] = sh["wi"] // sh["s"]
    sh["ko"] = sh["s"] * sh["ki"]
    sh["ti"] = cint(sh["ci"] / (sh["ki"] * sh["ki"]))
    sh["to"] = cint(sh["co"] / (sh["ko"] * sh["ko"]))
    in_sz = sh["ki"] * sh["ki"] * sh["hi"] * sh["wi"] * sh["ti"]
    out_sz = sh["ko"] * sh["ko"] * sh["ho"] * sh["wo"] * sh["to"]
    sh["ni"] = cint(in_sz / sh["nt"])
    sh["no"] = cint(out_sz / sh["nt"])
    sh["pi"] = max(1 << fint(np.log2(sh["nt"] / in_sz)), 1) if in_sz <= sh["nt"] else 1
    sh["po"] = max(1 << fint(np.log2(sh["nt"] / out_sz)), 1) if out_sz <= sh["nt"] else 1
    sh["q"] = cint(sh["co"] / sh["pi"])
    return sh


def _cascade(sh, fh, fw, s, ci, co):
    sh = sh.copy()
    sh.update(fh=fh, fw=fw, s=s, ci=ci, co=co,
              hi=sh["ho"], wi=sh["wo"], ki=sh["ko"])
    return InferShapes(sh)


def CascadeConv(sh, conv):
    return _cascade(sh, conv.kernel_size[1], conv.kernel_size[0],
                    conv.stride[0], conv.in_channels, conv.out_channels)


def CascadeMax(sh, mx):
    k = mx.kernel_size if isinstance(mx.kernel_size, int) else mx.kernel_size[0]
    s = mx.stride if isinstance(mx.stride, int) else mx.stride[0]
    return _cascade(sh, k, k, s, sh["co"], sh["co"])


def CascadeDS(sh):
    return _cascade(sh, 1, 1, 2, sh["co"], sh["co"] * 2)


def CascadePool(sh):
    return _cascade(sh, 1, 1, 1, sh["co"], sh["co"])


def CascadeConcat(sh1, sh2):
    sh = sh1.copy()
    if sh1["co"] != sh2["co"] or sh1["co"] % (sh["ko"] * sh["ko"]) != 0:
        raise ValueError("concat does not support this shape")
    return _cascade(sh, 1, 1, 1, sh1["co"], sh1["co"] * 2)


def makeClose(sh):
    """Build closures from a shapes dict (the usual call pattern)."""
    return shapeClosure(**{k: sh[k] for k in (
        "nt", "bb", "fh", "fw", "s", "hi", "ho", "wi", "wo", "ni", "no",
        "ci", "co", "ki", "ko", "ti", "to", "pi", "po", "q")})
