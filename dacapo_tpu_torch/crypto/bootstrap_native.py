"""Native CKKS bootstrapping: ModRaise -> CoeffToSlot -> EvalMod -> SlotToCoeff.

Port of dacapo_tpu/crypto/bootstrap_native.py (PyTorch): the same classes,
methods and host arithmetic, in the same order. Every plaintext scale, the
Chebyshev coefficients and the DFT diagonals are Python floats and numpy
values computed exactly as the reference computes them, so the encoded
plaintexts and every ciphertext are bit-equal to the JAX package's.

This is the component the reference licenses out to HEaaN (the SEAL build
ships only a decrypt/re-encrypt emulation, lib/Runtime/SEAL_HEVM.cpp:324-334;
the real path is HEAAN_HEVM.cpp:386-399 `bootstrapper->bootstrap`). Here it is
built from the port's RNS primitives (crypto/ops.py), whose NTTs run as the
hand-written CUDA kernel on the card:

* ModRaise: centered lift of the level-1 residue plane (or the bottom prime
  pair) to the full Q chain.
* CoeffToSlot / SlotToCoeff: the "twisted DFT" A[j,k] = zeta^{5^j k}. Because
  5^j = 1 mod 4, slots of any ciphertext satisfy z = A (a + i b) where (a, b)
  are the low/high coefficient halves — so ONE s x s transform suffices in
  each direction (full packing). Evaluated as BSGS diagonal matrix-vector
  products whose baby rotations ride the hoisted rotation bank
  (ops.Evaluator.rotate_batch).
* EvalMod: Re/Im split via the conjugation key, then Chebyshev approximation
  of cos((2*pi*K*x - pi/2) / 2^r) followed by r double-angle steps — yielding
  sin(2*pi*t), i.e. t mod 1, with the 1/(2*pi) folded into the metadata scale
  (a free "scale trick" in the RNS representation).

Scale management here is manual and exact: every plaintext is encoded at the
scale that makes the post-rescale result land on its target scale, so adds
never mix drifted scales (the HEaaN VM does the same bookkeeping at runtime,
HEAAN_HEVM.cpp:313-343).

Device memory: the plaintext diagonals (one [nl, N] plane each) and the
constants are encoded on first use and cached on the device for the life of
the bootstrapper; the galois keys of the baby and giant steps and the
conjugation key are generated on first use (crypto/keys.py).
"""

from dataclasses import dataclass

import numpy as np
import torch
from numpy.polynomial import chebyshev as C

from .crt_lift import pair_crt_expand
from .params import to_dev


@dataclass(frozen=True)
class BootstrapConfig:
    K: int = 16           # ModRaise integer range bound |I + m/q0| <= K
    r: int = 3            # double-angle iterations
    degree: int = 36      # Chebyshev degree for the base cos approx
    baby: int = 8         # Chebyshev BSGS baby-step count (power of two)
    radix: int = 5        # butterfly stages merged per CtS/StC level
    #   Each merged level costs 1 multiplicative depth and ~2*sqrt(2^radix)
    #   hoisted rotations; total levels = ceil(log2(slots)/radix). radix=5
    #   -> 3 levels at N=2^16, matching HEaaN-class FFT bootstrapping.


# --------------------------------------------------------------------------
# ciphertext value wrapper with manual (nl, scale) bookkeeping
# --------------------------------------------------------------------------

class CtVal:
    """(data [2, nl, N], scale) with exact host-side scale tracking.

    All multiplicative ops rescale by the bootstrapper's COMPOSITE span
    (`bs.rs` top rows at once, product ~2^60 for 30-bit limb pairs). This is
    what makes the pipeline precise on 30-bit limbs: every plaintext constant
    is encoded at pt_scale = target * q_span / scale ~ 2^60, so even tiny
    constants (the 2^-13 EvalMod normalizer, sub-unit DFT diagonals) keep
    ~47+ bits of mantissa — the single-row variant caps pt_scale at ~2^30
    and collapses to 10-17 bit constants, which measured 1e-2..1 relative
    error after the q0'/delta' amplification."""

    __slots__ = ("bs", "data", "scale")

    def __init__(self, bs, data, scale):
        self.bs = bs
        self.data = data
        self.scale = float(scale)

    @property
    def nl(self):
        return int(self.data.shape[1])

    def drop_to(self, nl):
        if nl == self.nl:
            return self
        assert nl < self.nl
        return CtVal(self.bs, self.data[:, :nl, :], self.scale)

    def add(self, o):
        assert self.nl == o.nl
        assert abs(self.scale / o.scale - 1) < 1e-9, (self.scale, o.scale)
        return CtVal(self.bs, self.bs.ev.add_ct(self.data, o.data, self.nl), self.scale)

    def sub(self, o):
        assert self.nl == o.nl
        assert abs(self.scale / o.scale - 1) < 1e-9
        return CtVal(self.bs, self.bs.ev.sub_ct(self.data, o.data, self.nl), self.scale)

    def mul_ct(self, o):
        assert self.nl == o.nl
        s = self.bs.s
        return CtVal(self.bs, s.ev.mul_ct(self.data, o.data, self.nl, s.keys.rlk),
                     self.scale * o.scale).rescale()

    def square(self):
        s = self.bs.s
        return CtVal(self.bs, s.ev.square_ct(self.data, self.nl, s.keys.rlk),
                     self.scale * self.scale).rescale()

    def q_span(self, nl=None):
        """Product of the top `bs.rs` primes at this level."""
        nl = nl or self.nl
        qs = self.bs.s.ctx.q_primes
        out = 1.0
        for i in range(self.bs.rs):
            out *= qs[nl - 1 - i]
        return out

    def rescale(self):
        rs = self.bs.rs
        assert self.nl > rs, "bootstrap pipeline exhausted the modulus chain"
        span = self.q_span()
        return CtVal(self.bs, self.bs.ev.rescale_k(self.data, self.nl, rs),
                     self.scale / span)

    def mul_const(self, c, target_scale):
        """Multiply by scalar c (complex ok), rescaling onto target_scale
        exactly: the constant is encoded at scale target*q_span/self.scale."""
        pt_scale = target_scale * self.q_span() / self.scale
        pt = self.bs.encode_const(c, pt_scale, self.nl)
        out = self.bs.ev.mul_pt(self.data, pt, self.nl)
        return CtVal(self.bs, out, self.scale * pt_scale).rescale()

    def add_const(self, c):
        pt = self.bs.encode_const(c, self.scale, self.nl)
        return CtVal(self.bs, self.bs.ev.add_pt(self.data, pt, self.nl), self.scale)

    def scale_by(self, factor):
        """Metadata-only division of the value by `factor` (free)."""
        return CtVal(self.bs, self.data, self.scale * factor)

    def double_val(self):
        """value *= 2 at the SAME declared scale via a native 1-bit upscale
        (multiply the RNS ints by 2; no rescale, no level cost).

        Chebyshev doubling steps T_2k = 2*T_k^2 - 1 must use this instead of
        scale_by(0.5): halving the declared scale compounds quadratically
        through squarings (scale_k = q/2^(2^k - 1) -> precision collapse),
        while doubling the ints keeps scale ~= q stable through the chain."""
        return CtVal(self.bs, self.bs.ev.upscale(self.data, self.nl, 1),
                     self.scale)

    def conj(self):
        s = self.bs.s
        s.keygen.ensure_conj(s.keys)
        return CtVal(self.bs, s.ev.conjugate(self.data, self.nl, s.keys.conj),
                     self.scale)


# --------------------------------------------------------------------------
# BSGS linear transform over slots
# --------------------------------------------------------------------------

class SlotLinearTransform:
    """z -> M z for a sparse-diagonal complex matrix, BSGS diagonal method.

    out = sum_g rot_{g*b}( sum_j rot_{-g*b}(diag_{g*b+j}) * rot_j(z) )

    Baby rotations rot_j(z) share one hoisted ModUp (rotate_batch); the
    plaintext diagonals are encoded lazily per (level, scale) signature.
    `diags`: {offset: complex [s]} with convention (Mz)_j = sum_d
    diags[d][j] * z[(j+d) % s] (dft_factor level dicts), or a dense [s, s]
    matrix for small ad-hoc transforms.
    """

    def __init__(self, bs, mat=None, diags=None, s=None):
        self.bs = bs
        if diags is None:
            s = mat.shape[0]
            diags = {}
            for off in range(s):
                d = np.array([mat[k, (k + off) % s] for k in range(s)])
                if np.max(np.abs(d)) > 1e-12 * max(1.0, np.max(np.abs(mat))):
                    diags[off] = d
        else:
            s = s or bs.s.ctx.config.n_slots
        self.s = s
        self.diags = {
            off: np.asarray(v) for off, v in diags.items()
            if np.max(np.abs(v)) > 1e-15
        }
        offs = sorted(self.diags)
        b = max(1, int(np.ceil(np.sqrt(len(offs)))))
        # group offsets by giant step g*b
        self.b = b
        self.groups = {}
        for off in offs:
            self.groups.setdefault(off // b, []).append(off)
        self._pt_cache = {}

    def _pt(self, off, g, nl, pt_scale):
        key = (off, g, nl, pt_scale)
        pt = self._pt_cache.get(key)
        if pt is None:
            d = np.roll(self.diags[off], g * self.b)
            pt = self.bs.encode_vec(d, pt_scale, nl)
            self._pt_cache[key] = pt
        return pt

    def rotation_steps(self):
        """Every nonzero rotation step apply() takes (baby and giant), as
        slot shifts in [1, n_slots): the galois keys this level needs."""
        n_slots = self.bs.s.ctx.config.n_slots
        steps = {off % self.b for offs in self.groups.values() for off in offs}
        steps |= {(g * self.b) % n_slots for g in self.groups}
        return sorted(st % n_slots for st in steps if st % n_slots)

    def apply(self, ct: CtVal, target_scale: float) -> CtVal:
        bs = self.bs
        s_obj = bs.s
        nl = ct.nl
        pt_scale = target_scale * ct.q_span() / ct.scale

        baby_steps = sorted({off % self.b for offs in self.groups.values()
                             for off in offs} | {0})
        rots = bs.rotate_bank(ct.data, nl, baby_steps)
        rot_of = dict(zip(baby_steps, rots))

        acc = None
        for g, offs in sorted(self.groups.items()):
            inner = None
            for off in offs:
                pt = self._pt(off, g, nl, pt_scale)
                term = bs.ev.mul_pt(rot_of[off % self.b], pt, nl)
                inner = term if inner is None else bs.ev.add_ct(term, inner, nl)
            gsteps = (g * self.b) % s_obj.ctx.config.n_slots
            if gsteps != 0:
                s_obj.ensure_galois([gsteps])
                inner = bs.ev.rotate(inner, nl, gsteps, s_obj.keys.galois[gsteps])
            acc = inner if acc is None else bs.ev.add_ct(acc, inner, nl)
        return CtVal(bs, acc, ct.scale * pt_scale).rescale()


# --------------------------------------------------------------------------
# the bootstrapper
# --------------------------------------------------------------------------

class NativeBootstrapper:
    def __init__(self, scheme, cfg: BootstrapConfig = None):
        self.s = scheme
        self.ev = scheme.ev
        self.cfg = cfg or BootstrapConfig()
        ctx = scheme.ctx
        self.q0 = ctx.q_primes[0]
        # composite rescale span inside the pipeline (see CtVal docstring):
        # pairs of 30-bit primes emulate one ~60-bit bootstrap prime
        self.rs = 2
        # internal working scale = nominal pair size (~2^60): the square/
        # rescale fixed point (scale^2/q_span ~ scale), exactly like HEaaN's
        # Delta ~ q_i regime. GAP_BITS applies only to the INPUT upscale
        # (delta' = q0' * 2^-GAP): the EvalMod output value carries the
        # delta'/q0' factor, so final ints are ~2^51 * m and never overflow
        # the bottom pair. Scale drift from non-nominal primes is re-anchored
        # at every mul_const (exact landing), so square chains stay short.
        self.delta_bs = float(2.0 ** (self.rs * ctx.config.prime_bits))
        # nominal EvalMod normalizer folded into the last CtS level's
        # diagonals; the residual (actual delta'/q0' vs 2^-GAP) rides the
        # declared scale, exactly (see bootstrap()).
        self.norm_nom = 2.0 ** (-self.GAP_BITS) / self.cfg.K
        # Slot transforms are the FFT-factored twisted DFT (dft_factor.py):
        # ceil(log2 s / radix) sparse-diagonal levels per direction instead
        # of one dense s x s matrix (which is O(s^2) memory — infeasible at
        # N=2^16). Bit-reversal stays implicit: CtS leaves coefficients in
        # brv order, EvalMod is pointwise, StC undoes it.
        self._cts = None
        self._stc = None
        self._cheb = None
        self._enc_cache = {}
        self.calls = 0          # bootstraps run (chip_smoke.py checks the count)

    # ------------------------------------------------------------ helpers
    def encode_vec(self, vec, scale, nl):
        planes = self.s.encoder.encode(vec, float(scale), nl)
        return self.ev.ntt(to_dev(planes, self.s.device), list(range(nl)))

    def encode_const(self, c, scale, nl):
        key = (complex(c), float(scale), nl)
        pt = self._enc_cache.get(key)
        if pt is None:
            vec = np.full(self.s.ctx.config.n_slots, c, dtype=np.complex128)
            pt = self.encode_vec(vec, scale, nl)
            self._enc_cache[key] = pt
        return pt

    def rotate_bank(self, data, nl, steps):
        """Hoisted batch of rotations; returns list aligned with `steps`.
        The keys go to rotate_batch as a list (never stacked: at tpu_n15b a
        key is 78.6 MB)."""
        n_slots = self.s.ctx.config.n_slots
        nz = [st for st in steps if st % n_slots != 0]
        out = {}
        if nz:
            self.s.ensure_galois(nz)
            shifts = [st % n_slots for st in nz]
            gks = [self.s.keys.galois[st % n_slots] for st in nz]
            res = self.ev.rotate_batch(data, nl, shifts, gks)
            for i, st in enumerate(nz):
                out[st] = res[i]
        for st in steps:
            if st % n_slots == 0:
                out[st] = data
        return [out[st] for st in steps]

    # --------------------------------------------------------- mod raise
    def mod_raise(self, data, nl):
        """ct mod q0 -> ct mod Q_full (centered lift), NTT domain in/out.
        Single-prime base path (nl == 1); pair-base raises go through
        mod_raise_pair."""
        ctx = self.s.ctx
        num_q = ctx.config.num_q
        if nl > 1:
            data = data[:, :1, :]
        c = self.ev.intt(data[:, 0, :], [0, 0])          # [2, N] coeffs mod q0
        qs = np.array(ctx.q_primes[:num_q], dtype=np.int64)
        assert (qs > self.q0 // 2).all(), "mod_raise needs q_i > q0/2"
        # v <= q0/2: v already < q_i; v > q0/2: v - q0 + q_i in [0, q_i)
        corr = torch.from_numpy(qs - np.int64(self.q0)).to(c.device)
        v = c.to(torch.int64)[:, None, :]                 # [2, 1, N]
        lifted = torch.where(v > self.q0 // 2, v + corr[None, :, None], v)
        flat = lifted.to(torch.int32).reshape(2 * num_q, ctx.n)
        rows = [r for r in range(num_q)] + [r for r in range(num_q)]
        out = self.ev.ntt(flat, rows).reshape(2, num_q, ctx.n)
        return out

    def mod_raise_pair(self, data, nl):
        """ct mod q0*q1 -> ct mod Q_full (centered CRT lift from the bottom
        prime PAIR), NTT domain in/out.

        The 60-bit composite base is what makes native bootstrapping precise
        on 30-bit limbs: with q0' = q0*q1 ~ 2^60 and the input pre-upscaled
        to delta' ~ 2^51 the EvalMod linearization error is (2*pi*m*2^-9)^2/6
        ~ 1e-5 relative — the HEaaN base-modulus geometry (their logq0=60 >
        logDelta=51), unreachable from any single 30-bit prime.

        Exact integer arithmetic throughout (crt_lift.pair_crt_expand)."""
        ctx = self.s.ctx
        num_q = ctx.config.num_q
        assert nl >= 2, "pair-base mod_raise needs >= 2 RNS rows"
        c = self.ev.intt(data[:, :2, :].reshape(4, ctx.n), [0, 1, 0, 1])
        c = c.reshape(2, 2, ctx.n)
        r = pair_crt_expand(ctx, c[:, 0, :], c[:, 1, :], num_q)
        flat = r.reshape(2 * num_q, ctx.n)
        rows = [i for i in range(num_q)] + [i for i in range(num_q)]
        return self.ev.ntt(flat, rows).reshape(2, num_q, ctx.n)

    # ------------------------------------------------------ chebyshev eval
    def _cheb_coeffs(self):
        if self._cheb is None:
            K, r, deg = self.cfg.K, self.cfg.r, self.cfg.degree
            f = lambda x: np.cos((2 * np.pi * K * x - np.pi / 2) / (2 ** r))
            self._cheb = C.chebinterpolate(f, deg)
        return self._cheb

    def _eval_cheb_bsgs(self, t1: CtVal, coeffs):
        """Evaluate sum_i coeffs[i] T_i(t1), Paterson-Stockmeyer over the
        Chebyshev basis, with LEVEL-UNIFORM scheduling: all baby/giant powers
        are normalized to one (level, scale) base, every leaf sits at rank 1
        below the base, and each PS recursion adds exactly one level — total
        depth ceil(log2 b) + 1 + ceil(log2(deg/b)) + 1 instead of the
        cascading alignments a naive walk pays (each stray mismatch costs a
        whole extra level via alignment const-muls)."""
        b = self.cfg.baby
        deg = len(coeffs) - 1

        # baby steps T_1..T_b and giants T_{2b}, T_{4b}, ...
        T = {1: t1}
        for i in range(2, b + 1):
            if i % 2 == 0:
                h = T[i // 2]
                T[i] = h.square().double_val().add_const(-1.0)
            else:
                # T_i = 2 T_{(i+1)/2} T_{(i-1)/2} - T_1  (i odd)
                a_, b_ = T[(i + 1) // 2], T[(i - 1) // 2]
                nl = min(a_.nl, b_.nl)
                prod = a_.drop_to(nl).mul_ct(b_.drop_to(nl)).double_val()
                t1d = t1.drop_to(prod.nl)
                t1a = t1d.mul_const(1.0, prod.scale) if abs(
                    t1d.scale / prod.scale - 1) > 1e-9 else t1d
                nl_c = min(prod.nl, t1a.nl)
                T[i] = prod.drop_to(nl_c).sub(t1a.drop_to(nl_c))
        g = 2 * b
        while g <= deg:
            h = T[g // 2]
            T[g] = h.square().double_val().add_const(-1.0)
            g *= 2

        # Level invariants (no separate normalize pass — the leaf const-muls
        # double as normalization): leaves output at nl_leaf - 1 on a common
        # scale; giants T_{2^k b} sit at nl_leaf - k + ... >= any quotient
        # that multiplies them, so each PS recursion costs exactly 1 level.
        delta = max(t1.scale, self.delta_bs)
        nl_leaf = min(T[k].nl for k in T if k <= b)

        def leaf(c):
            terms = [(i, c[i]) for i in range(1, len(c)) if abs(c[i]) > 1e-15]
            acc = None
            for i, ci in terms:
                term = T[i].drop_to(nl_leaf).mul_const(ci, delta)
                acc = term if acc is None else acc.add(term)
            if acc is None:
                acc = T[1].drop_to(nl_leaf).mul_const(0.0, delta)
            if abs(c[0]) > 1e-15:
                acc = acc.add_const(complex(c[0]))
            return acc

        def eval_poly(c):
            """CtVal for sum c[i] T_i at exactly rank(deg c) below base."""
            d = len(c) - 1
            while d > 0 and abs(c[d]) < 1e-15:
                d -= 1
            c = c[: d + 1]
            if d <= b:
                return leaf(c)
            gg = b
            while gg * 2 <= d:
                gg *= 2
            tg = np.zeros(gg + 1)
            tg[gg] = 1.0
            q, r = C.chebdiv(c, tg)
            qv = eval_poly(q)           # rank(d) - 1
            rv = eval_poly(r)           # rank(deg r) <= rank(d) - 1
            prod = qv.mul_ct(T[gg].drop_to(qv.nl))     # rank(d)
            # align the shallower operand onto the deeper one with one
            # exact-landing const-mul (for deg > 2*b*2 the REMAINDER can be
            # the deeper branch — chebdiv by T_32 leaves deg-31 remainders)
            if rv.nl > prod.nl:
                rv = rv.drop_to(prod.nl + self.rs).mul_const(1.0, prod.scale)
            elif prod.nl > rv.nl:
                prod = prod.drop_to(rv.nl + self.rs).mul_const(1.0, rv.scale)
            elif abs(prod.scale / rv.scale - 1) > 1e-12:
                rv = rv.mul_const(1.0, delta)
                prod = prod.mul_const(1.0, delta)
            return prod.add(rv)

        return eval_poly(np.asarray(coeffs, dtype=np.complex128))

    # ----------------------------------------------------------- pipeline
    def _transforms(self):
        """CtS/StC level stacks with the EvalMod normalizer and the Re/Im
        split folded into the boundary levels (zero extra depth):

        * the LAST CtS level is built twice — diagonals scaled by norm_nom
          and by -i*norm_nom. Re-extraction via conj-add on each output
          yields both EvalMod inputs without the t1 const-mul level.
        * the FIRST StC level is built twice — plain and diagonals scaled
          by i. StC(v_re) + StC_i(v_im) replaces the repack const-mul level
          (linearity: the i rides one level's diagonals exactly).
        """
        if self._cts is None:
            from .dft_factor import build_levels
            n = self.s.ctx.n
            radix = self.cfg.radix
            cts = build_levels(n, radix, inverse=True)
            self._cts = [SlotLinearTransform(self, diags=d)
                         for d in cts[:-1]]
            self._cts_last_diags = cts[-1]
            self._cts_last_cache = {}
            stc = build_levels(n, radix, inverse=False)
            scaled = lambda d, c: {off: np.asarray(v) * c
                                   for off, v in d.items()}
            self._stc_first = (
                SlotLinearTransform(self, diags=stc[0]),
                SlotLinearTransform(self, diags=scaled(stc[0], 1j)),
            )
            self._stc = [SlotLinearTransform(self, diags=d)
                         for d in stc[1:]]
        return self._cts, self._stc_first, self._stc

    def _cts_last(self, norm):
        """Last CtS level with `norm/2` folded into its diagonals (both the
        EvalMod normalizer and the conj-add halving), built per distinct
        input-delta normalizer so t1 lands EXACTLY on delta_bs — an inexact
        anchor would drift off the square/rescale fixed point and the scale
        error doubles per squaring (measured: 2^263 by EvalMod's end)."""
        self._transforms()
        key = float(norm)
        pair = self._cts_last_cache.get(key)
        if pair is None:
            scaled = lambda c: {off: np.asarray(v) * c
                                for off, v in self._cts_last_diags.items()}
            pair = (
                SlotLinearTransform(self, diags=scaled(norm / 2)),
                SlotLinearTransform(self, diags=scaled(-1j * norm / 2)),
            )
            self._cts_last_cache[key] = pair
        return pair

    def rotation_steps(self):
        """The nonzero rotation steps of every CtS/StC level (the galois
        keys a bootstrap uses, besides the conjugation key), sorted. Builds
        the level stacks, encodes nothing and draws no key."""
        cts, stc_first, stc_rest = self._transforms()
        last = SlotLinearTransform(self, diags=self._cts_last_diags)
        levels = list(cts) + [last, stc_first[0]] + list(stc_rest)
        return sorted({st for t in levels for st in t.rotation_steps()})

    # EvalMod input geometry: pre-upscale the input so delta'/q0' ~ 2^-GAP_BITS
    # (HEaaN: logq0 60, logDelta 51). Larger gap -> worse sin linearization;
    # smaller gap -> EvalMod's absolute error is amplified by q0'/delta'.
    GAP_BITS = 9

    def bootstrap(self, data, nl, scale, target_level):
        """data: int32 [2, nl, N]; returns (data', (nl', scale')).

        `target_level` is in hevm levels (composite profiles expand it by
        rescale_rows). The input is dropped to the bottom prime PAIR
        (q0' = q0*q1 ~ 2^60) and pre-upscaled to delta' ~ q0' * 2^-GAP_BITS
        before the centered CRT raise — exact int ops, no level cost."""
        cfg = self.cfg
        s = self.s
        ctx = s.ctx
        delta = float(scale)

        if nl < 2:
            raise ValueError(
                "native bootstrap needs the bottom prime pair (nl >= 2); "
                "the planner must not drop bootstrap operands below level "
                f"{2 // ctx.config.rescale_rows}")
        self.calls += 1
        q0p = float(ctx.q_primes[0]) * float(ctx.q_primes[1])
        # Inputs that arrive hot (zero-depth boundaries: delta up to ~q0')
        # are cooled by exact single-row rescales until delta fits the
        # EvalMod geometry delta' <= q0' * 2^-GAP_BITS; the existing
        # up_bits pre-upscale then re-heats small scales exactly.
        data = data[:, :nl, :]
        scale_orig = delta
        while nl > 2 and np.log2(delta) > np.log2(q0p) - self.GAP_BITS:
            data = self.ev.rescale_k(data, nl, 1)
            delta /= float(ctx.q_primes[nl - 1])
            nl -= 1
        if np.log2(delta) > np.log2(q0p) - self.GAP_BITS:
            # nl hit the bottom pair while still hot: the EvalMod geometry
            # bound is violated and the result would be silently wrong —
            # surface the planner bug instead
            raise ValueError(
                f"bootstrap input still hot after cooling: log2(delta)="
                f"{np.log2(delta):.1f} > {np.log2(q0p) - self.GAP_BITS:.1f}; "
                "the planner let a bootstrap operand reach the bottom pair "
                "above the EvalMod geometry bound")
        base = data[:, :2, :]
        up_bits = max(0, int(round(np.log2(q0p) - self.GAP_BITS
                                   - np.log2(delta))))
        if up_bits:
            base = self.ev.upscale(base, 2, up_bits)
            delta = delta * (2.0 ** up_bits)
        q0 = q0p

        raised = self.mod_raise_pair(base, 2)
        ct = CtVal(self, raised, delta)

        cts_shared, stc_first, stc_rest = self._transforms()
        # full normalizer (incl. conj-add halving) folded into the last CtS
        # level's diagonals — exact, zero extra depth, cached per delta
        cts_last = self._cts_last(delta / (q0 * cfg.K))

        # Internal working scale = nominal pair size (~2^60): ct*ct squares
        # satisfy scale^2/q_span ~= scale, and every plaintext constant
        # encodes at pt_scale ~ 2^60 (full precision on 30-bit limbs).
        delta_bs = self.delta_bs

        # CoeffToSlot: u = A^{-1} z (coeffs in brv slot order); one level
        # per merged butterfly group. The last level is applied twice with
        # norm / -i*norm folded into its diagonals; Re-extraction via
        # conj-add yields both EvalMod inputs with no const-mul level.
        u = ct
        for t in cts_shared:
            u = t.apply(u, delta_bs)
        u1 = cts_last[0].apply(u, delta_bs)        # value = (norm/2) * u
        u2 = cts_last[1].apply(u, delta_bs)        # value = (-i*norm/2) * u
        t1_re = u1.add(u1.conj())                  # value = norm * Re(u)
        t1_im = u2.add(u2.conj())                  # value = norm * Im(u)

        coeffs = self._cheb_coeffs()

        def evalmod(t1):
            y = self._eval_cheb_bsgs(t1, coeffs)
            for _ in range(cfg.r):
                y = y.square().double_val().add_const(-1.0)
            # y = sin(2*pi*t) ; value m/q0 = y / (2*pi)
            return y.scale_by(2.0 * np.pi)

        v_re = evalmod(t1_re)
        v_im = evalmod(t1_im)       # identical op sequence -> same scale

        # SlotToCoeff with the repack folded into its first level:
        # A(v_re + i*v_im) = A1...(Afirst v_re + Afirst_i v_im) — the i rides
        # the duplicated first level's diagonals, zero extra depth.
        #
        # The StC target scale is chosen so the DECLARED output scale lands
        # exactly back on the input scale (pre-cooling): the Earth IR types
        # bootstrap as scale-preserving (ir/earth.py infer_type "bootstrap")
        # and the executor's _meta_step predicts the same, so segment
        # windows planned from the metadata walk stay faithful. The out value
        # is z*(delta/q0); forcing out.scale = scale_orig*q0/delta makes
        # ints = z*scale_orig.
        target0 = scale_orig * q0 / delta
        out = stc_first[0].apply(v_re, target0).add(
            stc_first[1].apply(v_im, target0))
        for t in stc_rest:
            out = t.apply(out, target0)

        nl2 = (target_level + 1) * ctx.config.rescale_rows
        assert out.nl >= nl2, (
            f"bootstrap consumed too many levels: have {out.nl}, need {nl2}")
        res = out.data[:, :nl2, :]
        return res, (nl2, scale_orig)
