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

CUDA graphs (the port's counterpart of the JAX package's per-op jit, which
makes a TPU bootstrap a few hundred compiled dispatches where an eager one
here launches ~70k kernels): `capture(nl, scale, target_level)` records one
signature's `_bootstrap` (the device work) into a graph, which every later
`bootstrap` of that signature on the card replays; `bootstrap` itself keeps
the host bookkeeping (the count, the planned sequence's position, the plane
bound's groups) for eager calls and replays alike. A graph bakes in the
addresses of every plane and key it reads: its planes are pinned (out of the
bound's reach) until `drop_graphs`, and a replaced key makes `bootstrap`
refuse the graph. `capture_blocker` says why no graph can run now, `graph_plan`
which signatures the plane bound leaves room to pin.
"""

import dataclasses
import math
import time
from dataclasses import dataclass
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import torch
from numpy.polynomial import chebyshev as C

from .crt_lift import pair_crt_expand
from .cuda import graphs, ntt_kernel
from .params import UploadUnderCapture, upload


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


# ModRaise's overflow I (|I + m/q0| <= K above) is, coefficient by
# coefficient, round(c1 s / q0): for a secret of Hamming weight h, the sum of
# h terms uniform in [-1/2, 1/2) (sigma = sqrt(h / 12), 4 at h = 192). Where
# some coefficient of the N passes what EvalMod's polynomial maps to
# sin(2 pi I) (`evalmod_reach`: K for degree 40 at K = 24, K + 1 for the
# reference's K = 16, degree 36), StC spreads the error over every slot.
# The reference's K = 16 suits h = 64 (a bootstrap fails with probability
# 2^-34.2 at N = 2^15) but not h = 192 (tpu_n15b, tpu_n16): 0.31 a
# bootstrap, and ResNet-20 on tpu_n15b decrypted to logits 0.0084 and 0.49
# RMS off on an NVIDIA H100 80GB HBM3, 4 of its 18 bootstraps wrong.
# sized_for_secret takes the least K whose failure probability a bootstrap,
# `failure_probability`, is at most OVERFLOW_TARGET. The target is what depth
# and precision allow on tpu_n15b: degree 40 is the most EvalMod evaluates at
# degree 36's depth (41 to 64 take one level more), which reaches K = 26 at
# most, and the bootstrap's error grows with K (the message is normalized by
# 1/K before EvalMod): K = 24 takes ResNet-20 to 8.9e-4 RMS against its
# 9.5152e-4 bar. A request of 18 bootstraps keeps a failure probability of
# 3.7e-4 (h = 192, N = 2^15); 2^-30 a request would take K = 31 at degree 52,
# one level more than the compiled program leaves the bootstrap.
OVERFLOW_TARGET = 2.0 ** -15
# From WIDE_SLOTS slots on (tpu_n16: N = 2^16, 42 + 14 primes of ~29.9
# bits) the port's bootstrap deviates from the reference's arithmetic in
# three places, each costing no level; below (tpu_n15b, test_boot) it is the
# reference's, bit for bit.
# * The working scale delta_bs is where EvalMod returns to
#   (_returning_scale), not the nominal 2^60: tpu_n16's primes pair to
#   spans of 2^59.78 to 2^59.93, EvalMod's squarings double the distance
#   from the span at each step, and from 2^60 its output leaves at 2^99
#   (tpu_n15b's balanced pairs span 2^60.000). SlotToCoeff's first level
#   then encodes its diagonals at target * q_span / 2^101.9: 2^-5 for a
#   2^28 input, nothing left of them.
# * SlotToCoeff's levels before the last land on the working scale, only
#   the last on the output's (target0 = the input's scale * q0' / delta').
#   The reference lands every level on target0 (2^37 for a 2^28 input),
#   where the key switches of the next level's baby steps add their noise.
# * The input is raised to delta' = q0' * 2^-WIDE_GAP_BITS, not 2^-9. The
#   message's coefficients in t = I + m/q0' shrink as 1/sqrt(N) for
#   zero-mean slots (m/q0' 4.6e-6 RMS at N = 2^16, GAP 9), and CoeffToSlot's
#   noise, ~3e-10 of t there, took 3.1e-5 of them; a constant c keeps its
#   one coefficient c * 2^-GAP, where the sine's cubic term takes
#   (2 pi c 2^-GAP)^2 / 6 of it (GAP 5: 1.4e-3 of the deep program's
#   ~0.47, which decrypted 7.5e-4 RMS off). GAP 7 quarters the first and
#   keeps the second below 1e-4 of a value below 1.
# scripts/torch_bootstrap_stages.py holds every stage against a float model
# under both arithmetics (PERF.md has its numbers).
WIDE_SLOTS = 1 << 15
WIDE_GAP_BITS = 7
EVALMOD_TOL = 1e-7      # EvalMod's error in sin(2 pi I) past which a coefficient fails
WIDE_DEGREE = 40        # the degree past K = 16: EvalMod's error at K = 24 near 1e-9


def evalmod_reach(cfg):
    """The largest integer B such that EvalMod's polynomial (the Chebyshev
    fit of degree cfg.degree over [-K, K], then cfg.r double angles) stays
    within EVALMOD_TOL of sin(2 pi I) at every integer |I| <= B, in
    float64."""
    f = lambda x: np.cos((2 * np.pi * cfg.K * x - np.pi / 2) / (2 ** cfg.r))
    coeffs = C.chebinterpolate(f, cfg.degree)
    reach = 0
    while True:
        y = C.chebval(np.array([reach + 1, -reach - 1]) / cfg.K, coeffs)
        for _ in range(cfg.r):
            y = 2 * y * y - 1
        if not np.all(np.abs(y) <= EVALMOD_TOL):
            return reach
        reach += 1


def overflow_tail(secret_h, bound):
    """P(|I| > bound) for one coefficient of ModRaise's overflow: |S| >=
    bound + 1/2 for S the sum of secret_h uniforms on [-1/2, 1/2), exactly,
    from the Irwin-Hall distribution's CDF."""
    n = secret_h
    y = Fraction(n - 2 * bound - 1, 2)             # P(S >= a) = F_n(n/2 - a)
    if y <= 0:
        return 0.0
    cdf = sum((-1) ** k * math.comb(n, k) * (y - k) ** n for k in range(int(y) + 1))
    return float(2 * cdf / math.factorial(n))


def failure_probability(cfg, secret_h, n):
    """The probability, bounded by the union over the n coefficients, that
    some coefficient's ModRaise overflow passes EvalMod's reach in one
    bootstrap."""
    return min(1.0, n * overflow_tail(secret_h, evalmod_reach(cfg)))


def sized_for_secret(cfg, secret_h, n):
    """`cfg` if its failure probability a bootstrap (N = n, Hamming weight
    secret_h) is at most OVERFLOW_TARGET (the reference's K = 16 and degree
    36 up to h = 101 at N = 2^15), else the least K past it, at degree
    WIDE_DEGREE, that meets the target (K = 24 at h = 192). A dense secret
    (secret_h 0) keeps `cfg`, as the reference does."""
    if secret_h <= 0:
        return cfg
    for k in range(cfg.K, 4 * cfg.K + 1):
        cand = cfg if k == cfg.K else dataclasses.replace(
            cfg, K=k, degree=max(cfg.degree, WIDE_DEGREE))
        if failure_probability(cand, secret_h, n) <= OVERFLOW_TARGET:
            return cand
    raise ValueError(f"no K up to {4 * cfg.K} at degree {WIDE_DEGREE} keeps the "
                     f"bootstrap's failure probability under {OVERFLOW_TARGET} "
                     f"at h = {secret_h}, N = {n}")


def native_radix(n_slots):
    """The butterfly radix HEVM builds the native bootstrapper with: more
    slots take a bigger one (fewer CtS/StC levels, more rotations each), 8
    from 2^15 slots, 7 from 2^14, else 5. The reference takes 7 from 2^14
    slots (its runtime/runner.py:81), which on tpu_n16 leaves 8 of the
    chain's 42 rows where its compiler profile lands every bootstrap at
    level 29; radix 8 leaves 12 (rows_left), as the profile's comment
    budgets."""
    return 8 if n_slots >= 1 << 15 else 7 if n_slots >= 1 << 14 else 5


def native_config(config):
    """The BootstrapConfig HEVM builds for a profile (CKKSConfig):
    native_radix, and the ModRaise bound K sized for the secret
    (sized_for_secret)."""
    return sized_for_secret(BootstrapConfig(radix=native_radix(config.n_slots)),
                            config.secret_h, config.n)


def rows_left(ctx, cfg):
    """The RNS rows of ctx's chain that a bootstrap with BootstrapConfig
    cfg leaves (NativeBootstrapper.rows_left), without a scheme, keys or
    data: a bootstrap reaches target level t where (t + 1) *
    rescale_rows <= this."""
    return NativeBootstrapper(SimpleNamespace(ctx=ctx, ev=None), cfg).rows_left()


class _Level:
    """A CtVal's rows and scale without its data: NativeBootstrapper.
    rows_left walks a bootstrap's levels with it, through the same calls,
    branches and host scale arithmetic as CtVal's."""

    __slots__ = ("q", "rs", "nl", "scale")

    def __init__(self, q, rs, nl, scale):
        self.q, self.rs, self.nl, self.scale = q, rs, nl, float(scale)

    def _at(self, nl, scale):
        return _Level(self.q, self.rs, nl, scale)

    def drop_to(self, nl):
        assert nl <= self.nl
        return self._at(nl, self.scale)

    def add(self, o):
        assert self.nl == o.nl
        return self

    sub = add

    def q_span(self):
        out = 1.0
        for i in range(self.rs):
            out *= self.q[self.nl - 1 - i]
        return out

    def rescale(self):
        assert self.nl > self.rs, "bootstrap pipeline exhausted the modulus chain"
        return self._at(self.nl - self.rs, self.scale / self.q_span())

    def mul_ct(self, o):
        assert self.nl == o.nl
        return self._at(self.nl, self.scale * o.scale).rescale()

    def square(self):
        return self.mul_ct(self)

    def mul_const(self, c, target_scale):
        pt_scale = target_scale * self.q_span() / self.scale
        return self._at(self.nl, self.scale * pt_scale).rescale()

    def add_const(self, c):
        return self

    def scale_by(self, factor):
        return self._at(self.nl, self.scale * factor)

    def double_val(self):
        return self


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
        self.bs._read(self._pt_cache, key, pt)
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
        self.wide = ctx.config.n_slots >= WIDE_SLOTS
        if self.wide:
            self.GAP_BITS = WIDE_GAP_BITS       # module comment at WIDE_SLOTS
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
        # the bound on the cached planes (set_plane_budget): the planes each
        # input signature's bootstrap encoded first, by signature
        self.plane_budget = None
        self._groups = {}               # (nl, scale) -> [(cache dict, key, bytes)]
        self._group_bytes = {}          # (nl, scale) -> its planes' bytes when last held
        self._sequence, self._pos = [], 0
        self._dropped = set()           # (cache id, key) of the planes dropped
        self.evictions = 0      # signature groups dropped
        self.reencodes = 0      # planes encoded again after their group was dropped
        # the CUDA graphs (capture), one per signature and target level, and
        # the planes they read, pinned: (cache id, key) -> (cache, key,
        # bytes, the signature that pinned it)
        self._graphs = {}
        self._pinned = {}
        self._pin_sigs = set()
        self.graph_epoch = 0    # drop_graphs calls: a graph that pinned before one is stale
        self._stream = None     # the capture stream
        self._reads = None              # what the running bootstrap reads (_read)
        self._sig_planes = {}           # (nl, scale) -> what its last eager run read
        self.replays = 0        # graph replays, inside another graph too (count_replay)
        self.inlined = 0        # of which inside another graph (no launch of their own)
        # NTT calls the replayed graphs ran (what each recorded at capture)
        self.replayed_ntt = dict.fromkeys(ntt_kernel.RECORDED, 0)
        if self.wide:
            # from WIDE_SLOTS slots the primes need not pair to 2^60 (module
            # comment at WIDE_SLOTS)
            self.delta_bs = self._returning_scale()

    # ------------------------------------------------------------ helpers
    def encode_vec(self, vec, scale, nl):
        """Encoder.encode's planes, NTT'd, their residues taken on the
        device where the encoder's int64 branch applies
        (Evaluator.encoded_residues): a load's warm-up encodes thousands of
        diagonals."""
        enc = self.s.encoder
        planes = self.ev.encoded_residues(enc, enc._raw_coeffs(vec) * float(scale), range(nl))
        return self.ev.ntt(planes, list(range(nl)))

    def encode_const(self, c, scale, nl):
        key = (complex(c), float(scale), nl)
        pt = self._enc_cache.get(key)
        if pt is None:
            vec = np.full(self.s.ctx.config.n_slots, c, dtype=np.complex128)
            pt = self.encode_vec(vec, scale, nl)
            self._enc_cache[key] = pt
        self._read(self._enc_cache, key, pt)
        return pt

    def _read(self, cache, key, pt):
        """Note a plane the running bootstrap reads (the planes a graph of
        its signature would bake in)."""
        if self._reads is not None:
            self._reads[(id(cache), key)] = (cache, key, pt.nbytes)

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
        corr = upload(torch.from_numpy(qs - np.int64(self.q0)), c.device)
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

    def _evalmod(self, t1):
        """EvalMod: the Chebyshev fit of cos, then r double angles: y =
        sin(2*pi*t), the value m/q0 = y / (2*pi)."""
        y = self._eval_cheb_bsgs(t1, self._cheb_coeffs())
        for _ in range(self.cfg.r):
            y = y.square().double_val().add_const(-1.0)
        return y.scale_by(2.0 * np.pi)

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

    def cached_planes(self):
        """What the bootstrapper holds on the device besides keys: the
        plaintext diagonals of every CtS/StC level it has applied
        (SlotLinearTransform._pt, the last CtS level's pair once per input
        normalizer, `_cts_last`) and the constants (encode_const): counts
        and bytes. Encodes nothing."""
        diags = [pt for t in self._levels() for pt in t._pt_cache.values()]
        consts = list(self._enc_cache.values())
        return dict(diagonals=len(diags), diagonal_bytes=sum(p.nbytes for p in diags),
                    cts_last_normalizers=len(self._cts_last_cache) if self._cts else 0,
                    constants=len(consts), constant_bytes=sum(p.nbytes for p in consts))

    def rotation_steps(self):
        """The nonzero rotation steps of every CtS/StC level (the galois
        keys a bootstrap uses, besides the conjugation key), sorted. Builds
        the level stacks, encodes nothing and draws no key."""
        cts, stc_first, stc_rest = self._transforms()
        last = SlotLinearTransform(self, diags=self._cts_last_diags)
        levels = list(cts) + [last, stc_first[0]] + list(stc_rest)
        return sorted({st for t in levels for st in t.rotation_steps()})

    def rows_left(self):
        """The rows of the chain a bootstrap leaves: ModRaise lifts to all
        num_q rows, every CtS and StC level (ceil(log2 slots / radix) each
        way, dft_factor.build_levels) takes `rs`, and EvalMod what `_evalmod`
        takes, walked over levels and scales alone (_Level: the calls,
        branches and host scale arithmetic of `_bootstrap`; no data, no
        key). 8 of tpu_n16's 42 rows at radix 7, 12 at radix 8; 30 of
        tpu_n15b's 60 at radix 7."""
        t, per_way = self._cts_walk()
        return self._evalmod(t).nl - self.rs * per_way

    def _cts_walk(self):
        """(EvalMod's input after ModRaise and CoeffToSlot as a _Level, the
        CtS/StC levels each way)."""
        ctx = self.s.ctx
        logs = int(ctx.config.n_slots).bit_length() - 1
        per_way = -(-logs // self.cfg.radix)
        q0p = float(ctx.q_primes[0]) * float(ctx.q_primes[1])
        t = _Level(ctx.q_primes, self.rs, ctx.config.num_q, q0p * 2.0 ** -self.GAP_BITS)
        for _ in range(per_way):
            t = t.mul_const(None, self.delta_bs)        # SlotLinearTransform.apply
        return t, per_way

    def _returning_scale(self):
        """The working scale EvalMod returns to: its squarings take a scale
        s to s^2 / q_span, whose fixed point is the span, and the
        Chebyshev leaves and giants and the r double angles double any
        distance from it at every squaring. The nominal 2^60 is the span of
        tpu_n15b's balanced pairs; tpu_n16's 30-bit primes pair to spans
        of 2^59.78 to 2^59.93, from which EvalMod leaves 2^60 at 2^99 and
        SlotToCoeff's first plaintexts (encoded at its target * q_span /
        that) with too few bits. Bisected over the level walk (_Level: the
        same host arithmetic) to where EvalMod's output, less the 2*pi it
        folds in, comes back to the scale it started at."""
        def drift(bits):
            self.delta_bs = 2.0 ** bits
            t, _ = self._cts_walk()
            return math.log2(self._evalmod(t).scale / (2 * np.pi)) - bits

        lo, hi = math.log2(self.delta_bs) - 1, math.log2(self.delta_bs)
        for _ in range(64):
            mid = (lo + hi) / 2
            lo, hi = (lo, mid) if drift(mid) > 0 else (mid, hi)
        if abs(drift(hi)) > 1e-6:
            raise ValueError(f"EvalMod's scale returns nowhere within a bit below "
                             f"2^{math.log2(self.delta_bs):.0f}: the drift is {drift(hi)} bits")
        return 2.0 ** hi

    # EvalMod input geometry: pre-upscale the input so delta'/q0' ~ 2^-GAP_BITS
    # (HEaaN: logq0 60, logDelta 51). Larger gap -> worse sin linearization;
    # smaller gap -> EvalMod's absolute error is amplified by q0'/delta'.
    GAP_BITS = 9

    # ------------------------------------------------ the bound on planes
    def set_plane_budget(self, nbytes, sequence=None):
        """Bound the plaintext planes the bootstrapper keeps (diagonals and
        constants, cached_planes) to `nbytes` (None: no bound). Once a
        `sequence` is given (the request's signatures in order, repeating),
        the planes a bootstrap encodes first belong to its input signature
        (rows, scale): past the bound, whole signatures' planes are dropped
        before a bootstrap of another signature runs, the one whose next
        use in the sequence lies furthest ahead (Belady's rule, as the
        executor plans its key arena); the running signature's always stay.
        A dropped plane is encoded again at its next use under the same
        cache key, so every output is unchanged (`reencodes` counts them).
        The planes a CUDA graph reads are pinned (capture): they count
        against the bound and are never dropped. With a sequence, the
        graphs are dropped first (drop_graphs) and then the planes held
        outside any signature's group (bootstraps run before one); a bound
        below the planes held drops groups now, by the same rule (_evict):
        all but the group of the planned sequence's next signature, which
        its bootstrap would hold again at once. So between requests the
        planes held may pass the bound by that one group."""
        if sequence is not None:
            self.drop_graphs()
            grouped = {(id(c), k) for g in self._groups.values() for c, k, _ in g}
            for key, cache in self._plane_entries().items():
                if key not in grouped:
                    del cache[key[1]]
                    self._dropped.add(key)
            self._sequence = [(int(nl), float(sc)) for nl, sc in sequence]
            self._pos = 0
        self.plane_budget = nbytes
        if nbytes is not None:
            self._evict(nbytes)

    def _levels(self):
        """Every CtS/StC level built so far (the last CtS pair once per
        input normalizer)."""
        if self._cts is None:
            return []
        return (list(self._cts) + [t for pair in self._cts_last_cache.values() for t in pair]
                + list(self._stc_first) + list(self._stc))

    def _plane_entries(self):
        """{(cache id, key): cache dict} of every plane held, the levels'
        diagonals and the constants."""
        out = {(id(t._pt_cache), k): t._pt_cache for t in self._levels() for k in t._pt_cache}
        out.update({(id(self._enc_cache), k): self._enc_cache for k in self._enc_cache})
        return out

    def _next_use(self, sig):
        """Bootstraps from the current one to sig's next in the sequence."""
        seq = self._sequence
        for k in range(len(seq)):
            if seq[(self._pos + k) % len(seq)] == sig:
                return k
        return len(seq)

    def _evict(self, limit):
        """Drop whole signature groups, the furthest next use first, until
        the planes held, the pinned ones first, take at most `limit`
        bytes. The group of the planned sequence's next signature stays:
        its bootstrap, the next to run, would encode it again at once."""
        held = (sum(b for g in self._groups.values() for _, _, b in g)
                + sum(p[2] for p in self._pinned.values()))
        keep = self._sequence[self._pos:self._pos + 1]
        while held > limit:
            cands = [g for g in self._groups if g not in keep]
            if not cands:
                break
            victim = max(cands, key=self._next_use)
            for cache, key, b in self._groups.pop(victim):
                if cache.pop(key, None) is not None:
                    self._dropped.add((id(cache), key))
                held -= b
            self.evictions += 1

    def _make_room(self, sig):
        """Drop other signatures' planes until this one's fit the bound: as
        many bytes as its planes took when last held, for a signature not
        held before the fewest any signature took. A pinned signature's
        planes stay anyway."""
        if sig not in self._groups and sig not in self._pin_sigs:
            need = self._group_bytes.get(sig, min(self._group_bytes.values(), default=0))
            self._evict(self.plane_budget - need)

    def bootstrap(self, data, nl, scale, target_level):
        """Bootstrap int32 [2, >=nl, N] at nl rows to the chain of
        target_level: (data', (nl', scale')). The host bookkeeping runs here
        on every call: the count, and once a sequence is planned where the
        request is, room for the signature's planes under the bound, and
        the planes the call encodes kept as its input signature's group
        (set_plane_budget). The device work is `_bootstrap`, eagerly, or on
        the card the replay of the signature's CUDA graph where `capture`
        made one; a replay encodes nothing, so it leaves every count and
        cache as an eager call of a pinned signature does."""
        if nl < 2:
            raise ValueError(
                "native bootstrap needs the bottom prime pair (nl >= 2); "
                "the planner must not drop bootstrap operands below level "
                f"{2 // self.s.ctx.config.rescale_rows}")
        sig = (int(nl), float(scale))
        rec = self._graphs.get(sig + (int(target_level),))
        if rec is not None and not self._current(rec):
            raise RuntimeError(f"the CUDA graph of bootstrap signature {sig} reads keys "
                               "replaced since its capture: capture it again or drop_graphs()")
        self._enter(sig)
        if rec is not None:
            rec["inp"].copy_(data[:, :nl, :])
            rec["graph"].replay()
            self._replayed(rec["ntt"])
            self._leave(sig)
            return rec["out"].clone(), rec["meta"]
        seq = self._sequence
        before = self._plane_entries() if seq else {}
        self._reads = {}
        try:
            out = self._bootstrap(data, nl, scale, target_level)
        finally:
            self._sig_planes[sig], self._reads = self._reads, None
        after = self._plane_entries() if seq else {}
        self._leave(sig, after, [key for key in after if key not in before])
        return out

    def bootstrap_rows(self, data, nl, scale, target_level):
        """A boot window of a batch, int32 [B, 2, >=nl, N]: each row
        through `bootstrap` (on the card the replay of the signature's graph
        where there is one), the rows stacked: (data' [B, ...], (nl',
        scale')). The B bootstraps take one place of the planned sequence,
        the place of the request's bootstrap they repeat: each row starts
        where the first did, so the plane bound plans a batch as it plans a
        single request (without this the second row would look for the
        signature's next use in the sequence and move the request there)."""
        pos = self._pos
        rows = []
        for b in range(data.shape[0]):
            self._pos = pos
            rows.append(self.bootstrap(data[b], nl, scale, target_level))
        return torch.stack([out for out, _ in rows]), rows[0][1]

    def count_replay(self, nl, scale, ntt):
        """The host bookkeeping of one bootstrap of signature (nl, scale)
        that ran inside another CUDA graph (the executor's whole-program
        graph, which pinned the signature's planes), as `bootstrap` keeps it
        for a replay of its own graph: the count, the planned sequence's
        position, room under the bound, the replay and its recorded NTT
        calls `ntt`."""
        sig = (int(nl), float(scale))
        self._enter(sig)
        self._replayed(ntt)
        self.inlined += 1
        self._leave(sig)

    def _enter(self, sig):
        """Before a bootstrap of sig: the count, and once a sequence is
        planned, where the request is and room for sig's planes."""
        seq = self._sequence
        if seq:
            if sig in seq:                               # where the request is
                self._pos = (self._pos + self._next_use(sig)) % len(seq)
            if self.plane_budget is not None:
                self._make_room(sig)
        self.calls += 1

    def _replayed(self, ntt):
        self.replays += 1
        for k, v in ntt.items():
            self.replayed_ntt[k] += v

    def _leave(self, sig, after=None, new=()):
        """After a bootstrap of sig that encoded the planes `new` (keys of
        `after`, the planes held now): those kept as its group, and the
        sequence's position past it."""
        seq = self._sequence
        if seq:
            if new or sig not in self._pin_sigs:
                group = self._groups.setdefault(sig, [])
                group.extend((after[key], key[1], after[key][key[1]].nbytes) for key in new)
                self._group_bytes[sig] = sum(b for _, _, b in group)
            self.reencodes += sum(key in self._dropped for key in new)
            self._dropped.difference_update(new)
            self._pos = (self._pos + 1) % len(seq)

    # ----------------------------------------------------- CUDA graphs
    def _current(self, rec):
        """Whether a graph still reads the keys it was captured with."""
        keys = self.s.keys
        return (rec["keys"] is keys and rec["galois"] is keys.galois
                and rec["generation"] == keys.galois.generation and rec["conj"] is keys.conj)

    def capture_blocker(self):
        """Why no bootstrap can run as a CUDA graph now, or None: "cpu"
        (graphs are the card's), "key_budget" (the keys come through the
        key store's LRU, which frees what a graph would bake in) or "mesh"
        (the keys are split over a mesh and a key switch all-gathers).
        Which signatures the plane bound leaves room for is graph_plan's."""
        if self.s.device.type != "cuda":
            return "cpu"
        if self.s.keys.galois.budget is not None:
            return "key_budget"
        if self.ev.shard is not None:
            return "mesh"
        return None

    def graph_plan(self, sigs=(), budget=False):
        """{(nl, scale): None, or "dropped_group"} for each signature of the
        planned sequence and of `sigs` (without a sequence, also of each run
        so far: a signature run before the sequence was planned, by another
        program, runs in none of its requests): None where its bootstraps
        may run as a graph under the plane bound. A graph bakes
        in every plane its signature reads, so these stay pinned while it
        lives: without a bound every signature; under it the signatures,
        the most bootstraps first, while the pinned planes and what any
        other signature reads besides them (held while it runs) fit the
        bound. The planes are those of each signature's last eager run (a
        load's warm-up runs each). budget: a bound to plan under in place of
        the one set now (None: no bound)."""
        seq = self._sequence
        sigs = list(dict.fromkeys(seq + list(sigs) + ([] if seq else list(self._sig_planes))))
        if budget is False:
            budget = self.plane_budget
        if budget is None:
            return dict.fromkeys(sigs)
        planes = {s: self._sig_planes.get(s, {}) for s in sigs}
        size = lambda entries: sum(p[2] for p in entries.values())
        order = sorted(sigs, key=lambda s: (-seq.count(s), seq.index(s) if s in seq else len(seq)))
        pinned, chosen = {}, []
        for s in order:
            cand = {**pinned, **planes[s]}
            need = max((size({e: p for e, p in planes[t].items() if e not in cand})
                        for t in sigs if t != s and t not in chosen), default=0)
            if size(cand) + need <= budget:
                pinned, chosen = cand, chosen + [s]
        return {s: None if s in chosen else "dropped_group" for s in sigs}

    def warm(self, nl, scale, target_level):
        """One eager bootstrap of a signature without a graph over a zero
        input on the current stream (its keys, planes and the device caches
        made now), leaving the count and the request's position as they
        were."""
        zero = torch.zeros((2, nl, self.s.ctx.n), dtype=torch.int32, device=self.s.device)
        calls, pos = self.calls, self._pos
        try:
            # the class's method: a wrapper a caller set on the instance
            # (chip_smoke.py times bootstraps so) sees no warm-up
            NativeBootstrapper.bootstrap(self, zero, nl, scale, target_level)
        finally:
            self.calls, self._pos = calls, pos

    def capture(self, nl, scale, target_level, pool=None):
        """The CUDA graph of the signature's bootstrap, made now and replayed
        by every later `bootstrap` of it on the card: `_bootstrap` recorded
        over a static input, and the planes it read pinned (drop_graphs
        releases them). No upload from host memory may run under capture:
        a signature that ran eagerly since its keys were made (a load's
        warm-up) records at once, and where a plane the bound dropped or a
        device cache would fill under capture (UploadUnderCapture), or the
        signature never ran, an eager warm-up (`warm`) first fills the
        Evaluator's, the CRT lift's and the plane caches, and it records
        again. The capture's calls leave `calls` and the request's position
        as they were. A graph reads the keys it was captured with
        (`bootstrap` refuses it after a key is replaced). pool: the memory
        pool to capture into (the executor's segment graphs', graph by graph
        after them); the default a pool of its own. Raises if no graph can
        run (capture_blocker; the bound is the caller's to plan,
        graph_plan) or the capture fails. Returns the record: graph, inp,
        out, meta, the NTT calls recorded, warmup_s (0 where it recorded at
        once), capture_s (recording), instantiate_s, nodes and pool_bytes
        (the device memory the capture reserved)."""
        why = self.capture_blocker()
        if why is not None:
            raise RuntimeError(f"bootstrap signature {(nl, scale)} cannot run as a CUDA "
                               f"graph: {why}")
        key = (int(nl), float(scale), int(target_level))
        self._graphs.pop(key, None)
        dev = self.s.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        inp = torch.zeros((2, key[0], self.s.ctx.n), dtype=torch.int32, device=dev)

        def body():
            return self._bootstrap(inp, *key[:2], key[2])

        def reserved():
            # what torch.cuda.graph does as it starts: the device memory
            # reserved after it grows by what the capture takes
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            return torch.cuda.memory_reserved(dev)

        ntt0 = dict(ntt_kernel.RECORDED)
        t0 = time.perf_counter()
        rec, warmup_s, before = None, 0.0, reserved()
        if key[:2] in self._sig_planes and self._keys_ready():
            try:
                rec = graphs.record(body, self._stream, pool)
            except UploadUnderCapture:
                ntt_kernel.RECORDED.update(ntt0)     # the dropped recording's
        if rec is None:
            self.warm(*key)
            warmup_s = time.perf_counter() - t0
            before = reserved()
            rec = graphs.record(body, self._stream, pool)
        out, meta = rec["out"]
        keys = self.s.keys
        rec = dict(graph=rec["graph"], inp=inp, out=out, meta=meta, keys=keys,
                   galois=keys.galois, generation=keys.galois.generation, conj=keys.conj,
                   ntt={k: v - ntt0[k] for k, v in ntt_kernel.RECORDED.items()},
                   warmup_s=warmup_s, capture_s=rec["capture_s"],
                   instantiate_s=rec["instantiate_s"], nodes=rec["nodes"],
                   pool_bytes=torch.cuda.memory_reserved(dev) - before)
        self._pin(key[:2])
        self._graphs[key] = rec
        return rec

    def _keys_ready(self):
        """Whether every key a bootstrap reads is made (none is drawn under
        capture, where the draw would be lost)."""
        galois = self.s.keys.galois
        n_slots = self.s.ctx.config.n_slots
        return self.s.keys.conj is not None and all(
            st % n_slots in galois for st in self.rotation_steps())

    def _pin(self, sig):
        """Pin every plane the signature's last eager run read: out of its
        group, never dropped by the bound, until drop_graphs."""
        for entry, (cache, key, b) in self._sig_planes[sig].items():
            self._pinned.setdefault(entry, (cache, key, b, sig))
        self._pin_sigs.add(sig)
        for g, members in list(self._groups.items()):
            kept = [m for m in members if (id(m[0]), m[1]) not in self._pinned]
            if len(kept) < len(members):
                self._group_bytes[g] = sum(b for _, _, b in kept)
                if kept:
                    self._groups[g] = kept
                else:
                    del self._groups[g]

    def drop_graphs(self):
        """Free every graph; their pinned planes go back under the bound,
        each into the group of the signature that pinned it. `graph_epoch`
        counts the calls: a graph of another owner that pinned planes here
        (the executor's whole-program graph) is stale after one."""
        self._graphs.clear()
        self.graph_epoch += 1
        for cache, key, b, sig in self._pinned.values():
            if key in cache:
                self._groups.setdefault(sig, []).append((cache, key, b))
        for sig in self._pin_sigs:
            self._group_bytes[sig] = sum(b for _, _, b in self._groups.get(sig, ()))
        self._pinned.clear()
        self._pin_sigs.clear()

    def _bootstrap(self, data, nl, scale, target_level):
        """data: int32 [2, nl, N]; returns (data', (nl', scale')): the device
        work of a bootstrap (what a CUDA graph records), with the host
        arithmetic of its scales; the caches it fills are keyed by the
        input scale.

        `target_level` is in hevm levels (composite profiles expand it by
        rescale_rows). The input is dropped to the bottom prime PAIR
        (q0' = q0*q1 ~ 2^60) and pre-upscaled to delta' ~ q0' * 2^-GAP_BITS
        before the centered CRT raise — exact int ops, no level cost."""
        cfg = self.cfg
        s = self.s
        ctx = s.ctx
        delta = float(scale)
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

        v_re = self._evalmod(t1_re)
        v_im = self._evalmod(t1_im)     # identical op sequence -> same scale

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
        # The levels before the last land on target0 too (the reference),
        # or from WIDE_SLOTS slots on the working scale (module comment
        # there): the same depth, only their plaintexts' scales.
        targets = [target0] * (1 + len(stc_rest))
        if self.wide:
            targets[:-1] = [delta_bs] * (len(targets) - 1)
        out = stc_first[0].apply(v_re, targets[0]).add(
            stc_first[1].apply(v_im, targets[0]))
        for t, target in zip(stc_rest, targets[1:]):
            out = t.apply(out, target)

        nl2 = (target_level + 1) * ctx.config.rescale_rows
        assert out.nl >= nl2, (
            f"bootstrap consumed too many levels: have {out.nl}, need {nl2}")
        res = out.data[:, :nl2, :]
        return res, (nl2, scale_orig)
