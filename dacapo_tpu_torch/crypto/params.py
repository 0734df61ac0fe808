"""CKKS context: parameter profiles and precomputed RNS tables.

The reference delegates all of this to SEAL/HEaaN (`create_context`,
lib/Runtime/SEAL_HEVM.cpp:44-89). Here we own it: primes, NTT twiddle tables,
hybrid key-switching decomposition constants, rescale/moddown constants, and
Galois/slot permutation tables — all precomputed host-side with python ints and
shipped to the device as int32 tensors holding the uint32 bits (every residue
is below 2^31). PyTorch port of dacapo_tpu/crypto/params.py.

Layout conventions
------------------
* RNS planes: uint32 [num_rows, N]; rows 0..num_q-1 are the Q chain (descending
  prime size, so row num_q-1 is dropped first by rescale), rows num_q.. are the
  `alpha` special primes P used only inside key-switching.
* A ciphertext "nl" = number of active Q rows (hevm level = nl-1).
* Everything on device lives permanently in NTT (evaluation) representation;
  key-switch / rescale dip into coefficient representation internally.

Hybrid key-switching (dnum digits, alpha special primes):
  evk_j encrypts  P * Q̂_j^{full} * key  (Q̂_j^{full} = Q_full / Q_j_full), and
  at level nl the digit for group j is corrected per-residue so that
  Σ_j D_j * Q̂_j^{full} ≡ c (mod Q^{(nl)}):  D_j ≡ c_g * (Q̂_j^{full})^{-1} (mod q_g).
  Digits are lifted with approximate (no flooring-correction) base conversion;
  the extra multiples of the group modulus vanish mod PQ and only add O(e)
  noise after ModDown.
"""

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from .primes import gen_ntt_primes, primitive_root_2n, bit_reverse
from .modmath import host_shoup, host_qinv_neg


def resolve_device(device=None) -> torch.device:
    """The port's device policy: CUDA unless the caller names the CPU.
    There is no silent fallback: asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dacapo_tpu_torch: CUDA requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_dev(arr, device) -> torch.Tensor:
    """Host uint32 (or int32) array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype != np.int32:
        raise TypeError(f"residue planes must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def to_host(t) -> np.ndarray:
    """int32 tensor -> host uint32 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


@dataclass(frozen=True)
class CKKSConfig:
    """Static CKKS parameter set (a "profile" in reference terms)."""

    n: int = 1 << 15              # ring degree N (slots = N/2)
    num_q: int = 14               # ciphertext prime chain length (levels 0..num_q-1)
    alpha: int = 7                # special primes / digit width for key-switching
    prime_bits: int = 30          # size of each RNS prime (< 31)
    scale_bits: int = 25          # default encoding scale (waterline analog)
    seed: int = 2024              # keygen/encrypt RNG seed (testing determinism)
    secret_h: int = 0             # ternary secret Hamming weight (0 = dense).
    #   Bootstrappable profiles use a sparse secret so the ModRaise integer
    #   part I stays within the EvalMod range K (HEaaN-style sparse keys;
    #   sigma(I) ~ sqrt(h/12), so h=192 keeps |I| < 25 w.h.p.).
    native_bootstrap: bool = False  # runner auto-enables NativeBootstrapper
    #   (CtS/EvalMod/StC pipeline) instead of the decrypt/re-encrypt oracle;
    #   requires a chain deep enough for the ~30-row pipeline.
    rescale_rows: int = 1         # RNS rows dropped per rescale level.
    #   1: classic single-prime rescale (rf = prime_bits).
    #   2: composite rescale over balanced prime PAIRS (rf = 2*prime_bits):
    #      pairs q_a*q_b are chosen within ~1e-4 bits of 2^rf, recovering
    #      SEAL-60-bit scale exactness with u32 limbs (primes.py
    #      gen_balanced_pairs). One compiler "level" = 2 RNS rows.

    @property
    def dnum(self) -> int:
        return -(-self.num_q // self.alpha)

    @property
    def rf_bits(self) -> int:
        """Rescaling factor in bits (compiler rescalingFactor analog)."""
        return self.prime_bits * self.rescale_rows

    @property
    def num_levels(self) -> int:
        """Compiler levels in the chain (= num_q when rescale_rows == 1)."""
        assert self.num_q % self.rescale_rows == 0
        return self.num_q // self.rescale_rows

    @property
    def n_slots(self) -> int:
        return self.n // 2

    @property
    def num_all(self) -> int:
        return self.num_q + self.alpha


# Profiles analogous to the reference's profiled_{SEAL,HEAAN}_{CPU,GPU}.json.
#
# SECURITY. 128-bit RLWE security caps log2(QP) per ring degree (HE standard
# ternary-secret table): N=2^14 -> ~440 bits, N=2^15 -> ~880, N=2^16 -> ~1770.
# Profiles marked PARITY below EXCEED the cap for their N — they exist to
# reproduce the reference benchmark regimes (SEAL's 14x60-bit chain plus our
# key-switching specials) at matching slot counts and are NOT for production
# use; deploy the *_sec variants (or tpu_n16) instead. `CKKSContext.logqp`
# reports the actual modulus size.
PROFILES = {
    # PARITY profile (insecure: logQP ~ 1057 > 880). Reference SEAL regime:
    # N=2^15, 14 levels of Delta=2^60 (profiled_SEAL_CPU.json:2-8,
    # SEAL_HEVM.cpp:39-53). Composite rescale: 28 u32 rows = 14 levels of
    # rf=60, waterline-40 programs match the reference's `hbt dacapo 40 ...`
    # regime with SEAL-class scale exactness.
    "tpu_n15": CKKSConfig(n=1 << 15, num_q=28, alpha=7, prime_bits=30,
                          scale_bits=40, rescale_rows=2),
    # keyswitch-cost variant of tpu_n15: alpha=14 -> dnum=2 digit groups.
    # Inner-product rows per keyswitch drop 4*2*(28+7)=280 -> 2*2*(28+14)=168
    # and galois keys shrink 37->22 MiB; ModUp digit products (<=14 q-primes,
    # ~2^420) stay under P (14 specials just below 2^31, ~2^433) so the
    # approximate-ModUp noise bound still holds. Same q-chain as tpu_n15 ->
    # compiled artifacts are interchangeable.
    "tpu_n15a14": CKKSConfig(n=1 << 15, num_q=28, alpha=14, prime_bits=30,
                             scale_bits=40, rescale_rows=2),
    # 128-bit-secure N=2^15 variant: logQP ~ 817 <= 880 (10 levels of rf=60).
    "tpu_n15_sec": CKKSConfig(n=1 << 15, num_q=20, alpha=7, prime_bits=30,
                              scale_bits=40, rescale_rows=2),
    # bootstrap-capable profile (reference HEaaN FVa-class; config.json:2-6).
    # logQP = (42+14)*30 = 1680 <= 1770 at N=2^16: 128-bit secure. The chain
    # budgets the native bootstrapper's pair-composite pipeline (~32 rows:
    # CtS/StC radix-8 + Chebyshev EvalMod) plus program levels above it.
    "tpu_n16": CKKSConfig(n=1 << 16, num_q=42, alpha=14, prime_bits=30,
                          scale_bits=28, secret_h=192, native_bootstrap=True),
    # PARITY-class bootstrap-capable composite profile (insecure dev, like
    # tpu_n15): SEAL-regime rf=60/waterline-40 programs with enough chain
    # for native (non-oracle) bootstrapping. 30 levels total; the pipeline
    # consumes exactly 15 (30 rows, radix-7 CtS/StC + deg-36 EvalMod), so
    # the PROGRAM chain top — the reference's levelUpperBound, where every
    # bootstrap lands (EarthOps.td processResultsEVA switchLevel(0)) — is
    # level 14.
    "tpu_n15b": CKKSConfig(n=1 << 15, num_q=60, alpha=15, prime_bits=30,
                           scale_bits=40, rescale_rows=2, secret_h=192,
                           native_bootstrap=True),
    # PARITY profile (insecure: logQP ~ 604 > 440): N=2^14-class traces
    # (reference hc-test SEAL runs trace at nt=2^14)
    "tpu_n14": CKKSConfig(n=1 << 14, num_q=16, alpha=4, prime_bits=30,
                          scale_bits=40, rescale_rows=2),
    # insecure tiny profiles for unit tests
    "test_n8": CKKSConfig(n=1 << 8, num_q=6, alpha=3, prime_bits=30, scale_bits=25),
    "test_n10": CKKSConfig(n=1 << 10, num_q=8, alpha=4, prime_bits=30, scale_bits=25),
    "test_n11": CKKSConfig(n=1 << 11, num_q=8, alpha=4, prime_bits=30, scale_bits=25),
    # insecure tiny bootstrap-capable profile (deep chain + sparse secret);
    # chain sized for the pair-composite native pipeline (~32 rows deep)
    "test_boot": CKKSConfig(n=1 << 11, num_q=36, alpha=9, prime_bits=30,
                            scale_bits=25, secret_h=64),
    # insecure tiny composite-rescale profile (unit tests for rescale_rows=2)
    "test_n11c": CKKSConfig(n=1 << 11, num_q=16, alpha=4, prime_bits=30,
                            scale_bits=40, rescale_rows=2),
    # insecure CPU error-budget sandbox: the flagship tpu_n15 regime
    # (14x60-bit composite levels, waterline-40 programs) at N=2^12 so a
    # full ResNet runs on CPU in minutes
    "test_n12c": CKKSConfig(n=1 << 12, num_q=28, alpha=7, prime_bits=30,
                            scale_bits=40, rescale_rows=2),
}

# crypto profile name -> compiler profile json (dacapo_tpu_torch/profiles/)
COMPILER_PROFILES = {
    "tpu_n15": "profiled_TPU_n15",
    "tpu_n15a14": "profiled_TPU_n15",     # same chain/levels as tpu_n15
    "tpu_n15_sec": "profiled_TPU_n15_sec",
    "tpu_n16": "profiled_TPU_n16",
    "tpu_n15b": "profiled_TPU_n15b",
    "tpu_n14": "profiled_TPU_n14",
    "test_n10": "profiled_TPU_test_n10",
    "test_n11": "profiled_TPU_test_n11",
    "test_boot": "profiled_TPU_test_boot",
    "test_n11c": "profiled_TPU_test_n11c",
    "test_n12c": "profiled_TPU_test_n12c",
}


def _shoup_arr(vals, qs):
    """uint32 arrays (val, shoup) for constant-lists vals against moduli qs."""
    v = np.array(vals, dtype=np.uint32)
    s = np.array([host_shoup(int(w), int(q)) for w, q in zip(vals, qs)], dtype=np.uint32)
    return v, s


@dataclass
class GroupConsts:
    """Per-(level, digit-group) key-switch constants."""

    rows: list                      # active global Q rows in this group
    t_coef: np.ndarray              # [g] coeff-domain digit consts (with shoup)
    t_coef_shoup: np.ndarray
    s_ntt: np.ndarray               # [g] NTT-domain own-plane consts (with shoup)
    s_ntt_shoup: np.ndarray
    targets: list                   # global rows (Q-other + specials) to extend into
    m: np.ndarray                   # [g, len(targets)] basis-conversion consts
    m_shoup: np.ndarray


@dataclass
class LevelConsts:
    """All level-dependent constants for nl active Q primes."""

    nl: int
    groups: list                    # list[GroupConsts]
    # ModDown P -> Q^{(nl)}
    md_t: np.ndarray                # [alpha] (with shoup) per special prime
    md_t_shoup: np.ndarray
    md_m: np.ndarray                # [alpha, nl]
    md_m_shoup: np.ndarray
    pinv: np.ndarray                # [nl] P^{-1} mod q_i (with shoup)
    pinv_shoup: np.ndarray
    # Rescale (drop row nl-1)
    rs_half: int                    # q_top // 2
    rs_diff: np.ndarray             # [nl-1] q_i - q_top  (centered-lift correction)
    rs_inv: np.ndarray              # [nl-1] q_top^{-1} mod q_i (with shoup)
    rs_inv_shoup: np.ndarray


class CKKSContext:
    """Precomputed tables + device plane tables for one parameter set."""

    def __init__(self, config: CKKSConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        n = config.n
        if config.rescale_rows == 2:
            # composite-rescale chain: balanced pairs, best pair at the
            # bottom (rows 2k, 2k+1 form pair k; top pair dropped first)
            from .primes import gen_balanced_pairs
            self.q_primes = gen_balanced_pairs(n, config.num_q // 2,
                                               config.prime_bits)
            # specials just below 2^31 (bigger P -> smaller ModUp noise)
            self.p_primes = gen_ntt_primes(n, config.alpha, 31,
                                           skip=self.q_primes)
        else:
            chain = gen_ntt_primes(n, config.num_all, config.prime_bits)
            # Largest primes become the special modulus P (must dominate any
            # digit group product for the approximate-ModUp noise bound).
            self.p_primes = chain[: config.alpha]
            self.q_primes = chain[config.alpha:]
        self.primes = self.q_primes + self.p_primes  # row order
        self.n = n
        self.logn = n.bit_length() - 1
        # total modulus size in bits (the RLWE security budget; see PROFILES)
        self.logqp = sum(p.bit_length() for p in self.primes)

        self._build_ntt_tables()
        self._build_level_consts()
        self._build_galois_tables()
        self._rot_perm_cache = {}
        self._col_cache = {}     # crt_lift._col: int64 constant columns

    # ------------------------------------------------------------------ NTT
    def _build_ntt_tables(self):
        n, logn = self.n, self.logn
        P = len(self.primes)
        tw = np.zeros((P, n), dtype=np.uint32)
        tws = np.zeros((P, n), dtype=np.uint32)
        itw = np.zeros((P, n), dtype=np.uint32)
        itws = np.zeros((P, n), dtype=np.uint32)
        ninv = np.zeros((P,), dtype=np.uint32)
        ninvs = np.zeros((P,), dtype=np.uint32)
        self.psis = []
        brv = np.array([bit_reverse(i, logn) for i in range(n)], dtype=np.int64)

        def shoup_vec(w, q):  # w int64 < 2^31 -> floor(w<<32 / q), fits int64
            return ((w.astype(np.int64) << 32) // q).astype(np.uint32)

        for r, q in enumerate(self.primes):
            psi = primitive_root_2n(q, n)
            self.psis.append(psi)
            psi_inv = pow(psi, -1, q)
            pows = np.ones(n, dtype=np.int64)
            ipows = np.ones(n, dtype=np.int64)
            for i in range(1, n):
                pows[i] = pows[i - 1] * psi % q
                ipows[i] = ipows[i - 1] * psi_inv % q
            fw = pows[brv]
            iv = ipows[brv]
            tw[r] = fw.astype(np.uint32)
            tws[r] = shoup_vec(fw, q)
            itw[r] = iv.astype(np.uint32)
            itws[r] = shoup_vec(iv, q)
            nv = pow(n, -1, q)
            ninv[r] = nv
            ninvs[r] = host_shoup(nv, q)
        qs = np.array(self.primes, dtype=np.uint32)
        # compact-plaintext decode constants: Barrett m32 = floor(2^32/q)
        # and the 2^k mod q table (Encoder.encode_compact_batch exponents)
        pow2 = np.zeros((P, 256), dtype=np.uint32)
        for r, q in enumerate(self.primes):
            v = 1
            for k in range(256):
                pow2[r, k] = v
                v = (v * 2) % q
        self.host_tables = dict(
            q=qs,
            qinv_neg=np.array([host_qinv_neg(q) for q in self.primes], dtype=np.uint32),
            rconst=np.array([(1 << 32) % q for q in self.primes], dtype=np.uint32),
            rconst_shoup=np.array(
                [host_shoup((1 << 32) % q, q) for q in self.primes], dtype=np.uint32
            ),
            m32=np.array([(1 << 32) // q for q in self.primes], dtype=np.uint32),
            pow2=pow2,
            tw=tw, tw_shoup=tws, itw=itw, itw_shoup=itws,
            ninv=ninv, ninv_shoup=ninvs,
        )

    @cached_property
    def dev(self):
        """The NTT tables and per-prime scalars as int32 tensors on
        `self.device` (the bits of the host uint32 arrays)."""
        return {k: to_dev(self.host_tables[k], self.device)
                for k in ("q", "ninv", "ninv_shoup",
                          "tw", "tw_shoup", "itw", "itw_shoup")}

    # ------------------------------------------------------- level constants
    def _build_level_consts(self):
        cfg = self.config
        alpha = cfg.alpha
        p_prod = 1
        for p in self.p_primes:
            p_prod *= p
        self.p_prod = p_prod
        q_full = 1
        for q in self.q_primes:
            q_full *= q
        self.q_full = q_full

        # full-Q group moduli for the fixed partition
        groups_full = [
            list(range(j * alpha, min((j + 1) * alpha, cfg.num_q)))
            for j in range(cfg.dnum)
        ]
        qj_full = []
        for rows in groups_full:
            m = 1
            for r in rows:
                m *= self.q_primes[r]
            qj_full.append(m)

        self.levels = []
        for nl in range(1, cfg.num_q + 1):
            active = list(range(nl))
            groups = []
            for j, rows_full in enumerate(groups_full):
                rows = [r for r in rows_full if r < nl]
                if not rows:
                    continue
                g_prod = 1
                for r in rows:
                    g_prod *= self.q_primes[r]
                qhat_j = q_full // qj_full[j]      # Q̂_j^{full}
                targets = [r for r in active if r not in rows] + [
                    cfg.num_q + i for i in range(alpha)
                ]
                t_coef, s_ntt = [], []
                for r in rows:
                    q = self.q_primes[r]
                    inv_qhat = pow(qhat_j % q, -1, q)
                    ghat = g_prod // q              # G_j / q_r
                    t_coef.append(inv_qhat * pow(ghat % q, -1, q) % q)
                    s_ntt.append(inv_qhat)
                m = np.zeros((len(rows), len(targets)), dtype=np.uint32)
                ms = np.zeros_like(m)
                for gi, r in enumerate(rows):
                    ghat = g_prod // self.q_primes[r]
                    for ti, tr in enumerate(targets):
                        tq = self.primes[tr]
                        m[gi, ti] = ghat % tq
                        ms[gi, ti] = host_shoup(ghat % tq, tq)
                tc, tcs = _shoup_arr(t_coef, [self.q_primes[r] for r in rows])
                sn, sns = _shoup_arr(s_ntt, [self.q_primes[r] for r in rows])
                groups.append(GroupConsts(rows, tc, tcs, sn, sns, targets, m, ms))

            # ModDown P -> Q^{(nl)}
            md_t = []
            for g, p in enumerate(self.p_primes):
                phat = p_prod // p
                md_t.append(pow(phat % p, -1, p))
            md_m = np.zeros((alpha, nl), dtype=np.uint32)
            md_ms = np.zeros_like(md_m)
            for g, p in enumerate(self.p_primes):
                phat = p_prod // p
                for i in range(nl):
                    q = self.q_primes[i]
                    md_m[g, i] = phat % q
                    md_ms[g, i] = host_shoup(phat % q, q)
            mdt, mdts = _shoup_arr(md_t, self.p_primes)
            pinv = [pow(p_prod % self.q_primes[i], -1, self.q_primes[i]) for i in range(nl)]
            pv, pvs = _shoup_arr(pinv, self.q_primes[:nl])

            # Rescale: drop row nl-1. The dropped prime is not necessarily
            # the smallest active one (balanced-pair chains), so the
            # centered-lift correction is (q_i - q_top mod q_i) mod q_i and
            # the kernel reduces v mod q_i first (ops._rescale).
            if nl >= 2:
                qt = self.q_primes[nl - 1]
                rs_diff = np.array(
                    [(self.q_primes[i] - qt % self.q_primes[i]) % self.q_primes[i]
                     for i in range(nl - 1)], dtype=np.uint32
                )
                rs_inv = [pow(qt, -1, self.q_primes[i]) for i in range(nl - 1)]
                ri, ris = _shoup_arr(rs_inv, self.q_primes[: nl - 1])
                half = qt // 2
            else:
                rs_diff = np.zeros((0,), dtype=np.uint32)
                ri = ris = np.zeros((0,), dtype=np.uint32)
                half = 0

            self.levels.append(
                LevelConsts(nl, groups, mdt, mdts, md_m, md_ms, pv, pvs,
                            half, rs_diff, ri, ris)
            )

    def level(self, nl: int) -> LevelConsts:
        return self.levels[nl - 1]

    # ------------------------------------------------------------- galois
    def _build_galois_tables(self):
        """Recover the NTT output point ordering via discrete log, once.

        The forward NTT evaluates at ψ^{e_i} for some index-dependent odd
        exponent pattern e_i (identical across primes by construction). We
        recover e_i by running a host NTT on the monomial X and taking
        discrete logs in <ψ>.
        """
        n, logn = self.n, self.logn
        q = self.primes[0]
        psi = self.psis[0]
        x = np.zeros(n, dtype=np.int64)
        x[1] = 1
        vals = _host_ntt(x, q, self.host_tables["tw"][0].astype(np.int64))
        dlog = {}
        acc = psi  # ψ^1
        step = psi * psi % q  # ψ^2
        for e in range(1, 2 * n, 2):
            dlog[acc] = e
            acc = acc * step % q
        self.eval_exps = np.array([dlog[int(v)] for v in vals], dtype=np.int64)
        self.exp_to_idx = {int(e): i for i, e in enumerate(self.eval_exps)}

    def rot_perm(self, steps: int) -> np.ndarray:
        """Slot-rotation permutation in NTT domain: new[i] = old[perm[i]].

        Left-rotation by `steps` slots == automorphism X -> X^{5^steps}.
        """
        steps = steps % (self.n // 2)
        if steps in self._rot_perm_cache:
            return self._rot_perm_cache[steps]
        two_n = 2 * self.n
        g = pow(5, steps, two_n)
        perm = np.array(
            [self.exp_to_idx[(int(e) * g) % two_n] for e in self.eval_exps],
            dtype=np.int32,
        )
        self._rot_perm_cache[steps] = perm
        return perm

    def galois_elt(self, steps: int) -> int:
        return pow(5, steps % (self.n // 2), 2 * self.n)

    # ---------------------------------------------------- orbit layout
    # Device NTT-domain planes are stored in ORBIT ORDER: position j holds
    # the evaluation at psi^(5^j mod 2N) and position s+j at psi^(-5^j)
    # (s = N/2 slots). In this layout the slot-rotation automorphism is a
    # cyclic ROLL of each half by -steps and conjugation is a half swap —
    # pure data movement at copy bandwidth, instead of the arbitrary
    # dynamic gathers that dominated the conv superops on TPU (XLA lowers
    # lane-axis gathers ~2 orders below roofline). The fixed reorder is
    # applied once inside every forward/inverse NTT (ops.Evaluator._ntt),
    # which the hoisted-ModUp structure already amortizes across all
    # rotations of a bank.
    @cached_property
    def orbit_perm(self) -> np.ndarray:
        """y_orbit = y_kernel[orbit_perm] (int32 [N])."""
        two_n = 2 * self.n
        s = self.n // 2
        idx = np.empty(self.n, dtype=np.int32)
        e = 1
        for j in range(s):
            idx[j] = self.exp_to_idx[e]
            idx[s + j] = self.exp_to_idx[two_n - e]
            e = (e * 5) % two_n
        return idx

    @cached_property
    def orbit_inv(self) -> np.ndarray:
        """y_kernel = y_orbit[orbit_inv]."""
        inv = np.empty(self.n, dtype=np.int32)
        inv[self.orbit_perm] = np.arange(self.n, dtype=np.int32)
        return inv

    @cached_property
    def conj_perm(self) -> np.ndarray:
        """Conjugation automorphism X -> X^{-1} as an NTT-point permutation
        (slot effect: z -> conj(z); galois element 2N-1)."""
        two_n = 2 * self.n
        return np.array(
            [self.exp_to_idx[(two_n - int(e)) % two_n] for e in self.eval_exps],
            dtype=np.int32,
        )


def _host_ntt(x, q, tw):
    """Host mirror of the device forward NTT (int64 numpy; table building and
    tests only — products < 2^62 fit int64)."""
    n = len(x)
    a = x.astype(np.int64).copy()
    m = 1
    while m < n:
        a = a.reshape(m, 2, n // (2 * m))
        w = tw[m: 2 * m].reshape(m, 1)
        u = a[:, 0, :]
        v = a[:, 1, :] * w % q
        a = np.stack([(u + v) % q, (u - v + q) % q], axis=1).reshape(-1)
        m *= 2
    return a
