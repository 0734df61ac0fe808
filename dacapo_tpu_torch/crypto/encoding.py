"""CKKS encoding/decoding: slots <-> RNS coefficient planes (host side).

Copy of dacapo_tpu/crypto/encoding.py (host numpy; no device code).

Replaces seal::CKKSEncoder (used by reference runtime encode_internal,
lib/Runtime/SEAL_HEVM.cpp:256-267). The canonical-embedding FFT runs in
numpy complex128 on the host; only integer RNS planes ever reach the device.

Slot mapping: slot j <-> evaluation point ζ^{5^j mod 2N} (ζ = e^{iπ/N}),
conjugate pair at ζ^{-5^j}. With k = 2r+1, m(ζ^k) = N·ifft(c·ψ_t)[r] where
ψ_t = e^{iπt/N}; so encode is conj-symmetric placement + fft + untwist.
"""

import numpy as np

# Scaled coefficients below this round to int64 and reduce prime by prime;
# larger ones take the float64 mantissa/exponent split (_rns_residues).
INT64_BOUND = 2 ** 62


class Encoder:
    def __init__(self, ctx):
        self.ctx = ctx
        n = ctx.n
        self.n = n
        self.n_slots = n // 2
        t = np.arange(n)
        self.twist = np.exp(1j * np.pi * t / n)         # e^{iπt/N}
        # slot j -> DFT bin r_j = (5^j - 1)/2 mod N ; conj bin for -5^j
        exps = np.empty(self.n_slots, dtype=np.int64)
        g = 1
        for j in range(self.n_slots):
            exps[j] = g
            g = (g * 5) % (2 * n)
        self.slot_bins = ((exps - 1) // 2) % n
        self.conj_bins = ((2 * n - exps - 1) // 2) % n

    # ----------------------------------------------------------- encode
    def coeffs_from_values(self, values: np.ndarray, scale: float) -> np.ndarray:
        """Slot values (len <= n_slots; cyclically replicated like the
        reference encode_internal) -> integer coefficient vector (int64).

        Accepts real or complex slot vectors; the spectrum is made
        conjugate-symmetric by construction, so the polynomial coefficients
        are always real (complex slots are first-class in CKKS — the
        bootstrap linear transforms rely on this).
        """
        v = np.asarray(values)
        v = v.ravel().astype(
            np.complex128 if np.iscomplexobj(v) else np.float64)
        full = v[np.arange(self.n_slots) % len(v)].astype(np.complex128)
        spec = np.zeros(self.n, dtype=np.complex128)
        spec[self.slot_bins] = full
        spec[self.conj_bins] += np.conj(full)           # += handles n=2 overlap
        d = np.fft.fft(spec) / self.n
        coeffs = np.real(d * np.conj(self.twist)) * scale
        m = np.abs(coeffs).max() if coeffs.size else 0.0
        assert m < 2 ** 62, "encoding overflow: scale too large for int64 coeffs"
        return np.round(coeffs).astype(np.int64)

    def _raw_coeffs(self, values: np.ndarray) -> np.ndarray:
        """Slot values -> unscaled real polynomial coefficients (float64)."""
        v = np.asarray(values)
        v = v.ravel().astype(
            np.complex128 if np.iscomplexobj(v) else np.float64)
        full = v[np.arange(self.n_slots) % len(v)].astype(np.complex128)
        spec = np.zeros(self.n, dtype=np.complex128)
        spec[self.slot_bins] = full
        spec[self.conj_bins] += np.conj(full)
        d = np.fft.fft(spec) / self.n
        return np.real(d * np.conj(self.twist))

    def _rns_residues(self, prod: np.ndarray, nl: int, primes=None) -> np.ndarray:
        """float64 [..., N] scaled coefficients -> uint32 [..., R, N] planes
        over `primes` (default: the first nl Q primes; pass an explicit list
        for extended-basis encodes, e.g. Q^{(nl)}P plaintexts for the lazy-
        ModDown fused conv path).

        High-scale plans (waterline chains put encode scales at 100+ bits,
        e.g. SEAL Delta=2^60 + upscales; reference encode_internal handles
        this via SEAL's big-int encoder) exceed int64 coefficients, so the
        residues are computed from the float64 mantissa/exponent split:
        c = mi * 2^k with |mi| <= 2^53, so c mod q = (mi mod q) * (2^k mod q)
        — every product stays under 2^62 in int64. Precision equals the
        float64 relative precision of the coefficient, same as the input.
        """
        primes = list(self.ctx.q_primes[:nl]) if primes is None else list(primes)
        lead = prod.shape[:-1]
        amax = np.abs(prod).max() if prod.size else 0.0
        out = np.empty(lead + (len(primes), self.n), dtype=np.uint32)
        if amax < INT64_BOUND:
            c = np.round(prod).astype(np.int64)
            for i, q in enumerate(primes):
                out[..., i, :] = np.mod(c, q)
            return out
        if not np.isfinite(amax):
            raise OverflowError("encode: scale overflows float64 range")
        mant, ex = np.frexp(prod)
        mi = np.round(mant * 2.0 ** 53).astype(np.int64)   # prod = mi * 2^k
        k = (ex - 53).astype(np.int64)
        small = k < 0                                      # |prod| < 2^53
        c_small = np.round(np.where(small, prod, 0.0)).astype(np.int64)
        kmax = int(k.max())
        kc = np.clip(k, 0, None)
        for i, q in enumerate(primes):
            q = int(q)
            powtab = np.empty(kmax + 1, dtype=np.int64)
            powtab[0] = 1
            for j in range(1, kmax + 1):
                powtab[j] = (powtab[j - 1] * 2) % q
            r_big = (mi % q) * powtab[kc] % q
            r_small = c_small % q
            out[..., i, :] = np.where(small, r_small, r_big)
        return out

    def encode(self, values, scale: float, nl: int) -> np.ndarray:
        """-> uint32 [nl, N] coefficient-domain RNS planes (caller NTTs)."""
        return self._rns_residues(self._raw_coeffs(values) * scale, nl)

    def encode_batch(self, values_list, scales, nl: int,
                     primes=None) -> np.ndarray:
        """Encode B payloads at once -> uint32 [B, R, N].

        One vectorized FFT over the whole batch instead of B separate calls —
        the reference preprocess() encodes constants one at a time
        (lib/Runtime/SEAL_HEVM.cpp:242-267); CNN plans have thousands, so the
        batched path is what makes load-time preprocessing seconds-scale.
        """
        return self._rns_residues(self.scaled_coeffs_batch(values_list, scales), nl,
                                  primes=primes)

    def scaled_coeffs_batch(self, values_list, scales) -> np.ndarray:
        """The float64 [B, N] scaled coefficients encode_batch reduces."""
        b = len(values_list)
        full = np.empty((b, self.n_slots), dtype=np.complex128)
        ar = np.arange(self.n_slots)
        for i, v in enumerate(values_list):
            v = np.asarray(v).ravel()
            full[i] = v[ar % len(v)]
        spec = np.zeros((b, self.n), dtype=np.complex128)
        spec[:, self.slot_bins] = full
        spec[:, self.conj_bins] += np.conj(full)
        d = np.fft.fft(spec, axis=1) / self.n
        coeffs = np.real(d * np.conj(self.twist))
        return coeffs * np.asarray(scales, dtype=np.float64)[:, None]

    # ------------------------------------------------- compact (device) form
    def encode_compact_batch(self, values_list, scales) -> np.ndarray:
        """Encode B payloads into the COMPACT integer form -> uint32 [B,2,N].

        Each coefficient c is stored as sign*|mi|*2^k with |mi| <= 2^53
        (f64-exact for every c): row0 = |mi| & 0xffffffff, row1 = (|mi|>>32)
        | sign<<23 | k<<24. The per-prime RNS residues are reconstructed ON
        DEVICE (Evaluator.decode_plain) — so a CNN's multi-GB pre-encoded
        plaintext set becomes a ~2-row-per-mask device-resident pool instead
        of host->device streaming traffic every run."""
        b = len(values_list)
        full = np.empty((b, self.n_slots), dtype=np.complex128)
        ar = np.arange(self.n_slots)
        for i, v in enumerate(values_list):
            v = np.asarray(v).ravel()
            full[i] = v[ar % len(v)]
        spec = np.zeros((b, self.n), dtype=np.complex128)
        spec[:, self.slot_bins] = full
        spec[:, self.conj_bins] += np.conj(full)
        d = np.fft.fft(spec, axis=1) / self.n
        coeffs = np.real(d * np.conj(self.twist))
        prod = coeffs * np.asarray(scales, dtype=np.float64)[:, None]
        if not np.isfinite(prod).all():
            raise OverflowError("encode: scale overflows float64 range")
        mant, ex = np.frexp(prod)
        mi = np.round(mant * 2.0 ** 53).astype(np.int64)
        k = ex - 53
        small = k < 0                 # |c| < 2^53: store exactly, k = 0
        mi = np.where(small, np.round(np.where(small, prod, 0.0)).astype(np.int64), mi)
        k = np.clip(k, 0, None).astype(np.int64)
        assert int(k.max(initial=0)) < 256, "encode scale beyond 2^308?"
        sign = (mi < 0).astype(np.uint32)
        a = np.abs(mi).astype(np.uint64)
        lo = (a & 0xFFFFFFFF).astype(np.uint32)
        hi = ((a >> 32).astype(np.uint32)
              | (sign << 23) | (k.astype(np.uint32) << 24))
        return np.stack([lo, hi], axis=1)     # [B, 2, N]

    # ----------------------------------------------------------- decode
    def values_from_coeffs(self, coeffs_float: np.ndarray, scale: float,
                           complex_out: bool = False) -> np.ndarray:
        d = coeffs_float / scale * self.twist
        spec = self.n * np.fft.ifft(d)
        s = spec[self.slot_bins]
        return s if complex_out else np.real(s)

    def decode(self, planes: np.ndarray, scale: float,
               complex_out: bool = False) -> np.ndarray:
        """uint32 [nl, N] coefficient-domain planes -> slot values."""
        coeffs = self.crt_lift(planes)
        return self.values_from_coeffs(coeffs, scale, complex_out)

    def crt_lift(self, planes: np.ndarray) -> np.ndarray:
        """CRT-recombine residues to centered big ints, return as float64.

        nl <= 2 uses vectorized Garner in int64 (q0*q1 < 2^62 for 30-bit
        primes) — the hot path for decrypt/bootstrap-emulation, since
        refine_return_values pins outputs and bootstrap operands to the
        bottom of the chain. Larger nl runs a vectorized GARNER mixed-radix
        reconstruction in int64 (O(nl^2) Horner passes) and combines digits
        in float64: exact digits, then a small-to-large float sum whose
        precision equals float64's on the value itself (top digits of a
        centered small value are all zero / all q_k-1, so no cancellation).
        Replaces the python-object-int path that took MINUTES per decrypt
        at nl=28 (probes/getOutput at high levels).
        """
        nl = planes.shape[0]
        primes = [int(q) for q in self.ctx.q_primes[:nl]]
        if nl == 1:
            q0 = np.int64(primes[0])
            v = planes[0].astype(np.int64)
            return np.where(v > q0 // 2, v - q0, v).astype(np.float64)
        if nl == 2 and primes[0].bit_length() + primes[1].bit_length() <= 61:
            q0, q1 = primes
            inv = pow(q0, -1, q1)
            r0 = planes[0].astype(np.int64)
            r1 = planes[1].astype(np.int64)
            t = ((r1 - r0) % q1) * inv % q1           # int64: q1^2 < 2^62
            v = r0 + np.int64(q0) * t                 # < q0*q1 < 2^61
            bigq = q0 * q1
            return np.where(v > bigq // 2, v - bigq, v).astype(np.float64)
        # Garner digits: v = a0 + q0*(a1 + q1*(a2 + ...)), a_k < q_k
        x = planes.astype(np.int64)
        digits = np.empty((nl, planes.shape[-1]), dtype=np.int64)
        digits[0] = x[0] % primes[0]
        for k in range(1, nl):
            qk = primes[k]
            acc = digits[k - 1] % qk
            for j in range(k - 2, -1, -1):            # Horner: v mod qk
                acc = (acc * (primes[j] % qk) + digits[j]) % qk
            inv = 1
            for j in range(k):
                inv = inv * pow(primes[j], -1, qk) % qk
            digits[k] = (x[k] - acc) % qk * inv % qk
        # sign from the TOP mixed-radix digit (0 for small positive values,
        # q-1 for small negative ones), then a cancellation-free combine:
        # negative values use the mixed-radix complement Q - v (digits
        # q_k-1-a_k, +1), so each branch sums ONLY small-magnitude terms.
        # Q may exceed float64 range (nl >= 35 at 30-bit primes): w saturates
        # to inf, and `0 * inf = nan` is avoided by masking zero digits —
        # a value whose high digits are genuinely nonzero there IS out of
        # float64 range and correctly decodes to +-inf.
        neg = digits[nl - 1] > (primes[nl - 1] - 1) // 2
        val = np.zeros(planes.shape[-1])
        comp = np.zeros(planes.shape[-1])
        w = 1.0
        with np.errstate(over="ignore", invalid="ignore"):
            for k in range(nl):
                a = digits[k].astype(np.float64)
                b = (primes[k] - 1 - digits[k]).astype(np.float64)
                if np.isinf(w):
                    val += np.where(a == 0.0, 0.0, np.inf)
                    comp += np.where(b == 0.0, 0.0, np.inf)
                else:
                    val += a * w
                    comp += b * w
                    w *= float(primes[k])
        return np.where(neg, -(comp + 1.0), val)
