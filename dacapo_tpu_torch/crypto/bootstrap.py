"""Bootstrapping: the emulated oracle and the dispatch (PyTorch).

Port of dacapo_tpu/crypto/bootstrap.py. `Bootstrapper` picks the native
bootstrapper (crypto/bootstrap_native.py: ModRaise, CoeffToSlot, EvalMod,
SlotToCoeff) or the `EmulatedBootstrapper`: decrypt at the chain bottom ->
exact CRT lift to the target chain -> re-encrypt with fresh randomness. It is
the insecure functional oracle the reference ships for SEAL
(SEAL_HEVM.cpp:324-334, README.md:160-173 "not privacy-safe"): the server
holds the secret key here, exactly as in the reference's SEAL build. The
ciphertext never leaves the device.

The oracle has the reference's two paths:

* the device path (the default, the reference's `_oracle_fn`): the fresh
  encryption randomness (v, e0, e1) is drawn on the scheme's device from the
  oracle's own torch.Generator, seeded once as the reference seeds its
  jax.random keys. On the card each cache key (nl, base rows, nl2) is one
  CUDA graph, the counterpart of the reference's one jax.jit per key: every
  bootstrap, on the segment path and the per-op path alike, copies its
  input into the graph's static input, replays it and clones the output.
  The CPU runs the same function eagerly.
* the host-RNG path (`host_rng=True`, the reference's
  DACAPO_TPU_ORACLE_JIT=0): v, e0 and e1 come from the key generator's numpy
  RNG in the reference's order, so the refreshed ciphertext is bit-equal to
  the reference's. Inputs at one row (nl < 2) always take it, as in the
  reference.

Both paths have a batched form, `bootstrap_batch` over [B, 2, nl, N] (the
reference's `bootstrap_batch` and `_oracle_fn(batch=B)`): on the device path
every row draws its own v, e0, e1 from the generator in one call, and on the
card each cache key (nl, base rows, nl2, B) is one CUDA graph over the whole
batch; the host path cools and lifts the whole batch, then draws all B v,
then all B e0, then all B e1 from the numpy RNG, the reference's batch
order (which differs from B single bootstraps').

Both paths compute the deterministic part, the lifted plaintext m2, with
`_lifted_plaintext`, and they differ in one step. The host path lifts from
the bottom prime pair as the reference does, so an input that arrives hot
(the planner's 2^60 bootstrap inputs, above what the pair holds with
_LIFT_VMAX_BITS of headroom) is first cooled by exact single-row rescales:
each drops a whole ~30-bit row, and its rounding costs the message those
bits (~2^-22 of it on tpu_n15), which the reheat by K does not restore. The
device path does not copy that loss: it lifts exactly from the fewest bottom
primes that hold the message (`_base_rows`, three for a 2^60 input), as the
SEAL oracle the reference models re-encodes the decrypted message in full
(SEAL_HEVM.cpp:324-334). Where the pair suffices (no cooling in the
reference either) both paths give the reference's m2 bit for bit.
"""

import time

import numpy as np
import torch

from .crt_lift import _col, crt_expand, single_crt_expand
from .cuda import ntt_kernel
from .modmath import add_mod, mul_mod

# Headroom for the exact integer lift: polynomial COEFFICIENTS of the raw
# message (~scale * slot-bound) must stay below the lift base q0*q1/2, so
# inputs that arrive hot (zero-depth boundaries leave them at up to
# Delta~2^60 ~ q0*q1) are first cooled by exact single-row rescales.
_LIFT_VMAX_BITS = 13


def _lift_limit(ctx):
    return np.log2(float(ctx.q_primes[0]) * float(ctx.q_primes[1])) - 1


def _cool_input(s, data, nl, scale, limit_log2):
    """Rescale single RNS rows (exact division) until log2(scale) +
    _LIFT_VMAX_BITS <= limit_log2. Returns (data, nl, scale, K) where K is
    the exact integer product of the dropped primes (1 if none)."""
    data = data[..., :nl, :]
    K = 1
    while nl > 2 and np.log2(scale) + _LIFT_VMAX_BITS > limit_log2:
        data = s.ev.rescale_k(data, nl, 1)
        K *= int(s.ctx.q_primes[nl - 1])
        scale /= float(s.ctx.q_primes[nl - 1])
        nl -= 1
    return data, nl, scale, K


def _reheat(ctx, lifted, num_rows, K):
    """Multiply lifted coefficient planes [..., num_rows, N] by the exact
    integer K (mod each prime): restores the pre-cooling scale, so the oracle
    is scale-preserving like the reference SEAL oracle and like the
    executor's OP_BOOTSTRAP meta rule. K (a product of dropped primes, above
    2^31 for two or more) is reduced mod each q in Python integers."""
    qs = [int(ctx.q_primes[i]) for i in range(num_rows)]
    # exactness: |K * centered| < prod(qs)/2 (message stayed under q0*q1/2)
    assert np.log2(float(K)) + np.log2(float(qs[0])) + np.log2(float(qs[1])) \
        < sum(np.log2(float(q)) for q in qs), \
        "reheat would overflow the target chain modulus"
    return mul_mod(lifted, _col(ctx, [K % q for q in qs]), _col(ctx, qs))


class EmulatedBootstrapper:
    def __init__(self, scheme, host_rng=False):
        self.s = scheme
        assert scheme.keys is not None and scheme.keys.s_ntt is not None, \
            "emulated bootstrapping needs the secret key (full VM mode)"
        self.host_rng = host_rng
        self.calls = 0          # bootstraps run, for the chip smoke's check
        # the device path's randomness: one generator on the scheme's device,
        # seeded once as the reference seeds its jax.random keys
        self.gen = torch.Generator(device=scheme.device)
        self.gen.manual_seed(int(np.random.SeedSequence(0xB007).generate_state(1)[0]))
        self._graphs = {}       # cache key -> graph record (the card only)
        self.replays = 0        # oracle graph replays, over all requests
        # NTT calls the replayed graphs ran, over all requests (what each
        # graph recorded at capture, ntt_kernel.RECORDED)
        self.replayed_ntt = dict.fromkeys(ntt_kernel.RECORDED, 0)
        self.capture_s = 0.0    # seconds spent capturing oracle graphs

    def _plan(self, nl, scale, target_level):
        """The reference's static cooling plan for (nl, scale), which the
        host path follows (_cool_input): returns (n_drop, K, nl2)."""
        ctx = self.s.ctx
        nl2 = (target_level + 1) * ctx.config.rescale_rows
        limit = _lift_limit(ctx)
        K, n_drop, nlc, sc = 1, 0, nl, scale
        while nlc > 2 and np.log2(sc) + _LIFT_VMAX_BITS > limit:
            K *= int(ctx.q_primes[nlc - 1])
            sc /= float(ctx.q_primes[nlc - 1])
            nlc -= 1
            n_drop += 1
        return n_drop, K, nl2

    def _base_rows(self, nl, scale):
        """The device path's lift base for an input at (nl, scale): the
        fewest bottom primes, at least the pair and at most nl, whose
        product holds the message with _LIFT_VMAX_BITS of headroom (the
        reference's limit for the pair). With all nl rows the lift is exact
        whenever decryption is."""
        ctx = self.s.ctx
        nb = 2
        while nb < nl and np.log2(scale) + _LIFT_VMAX_BITS > sum(
                np.log2(float(q)) for q in ctx.q_primes[:nb]) - 1:
            nb += 1
        return nb

    def _lifted_plaintext(self, data, nb, K, nl2):
        """The deterministic part of a refresh: m = c0 + c1*s at the bottom
        nb rows of a ciphertext [..., 2, nl, N] (or a batch of them), iNTT,
        exact centered CRT lift to nl2 rows, reheat by K (the host path's
        cooling), NTT. Returns m2, int32 [..., nl2, N]."""
        s = self.s
        ctx = s.ctx
        ev = s.ev
        rows = list(range(nb))
        q = ev._q(rows)
        m_ntt = add_mod(data[..., 0, :nb, :],
                        mul_mod(data[..., 1, :nb, :], s.keys.s_ntt[:nb], q), q)
        c = ev.intt(m_ntt, rows)                       # [..., nb, N] coeffs
        if nb >= 2:
            lifted = crt_expand(ctx, list(c.unbind(-2)), nl2)
        else:
            lifted = single_crt_expand(ctx, c[..., 0, :], nl2)
        if K != 1:
            lifted = _reheat(ctx, lifted, nl2, K)
        return ev.ntt(lifted, list(range(nl2)))

    def _encrypt(self, m2, v, e0, e1, nl2):
        """c0 = v*pk0 + e0 + m2, c1 = v*pk1 + e1 over nl2 rows (NTT domain);
        m2, v, e0, e1 [..., nl2, N] -> [..., 2, nl2, N]."""
        ev = self.s.ev
        q2 = ev._q(range(nl2))
        pk = self.s.keys.pk[:, :nl2, :]
        c0 = add_mod(add_mod(mul_mod(v, pk[0], q2), e0, q2), m2, q2)
        c1 = add_mod(mul_mod(v, pk[1], q2), e1, q2)
        return torch.stack([c0, c1], dim=-3)

    def draw(self, batch=()):
        """The device path's fresh randomness, int64 [*batch, 3, N]: v in
        {-1, 0, 1} and e0, e1 = round(normal * 3.2), from self.gen on its
        device; each row of a batch draws its own."""
        n, dev = self.s.ctx.n, self.gen.device
        batch = tuple(batch)
        v = torch.randint(-1, 2, batch + (n,), generator=self.gen, device=dev)
        e = torch.randn(batch + (2, n), generator=self.gen, device=dev)
        return torch.cat([v[..., None, :], torch.round(e * 3.2).to(torch.int64)], dim=-2)

    def _refresh(self, data, nb, nl2):
        """The device path over a ciphertext [2, nl, N] or a batch [B, 2,
        nl, N] (the body of one oracle graph): the lifted plaintext from nb
        base rows, then a fresh encryption whose three noise polynomials
        (per row) are taken mod every prime (numpy sign semantics:
        torch.remainder) and go through one NTT of B * 3 * nl2 planes."""
        ev = self.s.ev
        m2 = self._lifted_plaintext(data, nb, 1, nl2)
        rows2 = list(range(nl2))
        noise = (self.draw(data.shape[:-3])[..., None, :] % ev._q(rows2)).to(torch.int32)
        v, e0, e1 = ev.ntt(noise, rows2).unbind(-3)
        return self._encrypt(m2, v, e0, e1, nl2)

    def capture(self, nl, scale, target_level, batch=None):
        """The CUDA graph of the refresh for (nl, scale, target_level), made
        at first use: an eager run fills the Evaluator's and the CRT lift's
        device caches (no upload may run under capture), then the capture,
        with the generator registered so that every replay draws afresh.
        The generator's state is restored afterwards: capturing draws
        nothing. A graph reads the keys it was captured with, so a new key
        set captures again. Returns the record: graph, inp (static input
        [2, nl, N], or [B, 2, nl, N] for a batch of B), out (static output
        [..., 2, nl2, N])."""
        return self._graph(self._key(nl, scale, target_level, batch))

    def _key(self, nl, scale, target_level, batch=None):
        """The device path's cache key: (nl, base rows, nl2), and B after
        them for a batch of B."""
        key = (nl, self._base_rows(nl, scale),
               (target_level + 1) * self.s.ctx.config.rescale_rows)
        return key if batch is None else key + (batch,)

    def _graph(self, key):
        keys = self.s.keys
        rec = self._graphs.get(key)
        if rec is not None and rec["keys"] is keys:
            return rec
        self._graphs.pop(key, None)
        t0 = time.perf_counter()
        dev = self.s.device
        inp = torch.zeros(key[3:] + (2, key[0], self.s.ctx.n), dtype=torch.int32,
                          device=dev)
        state = self.gen.get_state()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._refresh(inp, *key[1:3])
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        ntt0 = dict(ntt_kernel.RECORDED)
        with torch.cuda.graph(graph, stream=stream):
            out = self._refresh(inp, *key[1:3])
        self.gen.set_state(state)
        self.capture_s += time.perf_counter() - t0
        rec = self._graphs[key] = dict(graph=graph, inp=inp, out=out, keys=keys,
                                       ntt={k: v - ntt0[k] for k, v in ntt_kernel.RECORDED.items()})
        return rec

    def bootstrap(self, data, nl, scale, target_level):
        """Refresh int32 [2, >=nl, N] at `nl` rows to the chain of
        `target_level`, or a batch [B, 2, >=nl, N] in one call (counted
        once in `calls`; the reference's bootstrap_batch). Returns (data
        [..., 2, nl2, N], (nl2, scale)); the scale is kept. On the card the
        device path replays the graph of the key (with B for a batch) and
        returns a copy of its output, which the next replay overwrites."""
        self.calls += 1
        if self.host_rng or nl < 2:
            return self._host_bootstrap(data, nl, scale, target_level)
        key = self._key(nl, scale, target_level, data.shape[0] if data.dim() == 4 else None)
        nl2 = key[2]
        if data.device.type != "cuda":
            return self._refresh(data[..., :nl, :], *key[1:3]), (nl2, scale)
        rec = self._graph(key)
        rec["inp"].copy_(data[..., :nl, :])
        rec["graph"].replay()
        self.replays += 1
        for k, v in rec["ntt"].items():
            self.replayed_ntt[k] += v
        return rec["out"].clone(), (nl2, scale)

    bootstrap_batch = bootstrap

    def _host_bootstrap(self, data, nl, scale, target_level):
        """The host-RNG path, the reference's: cool to the bottom pair, the
        lifted plaintext, reheat, and a fresh encryption with v, e0, e1 from
        the key generator's numpy RNG. A batch [B, 2, nl, N] is cooled and
        lifted whole, then draws all its v, then all e0, then all e1, as the
        reference's bootstrap_batch does."""
        s = self.s
        ctx = s.ctx
        nl2 = (target_level + 1) * ctx.config.rescale_rows
        data, nl, _, K = _cool_input(s, data, nl, scale, _lift_limit(ctx))
        m2 = self._lifted_plaintext(data, 2 if nl >= 2 else 1, K, nl2)
        # fresh encryption of m2: host RNG for v/e in the reference's order
        kg = s.keygen
        rows2 = list(range(nl2))

        def planes(gen):
            if data.dim() == 3:
                return kg._ntt_planes(gen(), rows2)
            return torch.stack([kg._ntt_planes(gen(), rows2) for _ in range(data.shape[0])])

        v = planes(kg._ternary)
        e0 = planes(kg._gauss)
        e1 = planes(kg._gauss)
        return self._encrypt(m2, v, e0, e1, nl2), (nl2, scale)


def Bootstrapper(scheme, native=None, host_rng=False):
    """The scheme's native bootstrapper once enable_native_bootstrap ran
    (unless native=False), a new one for native=True, else the oracle, on
    its device path unless host_rng.

    Unlike the JAX package, a profile made for native bootstrapping
    (config.native_bootstrap) never falls back to the oracle by itself: it
    raises until the native path is enabled, or the caller asks for the
    oracle with native=False."""
    nb = scheme._native_bs
    if nb is not None and native is not False:
        return nb
    if native:
        from .bootstrap_native import NativeBootstrapper
        return NativeBootstrapper(scheme)
    if native is None and scheme.ctx.config.native_bootstrap:
        raise RuntimeError(
            "this profile bootstraps natively: call scheme.enable_native_bootstrap() "
            "first (HEVM does), or pass native=False for the oracle")
    return EmulatedBootstrapper(scheme, host_rng=host_rng)
