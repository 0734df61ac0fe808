"""High-level CKKS scheme facade: context + evaluator + encoder + keys.

Port of dacapo_tpu/crypto/scheme.py. Per-ciphertext metadata follows the
reference VM: `nl` active primes (hevm level = nl-1) and an exact float
`scale`, tracked like seal::Ciphertext::scale().
"""

from dataclasses import dataclass

import numpy as np
import torch

from .params import CKKSContext, CKKSConfig, PROFILES, to_dev, to_host
from .ops import Evaluator
from .encoding import Encoder
from .keys import KeyGenerator, KeySet
from .modmath import mul_mod, add_mod


@dataclass
class Ciphertext:
    data: object          # int32 [2, nl, N] NTT domain
    scale: float

    @property
    def nl(self):
        return self.data.shape[1]


@dataclass
class Plaintext:
    data: object          # int32 [nl, N] NTT domain
    scale: float

    @property
    def nl(self):
        return self.data.shape[0]


class Scheme:
    """device: "cuda" (the default) or "cpu"; CUDA without a card raises."""

    def __init__(self, profile="test_n8", config: CKKSConfig = None, seed=None,
                 device=None):
        self.ctx = CKKSContext(config or PROFILES[profile], device)
        self.device = self.ctx.device
        self.ev = Evaluator(self.ctx)
        self.encoder = Encoder(self.ctx)
        self.keygen = KeyGenerator(self.ctx, self.ev, seed=seed)
        self.keys: KeySet = None
        self._native_bs = None     # set by enable_native_bootstrap

    def generate_keys(self, rot_steps=()):
        self.keys = self.keygen.generate(rot_steps)
        return self.keys

    def ensure_galois(self, rot_steps):
        self.keygen.extend_galois(self.keys, rot_steps)

    def set_key_budget(self, budget_bytes):
        """Bound device-resident galois-key bytes (host-backed LRU beyond;
        the executor's graph windows read theirs from its slot arena, which
        shares the budget and is made again after a change)."""
        self.keys.galois.set_budget(budget_bytes)

    def galois_key_bytes(self):
        """Device bytes of ONE rotation key for this context (its shard's,
        once shard_keys ran)."""
        return self.ctx.config.dnum * 2 * self.ev.key_rows() * self.ctx.n * 4

    def shard_keys(self, shard):
        """Split the key switch's QP rows over a mesh's mp axis (shard: an
        ops.RowShard): from now on every key-switch key keeps only this
        rank's rows, those made later too, and the Evaluator's key switches
        all-gather their accumulators over shard.group (crypto/ops.py). The
        keys move into a new KeySet, key by key, so anything captured over
        the old one captures again. Keys split once stay split: a second
        call raises."""
        cur = self.ev.shard
        if cur is not None:
            raise ValueError(f"the keys already hold rank {cur.rank} of an mp axis of {cur.mp}")
        old = self.keys
        self.ev.shard = shard
        part = self.ev.shard_key
        self.keys = KeySet(
            s_ntt=old.s_ntt, pk=old.pk,
            rlk=None if old.rlk is None else part(old.rlk),
            conj=None if old.conj is None else part(old.conj),
            galois=old.galois.map_keys(part), shard=(shard.mp, shard.rank))
        return self.keys

    def enable_native_bootstrap(self, cfg=None):
        """Build the native bootstrapper (ModRaise, CoeffToSlot, EvalMod,
        SlotToCoeff) for this scheme; afterwards Bootstrapper(scheme) and
        the executor use it."""
        from .bootstrap_native import NativeBootstrapper
        self.keygen.ensure_conj(self.keys)
        self._native_bs = NativeBootstrapper(self, cfg)
        return self._native_bs

    # ------------------------------------------------------------ client
    def encode(self, values, scale: float = None, nl: int = None) -> Plaintext:
        cfg = self.ctx.config
        scale = float(2.0 ** cfg.scale_bits) if scale is None else float(scale)
        nl = cfg.num_q if nl is None else nl
        planes = self.encoder.encode(values, scale, nl)
        return Plaintext(self.ev.ntt(to_dev(planes, self.device), range(nl)), scale)

    def encrypt(self, values, scale: float = None, nl: int = None) -> Ciphertext:
        return self.encrypt_pt(self.encode(values, scale, nl))

    def encrypt_pt(self, pt: Plaintext) -> Ciphertext:
        nl = pt.nl
        rows = list(range(nl))
        kg = self.keygen
        v = kg._ntt_planes(kg._ternary(), rows)
        e0 = kg._ntt_planes(kg._gauss(), rows)
        e1 = kg._ntt_planes(kg._gauss(), rows)
        q = self.ev._q(rows)
        pk = self.keys.pk[:, :nl, :]
        c0 = add_mod(add_mod(mul_mod(v, pk[0], q), e0, q), pt.data, q)
        c1 = add_mod(mul_mod(v, pk[1], q), e1, q)
        return Ciphertext(torch.stack([c0, c1]), pt.scale)

    def decrypt_planes(self, ct: Ciphertext) -> np.ndarray:
        """-> uint32 [nl, N] coefficient-domain planes of m + e (host)."""
        nl = ct.nl
        q = self.ev._q(range(nl))
        m = add_mod(ct.data[0], mul_mod(ct.data[1], self.keys.s_ntt[:nl], q), q)
        return to_host(self.ev.intt(m, range(nl)))

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        return self.encoder.decode(self.decrypt_planes(ct), ct.scale)

    # --------------------------------------------------------- evaluator
    # Thin wrappers keeping (nl, scale) bookkeeping in one place; the
    # executor uses Evaluator directly with its own bookkeeping.
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(self.ev.add_ct(a.data, b.data, a.nl), b.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(self.ev.sub_ct(a.data, b.data, a.nl), b.scale)

    def add_pt(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        return Ciphertext(self.ev.add_pt(a.data, p.data, a.nl), p.scale)

    def mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(
            self.ev.mul_ct(a.data, b.data, a.nl, self.keys.rlk), a.scale * b.scale)

    def mul_pt(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        return Ciphertext(self.ev.mul_pt(a.data, p.data, a.nl), a.scale * p.scale)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return Ciphertext(self.ev.neg_ct(a.data, a.nl), a.scale)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Drop one LEVEL = rescale_rows RNS rows."""
        scale, nl = a.scale, a.nl
        rr = self.ctx.config.rescale_rows
        data = self.ev.rescale_k(a.data, nl, rr)
        for _ in range(rr):
            scale /= self.ctx.q_primes[nl - 1]
            nl -= 1
        return Ciphertext(data, scale)

    def mod_drop(self, a: Ciphertext, k: int = 1) -> Ciphertext:
        """Drop k LEVELS (k * rescale_rows rows) without scale change."""
        return Ciphertext(
            self.ev.mod_drop(a.data, k * self.ctx.config.rescale_rows), a.scale)

    def upscale(self, a: Ciphertext, up_bits: int) -> Ciphertext:
        return Ciphertext(self.ev.upscale(a.data, a.nl, up_bits),
                          a.scale * (2.0 ** up_bits))

    def rotate(self, a: Ciphertext, steps: int) -> Ciphertext:
        steps = steps % self.ctx.config.n_slots
        if steps == 0:
            return a
        gk = self.keys.galois[steps]
        return Ciphertext(self.ev.rotate(a.data, a.nl, steps, gk), a.scale)

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        """Complex-conjugate the slots; makes the conjugation key if missing."""
        self.keygen.ensure_conj(self.keys)
        return Ciphertext(self.ev.conjugate(a.data, a.nl, self.keys.conj), a.scale)
