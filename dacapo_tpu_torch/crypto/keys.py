"""Key generation: secret/public/relinearization/Galois keys (PyTorch).

Port of dacapo_tpu/crypto/keys.py. Sampling happens host-side with numpy's
default_rng in the reference's exact draw order, so a context with the same
seed gives bit-identical keys; the NTTs run on the context's device. Keysets
persist as the reference's `.npy` directory, readable by either package.

On the mp axis of a mesh (parallel/mesh.py, crypto/ops.py) every rank draws
the same keys from the same seed, one full key at a time, and keeps only
its rows of each key-switch key (`Evaluator.shard_key`): the relinearization
key, the conjugation key and the galois keys then hold [dnum, 2, rows, N],
and the galois budget, the executor's key arena and the LRU count those
bytes. A sharded keyset is not written to disk: the keyset directory holds
full keys, as the JAX package writes them.
"""

import os
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .modmath import add_mod, neg_mod, mul_mod
from .params import to_dev, to_host, upload


class GaloisStore:
    """Galois-key store: dict-like, optionally host-backed with a budgeted
    device LRU cache.

    A program can need more rotation-key bytes than the card can spare, so
    keys may live in host RAM with at most `budget` bytes on the device at
    once, evicted LRU. With `budget=None` entries stay on the device and it
    behaves like a plain dict.

    `reserved` device key bytes are held outside the LRU (the executor's
    slot arena of its graph windows, the conjugation key): the LRU evicts
    while its bytes plus those pass the budget, and `peak_bytes` is the
    most the two came to. `pin_host` moves the host copies into pinned
    slabs (on the card), from which the executor stages keys into its arena
    and the LRU uploads without blocking.

    `generation` grows whenever a device key tensor is dropped or replaced:
    a CUDA graph that reads the LRU's keys reads them at the addresses it
    was captured with (vm/executor.py recaptures when it changed).
    `version(st)` grows when key `st` itself is replaced: the executor
    stages a replaced key into its arena again.
    """

    SLAB_BYTES = 1 << 30     # a pinned slab's size, at most (a power of two)
    SLAB_KEYS = 64           # and its keys, at most

    def __init__(self, device, budget=None):
        self.device = torch.device(device)
        self.budget = budget
        self._host = {}              # steps -> np.ndarray uint32, or a slab view (authoritative)
        self._dev = OrderedDict()    # steps -> int32 tensor (LRU)
        self._dev_bytes = 0
        self.generation = 0
        self.reserved = 0
        self.peak_bytes = 0
        self.uploads = 0             # host-to-device copies of the LRU
        self._versions = {}
        self._slabs = None           # [slab tensor [keys, ...]] once pin_host ran
        self._free = []              # unused slab rows

    def _drop(self, st):
        """Remove the device copy of key `st` (if any)."""
        old = self._dev.pop(st, None)
        if old is not None:
            self._dev_bytes -= old.nbytes
            self.generation += 1

    def _fit(self, keep=0):
        """Evict the oldest device copies while they and the reserved bytes
        pass the budget, `keep` of them staying however large."""
        if self.budget is not None:
            while self._dev_bytes + self.reserved > self.budget and len(self._dev) > keep:
                st = next(iter(self._dev))
                if st not in self._host:       # never drop a key's only copy
                    self._host[st] = self._host_copy(st, self._dev[st])
                self._drop(st)
        self.peak_bytes = max(self.peak_bytes, self.device_bytes)

    @property
    def device_bytes(self):
        """Device key bytes: the LRU's and the reserved."""
        return self._dev_bytes + self.reserved

    def reserve(self, nbytes):
        """Hold `nbytes` of the budget outside the LRU, which evicts to fit."""
        self.reserved = nbytes
        self._fit()

    def version(self, st):
        return self._versions.get(st, 0)

    def set_budget(self, budget):
        """Switch to host-backed mode (or tighten the budget): device copies
        over budget are dropped, host copies become authoritative."""
        self.budget = budget
        if budget is None:
            return
        for st, arr in list(self._dev.items()):
            if st not in self._host:
                self._host[st] = self._host_copy(st, arr)
        self._fit()

    def pin_host(self):
        """Keep every host copy, now and later, in slabs of SLAB_BYTES at
        most, page-locked on the card: one slab holds many keys, where a
        pinned tensor each would round every key up to a power of two."""
        if self._slabs is None:
            self._slabs = []
            for st in list(self._host):
                self._host[st] = self._host_copy(st, self._host.pop(st))

    def _host_copy(self, st, arr):
        """The host form of key `st`: numpy uint32, or once pin_host ran a
        slab row (the key's own row when it is replaced)."""
        if self._slabs is None:
            return to_host(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
        src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int32))
        row = self._host.get(st)
        if row is None or not isinstance(row, torch.Tensor):
            if not self._free:
                per = max(1, min(self.SLAB_KEYS, self.SLAB_BYTES // src.nbytes))
                slab = torch.empty((per,) + tuple(src.shape), dtype=torch.int32,
                                   pin_memory=self.device.type == "cuda")
                self._slabs.append(slab)
                self._free.extend(slab[i] for i in range(per - 1, -1, -1))
            row = self._free.pop()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)    # no copy from the old key in flight
        row.copy_(src)
        return row

    def _replaced(self, st):
        if st in self:
            self._versions[st] = self.version(st) + 1

    def __setitem__(self, st, arr):
        self._replaced(st)
        if self.budget is None:
            dev = arr if isinstance(arr, torch.Tensor) else to_dev(arr, self.device)
            dev = dev.to(self.device)
            self._drop(st)
            self._dev[st] = dev
            self._dev_bytes += dev.nbytes
            self._host.pop(st, None)
            self._fit()
        else:
            self.put_host(st, arr)

    def put_host(self, st, arr):
        """Insert a key host-side only: device residency is decided at first
        use, under whatever budget applies then."""
        self._replaced(st)
        self._host[st] = self._host_copy(st, arr)
        self._drop(st)

    def stage_source(self, st):
        """(tensor, on the device) to copy key `st` from without touching
        the LRU: its device copy when it has one, else its host copy."""
        dev = self._dev.get(st)
        if dev is not None:
            return dev, True
        host = self._host[st]
        return (host if isinstance(host, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(host).view(np.int32))), False

    def __getitem__(self, st):
        dev = self._dev.get(st)
        if dev is not None:
            self._dev.move_to_end(st)
            return dev
        host = self._host[st]
        dev = (upload(host, self.device, non_blocking=True) if isinstance(host, torch.Tensor)
               else to_dev(host, self.device))
        self.uploads += 1
        self._dev[st] = dev
        self._dev_bytes += dev.nbytes
        self._fit(keep=1)
        return dev

    def __contains__(self, st):
        return st in self._dev or st in self._host

    def __len__(self):
        return len(self.keys())

    def __iter__(self):
        return iter(self.keys())

    def keys(self):
        return self._host.keys() | self._dev.keys()

    def map_keys(self, fn):
        """A new store holding fn(key) for every key, under the same budget
        and pinning; each device copy here is dropped as its replacement is
        made, so the two stores together hold one extra key at most."""
        new = GaloisStore(self.device, self.budget)
        if self._slabs is not None:
            new.pin_host()
        for st in sorted(self.keys()):
            src = self._host.get(st)
            new[st] = fn(self._dev[st] if src is None else src)
            self._drop(st)
        return new

    def peek_host(self, st):
        """Host uint32 copy without promoting the key to the device."""
        host = self._host.get(st)
        if host is None:
            return to_host(self._dev[st])
        # a copy: a slab row is rewritten in place when its key is replaced
        return to_host(host).copy() if isinstance(host, torch.Tensor) else host


@dataclass
class KeySet:
    s_ntt: object                    # int32 [num_all, N] (secret)
    pk: object                       # int32 [2, num_q, N] (b, a)
    rlk: object                      # int32 [dnum, 2, num_all, N]
    galois: GaloisStore = None       # steps -> int32 [dnum, 2, num_all, N]
    conj: object = None              # conjugation key, same shape as rlk
    shard: tuple = None              # (mp, rank): the key-switch keys hold only
    #                                  the rows g with g % mp == rank


class KeyGenerator:
    def __init__(self, ctx, evaluator, seed=None):
        self.ctx = ctx
        self.ev = evaluator
        self.rng = np.random.default_rng(ctx.config.seed if seed is None else seed)

    # ------------------------------------------------------------- samples
    # Draw calls and their order are the reference's: keys and encryptions
    # are bit-identical for the same seed.
    def _ternary(self, h: int = 0):
        """Uniform dense ternary, or (h>0) sparse with Hamming weight h."""
        if h <= 0:
            return self.rng.integers(-1, 2, size=self.ctx.n).astype(np.int64)
        out = np.zeros(self.ctx.n, dtype=np.int64)
        idx = self.rng.choice(self.ctx.n, size=h, replace=False)
        out[idx] = self.rng.choice(np.array([-1, 1], dtype=np.int64), size=h)
        return out

    def _gauss(self):
        return np.round(self.rng.normal(0.0, 3.2, size=self.ctx.n)).astype(np.int64)

    def _uniform_host(self, rows):
        # row by row, as uint32: the draws of one call with a bound per row
        # into int64 (numpy's bounded draws below 2^32 take one 32-bit
        # output each, for either dtype, in the same order), a quarter
        # faster than the broadcast bounds row by row and twice again as
        # uint32 (no int64 array, no conversion)
        u = np.empty((len(rows), self.ctx.n), dtype=np.uint32)
        for i, r in enumerate(rows):
            u[i] = self.rng.integers(0, self.ctx.primes[r], size=self.ctx.n, dtype=np.uint32)
        return u

    def _uniform_planes(self, rows):
        return to_dev(self._uniform_host(rows), self.ctx.device)

    def _ksk_draws(self):
        """The host draws of one key-switch key, in _ksk's order: each
        digit's uniform planes over the full basis, then its error."""
        all_rows = list(range(self.ctx.config.num_all))
        return [(self._uniform_host(all_rows), self._gauss())
                for _ in range(self.ctx.config.dnum)]

    def _draws_ahead(self, n_keys, depth=2):
        """_ksk_draws of n_keys keys, in order, drawn by one thread at most
        `depth` keys ahead of the caller, which meanwhile makes the keys
        before them on the device: the same draws in the same order as a
        plain loop (numpy's bounded draws release the GIL), so the same
        keys; only a key that raises leaves the generator up to `depth`
        keys' draws further on."""
        with ThreadPoolExecutor(1) as pool:
            pending = deque(pool.submit(self._ksk_draws) for _ in range(min(depth, n_keys)))
            for i in range(n_keys):
                out = pending.popleft().result()
                if i + depth < n_keys:
                    pending.append(pool.submit(self._ksk_draws))
                yield out

    def _ntt_planes(self, coeffs: np.ndarray, rows):
        return self.ev.ntt(self.ev.residues(coeffs, rows), rows)

    # ------------------------------------------------------------- keygen
    def generate(self, rot_steps=()) -> KeySet:
        cfg = self.ctx.config
        all_rows = list(range(cfg.num_all))
        q_rows = list(range(cfg.num_q))

        s_ntt = self._ntt_planes(self._ternary(cfg.secret_h), all_rows)

        # public key over Q: b = -a s + e
        a = self._uniform_planes(q_rows)
        e = self._ntt_planes(self._gauss(), q_rows)
        q = self.ev._q(q_rows)
        b = add_mod(neg_mod(mul_mod(a, s_ntt[: cfg.num_q], q), q), e, q)
        pk = torch.stack([b, a])

        # relinearization key: target s^2
        rlk = self._ksk(s_ntt, mul_mod(s_ntt, s_ntt, self.ev._q(all_rows)))

        keys = KeySet(s_ntt=s_ntt, pk=pk, rlk=rlk,
                      galois=GaloisStore(self.ctx.device))
        return self.extend_galois(keys, rot_steps)

    def extend_galois(self, keyset: KeySet, rot_steps):
        """Generate any missing galois keys for the given rotation steps.
        Raises RuntimeError on a keyset without the secret key (a server's)
        that lacks one of them."""
        half = self.ctx.n // 2
        missing = sorted({st % half for st in rot_steps
                          if st % half and st % half not in keyset.galois})
        if missing and keyset.s_ntt is None:
            raise RuntimeError(
                f"the keyset has no secret key and lacks the galois keys of rotation "
                f"steps {missing[:8]}{' ...' if len(missing) > 8 else ''}: generate "
                "the full keyset for this program first (a full HEVM's load)")
        todo = list(dict.fromkeys(st % half for st in rot_steps
                                  if st % half and st % half not in keyset.galois))
        for st, draws in zip(todo, self._draws_ahead(len(todo))):
            s_rot = self.ev.automorphism(keyset.s_ntt, st)
            keyset.galois[st] = self._ksk(keyset.s_ntt, s_rot, draws)
        return keyset

    def ensure_conj(self, keyset: KeySet):
        """Generate the conjugation (X -> X^{-1}) key if missing."""
        if keyset.conj is None:
            if keyset.s_ntt is None:
                raise RuntimeError(
                    "the keyset has no conjugation key and no secret key to make "
                    "one: generate the full keyset with the conjugation key first")
            s_conj = self.ev.conj_apply(keyset.s_ntt)
            keyset.conj = self._ksk(keyset.s_ntt, s_conj)
        return keyset

    def _ksk(self, s_ntt, target_ntt, draws=None):
        """Key-switch key from key `target` to key `s`:
        ksk_j = (-a_j s + e_j + [P*Q̂_j^{full}]*target, a_j) over the full QP basis.
        draws: its host draws made ahead (_ksk_draws), else drawn here."""
        ctx = self.ctx
        cfg = ctx.config
        all_rows = list(range(cfg.num_all))
        q = self.ev._q(all_rows)
        digits = []
        for j in range(cfg.dnum):
            rows_j = list(range(j * cfg.alpha, min((j + 1) * cfg.alpha, cfg.num_q)))
            qj = 1
            for r in rows_j:
                qj *= ctx.q_primes[r]
            factor_int = ctx.p_prod * (ctx.q_full // qj)
            fac = np.array([factor_int % p for p in ctx.primes], dtype=np.uint32)
            if draws is None:
                a_j = self._uniform_planes(all_rows)
                e_j = self._ntt_planes(self._gauss(), all_rows)
            else:
                a_j = to_dev(draws[j][0], ctx.device)
                e_j = self._ntt_planes(draws[j][1], all_rows)
            msg = mul_mod(to_dev(fac[:, None], ctx.device), target_ntt, q)
            b_j = add_mod(add_mod(neg_mod(mul_mod(a_j, s_ntt, q), q), e_j, q), msg, q)
            digits.append(torch.stack([b_j, a_j]))
        return self.ev.shard_key(torch.stack(digits))


def save_keyset(keyset: KeySet, dirpath: str, parts=("secret", "public", "eval"),
                skip_existing=False):
    """Persist a keyset directory in the reference's format (uint32 .npy
    files; galois/<steps>.npy). `parts` selects what is written, so a
    deployment can ship the client half (secret, public) and the server half
    (public, eval) apart. skip_existing: only write absent files."""
    if keyset.shard is not None and "eval" in parts:
        raise ValueError(f"the keyset holds the rows of rank {keyset.shard[1]} of an mp axis "
                         f"of {keyset.shard[0]}: only full keys are written")
    os.makedirs(dirpath, exist_ok=True)

    def _put(name, arr):
        p = os.path.join(dirpath, name)
        if arr is None or (skip_existing and os.path.exists(p)):
            return
        np.save(p, arr if isinstance(arr, np.ndarray) else to_host(arr))

    if "secret" in parts:
        _put("s_ntt.npy", keyset.s_ntt)
    if "public" in parts:
        _put("pk.npy", keyset.pk)
    if "eval" in parts:
        _put("rlk.npy", keyset.rlk)
        _put("conj.npy", keyset.conj)
        os.makedirs(os.path.join(dirpath, "galois"), exist_ok=True)
        for st in keyset.galois.keys():
            p = os.path.join("galois", f"{st}.npy")
            if not (skip_existing and os.path.exists(os.path.join(dirpath, p))):
                _put(p, keyset.galois.peek_host(st))


def keyset_from_numpy(d, device) -> KeySet:
    """KeySet from host arrays: d holds uint32 `s_ntt`, `pk`, `rlk`, `conj`
    (each may be absent or None) and `galois` ({steps: array}), e.g. a
    reference KeySet via np.asarray."""
    dev = torch.device(device)

    def opt(name):
        return to_dev(d[name], dev) if d.get(name) is not None else None

    ks = KeySet(s_ntt=opt("s_ntt"), pk=to_dev(d["pk"], dev), rlk=opt("rlk"),
                conj=opt("conj"), galois=GaloisStore(dev))
    for st, arr in d.get("galois", {}).items():
        ks.galois.put_host(int(st), np.asarray(arr))
    return ks


def load_keyset(dirpath: str, device, mode="full") -> KeySet:
    """Read a keyset directory written by either package's save_keyset.
    mode: "full" (everything), "client" (secret and public key: encrypt and
    decrypt) or "server" (public and evaluation keys, no secret: evaluate
    only), the reference's initFullVM/initClientVM/initServerVM split."""
    if mode not in ("full", "client", "server"):
        raise ValueError(f"mode must be 'full', 'client' or 'server', not {mode!r}")
    want_secret = mode in ("full", "client")
    want_eval = mode in ("full", "server")

    def _load(name, want=True):
        p = os.path.join(dirpath, f"{name}.npy")
        return np.load(p) if want and os.path.exists(p) else None

    gdir = os.path.join(dirpath, "galois")
    galois = {}
    if want_eval and os.path.isdir(gdir):
        for f in os.listdir(gdir):
            galois[int(f[:-4])] = np.load(os.path.join(gdir, f))
    return keyset_from_numpy(
        dict(s_ntt=_load("s_ntt", want_secret), pk=_load("pk"),
             rlk=_load("rlk", want_eval), conj=_load("conj", want_eval), galois=galois),
        device)
