"""CKKS evaluator primitives over RNS limb planes (PyTorch).

Port of dacapo_tpu/crypto/ops.py, limited to what the executor and the
bootstrappers run (the reference's mul_pt_scalar and upscale_rescale have no
caller there and are not ported). Every op is a plain function of tensors;
the level and scale metadata is handled by the caller (vm/executor.py,
crypto/bootstrap_native.py), as SEAL tracks ciphertext.scale().

Ciphertext polys: int32 [..., 2, nl, N] in NTT domain, rows = Q primes
                  0..nl-1; leading dimensions are a batch of ciphertexts.
Plaintext:        int32 [nl, N] in NTT domain.
Key-switch keys:  int32 [dnum, 2, num_all, N] (NTT domain, full QP basis).

Batching. The reference batches with jax.vmap over these functions. The port
cannot trace the ctypes call of the CUDA NTT that way, and a loop over the
rows would launch every kernel once per row; so every op the executor calls
takes a batch [B, 2, nl, N] (or none, [2, nl, N]) and computes the whole
batch in each kernel: the ciphertext axes are indexed from the right, and
an NTT flattens the batch into its planes with the row list tiled (`_ntt`).
Plaintexts and keys are never batched: they broadcast over the batch, as
the reference's in_axes=None does. An unbatched call launches exactly the
kernels it launched before batching existed, on the same shapes.

NTT-domain planes are in ORBIT ORDER (params.CKKSContext.orbit_perm): the
fixed reorder is a gather at the NTT boundary (`_ntt`), so a slot rotation is
a roll of each half. The NTT itself is the hand-written CUDA kernel for
tensors on the card and the plain PyTorch NTT for tensors on the CPU.

The mp axis of a mesh (parallel/mesh.py). With `Evaluator.shard` set (a
RowShard), rank m of the mp group owns the QP rows whose global prime index
g has g % mp == m: a cyclic split, so every rank keeps rows as levels drop
the top Q rows. Its key-switch keys hold only those rows (`shard_key`,
crypto/keys.py); ModUp extends each digit only into its owned target rows
and takes their NTT; the key inner product (`_ks_inner`, `_rot_mac_tap`, the
masks' rows too) runs on them; then ONE all-gather per key switch brings
both accumulators of every rank together (`_gather_qp`), interleaved back
into QP row order, and ModDown runs replicated. Everything else (pointwise
ops, rescale, the automorphism, the Q-row NTTs) is replicated within the mp
group. Without a shard every op is the unsharded one, launch for launch.

The reference's jit wrappers and table "pack" have no counterpart: device
tables are cached once per Evaluator. Where the reference adds terms one by
one with add_mod, the port sums canonical residues in int64 and reduces
once, which gives the same residue.
"""

import numpy as np
import torch
import torch.distributed as dist

from .cuda.ntt_kernel import ntt_cuda
from .encoding import INT64_BOUND
from .modmath import add_mod, sub_mod, neg_mod, mul_mod, host_shoup
from .ntt import ntt_fwd, ntt_inv
from .params import to_dev, upload


def _sum_mod(terms, q, dim=0):
    """sum(terms) mod q over `dim` of canonical int64 residues -> int32."""
    return (terms.sum(dim) % q).to(torch.int32)


def _pad_rows(x, rows):
    """x [..., R, N] zero-padded to [..., rows, N] (x itself when R == rows)."""
    r = x.shape[-2]
    if r == rows:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-2] + (rows - r, x.shape[-1]))], dim=-2)


def _stack2(a, b):
    """The two polys of a ciphertext, each [..., nl, N] -> [..., 2, nl, N]."""
    return torch.stack([a, b], dim=-3)


class RowShard:
    """This rank's part of the QP rows on a mesh's mp axis: rank `rank` of
    `mp` owns the global prime rows g with g % mp == rank. group: the
    torch.distributed group of the mp axis (None: the shard computes its
    own rows and gathers nothing, which the shard-arithmetic checks use).
    `gathers` counts the all-gathers issued from Python (one recorded into a
    CUDA graph counts once, at capture)."""

    def __init__(self, mp, rank, group=None):
        if not 0 <= rank < mp:
            raise ValueError(f"rank {rank} is not on an mp axis of {mp}")
        self.mp, self.rank, self.group = mp, rank, group
        self.gathers = 0

    def all_gather(self, x):
        """[mp, *x.shape]: every rank's x, in rank order."""
        out = x.new_empty((self.mp * x.shape[0],) + tuple(x.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x.contiguous(), group=self.group)
        self.gathers += 1
        return out.view((self.mp,) + tuple(x.shape))


class Evaluator:
    """Op library bound to one CKKSContext (and its device); `shard` (a
    RowShard, None by default) splits the key switch's QP rows over the mp
    axis of a mesh (module docstring)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.n = ctx.n
        self.device = ctx.device
        self.shard = None
        self._tabs = {}      # (kind, rows) -> device tensor
        self._consts = {}    # id(host array) -> (array, device tensor)

    # ------------------------------------------------------- device tables
    def _c(self, arr):
        """Device copy of a long-lived host constant array (cached)."""
        hit = self._consts.get(id(arr))
        if hit is None or hit[0] is not arr:
            hit = self._consts[id(arr)] = (arr, to_dev(arr, self.device))
        return hit[1]

    def _q(self, rows):
        """int32 [len(rows), 1] moduli of the given rows."""
        key = ("q", tuple(rows))
        t = self._tabs.get(key)
        if t is None:
            q = self.ctx.host_tables["q"][np.asarray(key[1], dtype=np.int64)]
            t = self._tabs[key] = to_dev(q[:, None], self.device)
        return t

    def residues(self, coeffs, rows):
        """int32 [..., len(rows), N] residues of integer coefficients (numpy
        int64 [..., N]) mod the rows' primes, taken on the device: torch's
        remainder by a positive modulus gives the integers np.mod does (the
        host encoder's and key generator's). Keys and encodes at load use
        it: the host's per-prime np.mod was most of their time."""
        c = upload(torch.from_numpy(np.ascontiguousarray(coeffs, dtype=np.int64)), self.device)
        return (c.unsqueeze(-2) % self._q(rows).to(torch.int64)).to(torch.int32)

    def encoded_residues(self, encoder, prod, rows):
        """int32 [..., len(rows), N] residues of an encode's float64 scaled
        coefficients mod the rows' primes, the integers the encoder's
        _rns_residues gives: rounded and reduced on the device (residues)
        where every one is below INT64_BOUND, its int64 branch; else its
        mantissa/exponent branch, reduced on the device too
        (big_residues)."""
        if prod.size == 0 or np.abs(prod).max() < INT64_BOUND:
            return self.residues(np.round(prod).astype(np.int64), rows)
        return self.big_residues(prod, rows)

    # elements of one int64 temporary of big_residues (2^26: 512 MB)
    BIG_RESIDUES_ELEMS = 1 << 26

    def big_residues(self, prod, rows):
        """int32 [..., len(rows), N] residues of float64 coefficients some of
        which pass INT64_BOUND, the integers Encoder._rns_residues gives for
        them: each split on the host as there, prod = mi * 2^k with |mi| <=
        2^53 (rounded where k < 0), and reduced on the device as (mi mod q) *
        (2^k mod q) mod q, every product below 2^62. A bootstrap's diagonals
        encode at ~2^60 and take this branch: on the host, one prime at a
        time, it was most of a plane's encode (a native bootstrap under a
        plane bound of 0 encodes 1,332 planes again)."""
        prod = np.asarray(prod, dtype=np.float64)
        if not np.isfinite(np.abs(prod).max()):
            raise OverflowError("encode: scale overflows float64 range")
        mant, ex = np.frexp(prod)
        mi = np.round(mant * 2.0 ** 53).astype(np.int64)       # prod = mi * 2^k
        k = (ex - 53).astype(np.int64)
        small = k < 0                                          # |prod| < 2^53
        c_small = np.round(np.where(small, prod, 0.0)).astype(np.int64)
        kmax = int(k.max())
        primes = np.asarray([int(self.ctx.primes[r]) for r in rows], dtype=np.int64)
        powtab = np.empty((len(primes), kmax + 1), dtype=np.int64)   # 2^j mod q
        powtab[:, 0] = 1
        for j in range(1, kmax + 1):
            powtab[:, j] = powtab[:, j - 1] * 2 % primes
        dev = lambda a: upload(torch.from_numpy(np.ascontiguousarray(a)), self.device)
        n = prod.shape[-1]
        flat = [dev(a.reshape(-1, n)) for a in (mi, np.clip(k, 0, None), small, c_small)]
        pw_tab = dev(powtab)
        q = self._q(rows).to(torch.int64)                      # [R, 1]
        out = torch.empty((flat[0].shape[0], len(primes), n), dtype=torch.int32,
                          device=self.device)
        step = max(1, self.BIG_RESIDUES_ELEMS // (len(primes) * n))
        for i in range(0, out.shape[0], step):
            m, kc, sm, cs = (t[i: i + step, None, :] for t in flat)     # [b, 1, N]
            pw = pw_tab[:, kc[:, 0, :]].transpose(0, 1)                 # [b, R, N]
            out[i: i + step] = torch.where(sm, cs % q, m % q * pw % q).to(torch.int32)
        return out.reshape(prod.shape[:-1] + (len(primes), n))

    def _rows(self, rows):
        """Row-index tensor of the NTT: int32 (kernel) or int64 (plain)."""
        key = ("rows", tuple(rows))
        t = self._tabs.get(key)
        if t is None:
            dtype = torch.int32 if self.device.type == "cuda" else torch.int64
            t = self._tabs[key] = upload(torch.tensor(key[1], dtype=dtype), self.device)
        return t

    def _perm(self, name):
        t = self._tabs.get(name)
        if t is None:
            t = self._tabs[name] = upload(torch.from_numpy(
                getattr(self.ctx, name).astype(np.int64)), self.device)
        return t

    # ---------------------------------------------------------------- NTT
    def _ntt(self, x, rows, inverse=False):
        """NTT/iNTT of x int32 [..., R, N] with R = len(rows): plane r of
        the last two axes uses prime rows[r], whatever the leading (batch)
        axes. The planes go to one kernel call as [prod(...) * R, N] with
        the row list tiled. The orbit reorder is a gather on the kernel
        boundary."""
        shape = x.shape
        rows = tuple(rows)
        if rows:
            rows *= x.numel() // (len(rows) * self.n)
        x = x.reshape(-1, self.n)
        if inverse:
            x = x[..., self._perm("orbit_inv")]          # orbit -> kernel order
        idx = self._rows(rows)
        tab = self.ctx.dev
        if x.device.type == "cuda":
            out = ntt_cuda(x.contiguous(), idx, tab, inverse)
        elif inverse:
            out = ntt_inv(x, tab["itw"][idx], tab["q"][idx][:, None],
                          tab["ninv"][idx][:, None])
        else:
            out = ntt_fwd(x, tab["tw"][idx], tab["q"][idx][:, None])
        if not inverse:
            out = out[..., self._perm("orbit_perm")]     # kernel -> orbit order
        return out.reshape(shape)

    def ntt(self, x, rows):
        return self._ntt(x, rows, False)

    def intt(self, x, rows):
        return self._ntt(x, rows, True)

    # ---------------------------------------------------- pointwise basics
    def add_ct(self, a, b, nl):
        return add_mod(a, b, self._q(range(nl)))

    def sub_ct(self, a, b, nl):
        return sub_mod(a, b, self._q(range(nl)))

    def neg_ct(self, a, nl):
        return neg_mod(a, self._q(range(nl)))

    def add_pt(self, ct, pt, nl):
        return _stack2(add_mod(ct[..., 0, :, :], pt, self._q(range(nl))),
                       ct[..., 1, :, :])

    def mul_pt(self, ct, pt, nl):
        return mul_mod(ct, pt, self._q(range(nl)))

    def scalar_rows(self, k: int, nl: int):
        """Host (residue, shoup) uint32 [2, nl] of an integer multiplier K
        against the bottom nl q-rows — the argument of upscale_res and
        upscale_rescale_res (K = 2^bits, or vm/steer.py's corrected K)."""
        vals = [k % q for q in self.ctx.q_primes[:nl]]
        sh = [host_shoup(v, q) for v, q in zip(vals, self.ctx.q_primes[:nl])]
        return np.stack([np.array(vals, np.uint32), np.array(sh, np.uint32)])

    # ------------------------------------------- compact plaintext decode
    def decode_plain(self, lohi, rows):
        """Compact plaintexts -> NTT-domain planes, on the Evaluator's
        device (reference ops.py:296-307). lohi: int32 [B, 2, N], the bits
        of Encoder.encode_compact_batch's uint32 records; rows: the target
        prime rows. Returns int32 [B, len(rows), N] in orbit order."""
        if lohi.dim() != 3 or lohi.shape[1] != 2 or lohi.shape[2] != self.n:
            raise ValueError(f"decode_plain takes [B, 2, {self.n}] records, "
                             f"got {tuple(lohi.shape)}")
        if lohi.dtype != torch.int32 or lohi.device.type != self.device.type:
            raise ValueError(f"decode_plain takes int32 records on the {self.device.type} "
                             f"device, got {lohi.dtype} on {lohi.device}")
        return self._decode_plain(lohi, rows)

    def decode_tables(self, rows, b=None):
        """The device tables a decode of plaintexts to `rows` reads: q and
        2^k mod q of each row, made at first use; with b, also the NTT's
        row index of b plaintexts (the executor makes every decode group's
        before capturing the graphs that decode in-graph)."""
        rows = tuple(rows)
        key = ("dec", rows)
        tabs = self._tabs.get(key)
        if tabs is None:
            ix = np.asarray(rows, dtype=np.int64)
            ht = self.ctx.host_tables
            tabs = self._tabs[key] = (
                upload(torch.from_numpy(ht["q"][ix].astype(np.int64)[:, None]), self.device),
                upload(torch.from_numpy(ht["pow2"][ix].astype(np.int64)), self.device))
        if b is not None:
            self._rows(rows * b)
        return tabs

    def _decode_plain(self, lohi, rows):
        """Each coefficient is sign * (hi_abs * 2^32 + lo) * 2^k (row 0: lo;
        row 1: hi_abs in bits 0-22, sign in bit 23, k in bits 24-31): its
        residue mod each q_r, then one forward NTT over all B * R planes.
        The reference's Barrett and Montgomery steps on uint32 give the
        canonical residue, which int64 `%` gives directly; the words are
        masked to their uint32 value first, so no shift sees a sign."""
        rows = tuple(rows)
        q, pow2 = self.decode_tables(rows)              # [R, 1], [R, 256]
        b = lohi.shape[0]
        w = lohi.to(torch.int64) & 0xFFFFFFFF
        lo, hi = w[:, 0, None, :], w[:, 1, None, :]     # [B, 1, N]
        val = (((hi & 0x7FFFFF) << 32) | lo) % q        # [B, R, N]; |mi| < 2^55
        val = torch.where(((hi >> 23) & 1).bool() & (val != 0), q - val, val)
        # 2^k mod q_r, gathered per coefficient: [R, B*N], no [B, R, 256]
        p2k = pow2.index_select(1, (hi >> 24).reshape(-1))
        val = val * p2k.view(len(rows), b, self.n).transpose(0, 1) % q
        return self._ntt(val.to(torch.int32), rows)

    def upscale_res(self, ct, nl, ccs):
        """Multiply by the per-row scalar ccs[0] (ccs: int32 [2, nl])."""
        return mul_mod(ct, ccs[0][:, None], self._q(range(nl)))

    def upscale(self, ct, nl, up_bits: int):
        """Exact multiply by 2^up_bits (the native bootstrap's input
        pre-upscale and Chebyshev doubling); the multiplier's rows are
        cached on the device, so a bootstrap graph's capture uploads
        nothing."""
        key = ("up", up_bits, nl)
        ccs = self._tabs.get(key)
        if ccs is None:
            ccs = self._tabs[key] = to_dev(self.scalar_rows(1 << up_bits, nl), self.device)
        return self.upscale_res(ct, nl, ccs)

    def upscale_rescale_res(self, ct, nl, ccs, k: int):
        """Scalar multiply followed by a k-row rescale."""
        return self.rescale_k(self.upscale_res(ct, nl, ccs), nl, k)

    def mod_drop(self, ct, k: int):
        """modswitch by k rows = drop the top k RNS rows (SEAL semantics)."""
        return ct[..., : ct.shape[-2] - k, :]

    # -------------------------------------------------------------- rescale
    def rescale_k(self, x, nl, k: int):
        """Drop the k top rows with exact division (composite rescale)."""
        for i in range(k):
            x = self.rescale(x, nl - i)
        return x

    def rescale(self, ct, nl):
        """Divide by the top prime q_{nl-1}: exact RNS rescale with a
        centered lift (reference ops._rescale)."""
        lc = self.ctx.level(nl)
        rows_lo = list(range(nl - 1))
        top_c = self._ntt(ct[..., nl - 1, :], [nl - 1] * 2, inverse=True)
        # centered lift: v' = v or v - q_top, as a residue mod q_i; q_top may
        # exceed q_i (q_top < 2 q_i), so reduce v first, then add the
        # precomputed correction (q_i - q_top mod q_i)
        q = self._q(rows_lo)                         # [nl-1, 1]
        v = top_c[..., None, :]                      # [..., 2, 1, N]
        vm = torch.where(v >= q, v - q, v)
        r2 = add_mod(vm, self._c(lc.rs_diff)[:, None], q)
        lifted = torch.where(v > lc.rs_half, r2, vm)  # [..., 2, nl-1, N]
        conv = self._ntt(lifted, rows_lo)
        num = sub_mod(ct[..., : nl - 1, :], conv, q)
        return mul_mod(num, self._c(lc.rs_inv)[:, None], q)

    # ---------------------------------------------------------- keyswitch
    def _sp_rows(self):
        cfg = self.ctx.config
        return [cfg.num_q + i for i in range(cfg.alpha)]

    def modup(self, c_ntt, nl):
        """ModUp decomposition of `c_ntt` (int32 [..., nl, N], NTT domain)
        -> int32 [..., dnum_active, R, N] digit planes over Q^{(nl)}P in
        NTT domain (hybrid key switching with approximate base conversion;
        see params.py), R = nl + alpha, or under a row shard this rank's R
        rows of it, in QP order (`own_rows`). Rotations of one ciphertext
        share it (hoisting)."""
        lc = self.ctx.level(nl)
        c_coeff = self._ntt(c_ntt, range(nl), inverse=True)
        # every group's coeff-domain extension, then ONE batched NTT
        exts, targets, parts = [], [], []
        for gi, g in enumerate(lc.groups):
            lo, hi = g.rows[0], g.rows[-1] + 1
            u = mul_mod(c_coeff[..., lo:hi, :], self._c(g.t_coef)[:, None],
                        self._q(g.rows))
            tg, m, own, k_lo = self._modup_group(nl, gi, g)
            tq = self._q(tg)                         # [T, 1]
            exts.append(_sum_mod(
                u.to(torch.int64)[..., None, :] * m[:, :, None] % tq, tq, dim=-3))
            targets.extend(tg)
            parts.append((g, own, k_lo, len(tg)))
        ext_ntt = self._ntt(torch.cat(exts, dim=-2), targets)
        digits = []
        off = 0
        for g, own, k_lo, nt in parts:
            ext = ext_ntt[..., off: off + nt, :]
            off += nt
            # own planes stay in NTT domain, scaled by S
            local = slice(own.start - g.rows[0], None, own.step)
            own_p = mul_mod(c_ntt[..., own, :], self._c(g.s_ntt)[local][:, None],
                            self._q(g.rows[local]))
            # targets are Q rows [0, lo) and [hi, nl), then the specials:
            # so the digit in Q^{(nl)}P row order is ext[:lo] | own | ext[lo:]
            digits.append(torch.cat([ext[..., :k_lo, :], own_p, ext[..., k_lo:, :]], dim=-2))
        return torch.stack(digits, dim=-3)

    def _modup_group(self, nl, gi, g):
        """Group gi's ModUp extension at nl rows: (target rows, basis
        conversion table [g, T] int64, slice of its own rows, the count of
        target rows before them). Under a row shard, only this rank's
        target rows and columns, and its own rows (a strided slice)."""
        lo, hi = g.rows[0], g.rows[-1] + 1
        sh = self.shard
        if sh is None:
            return g.targets, self._c(g.m).to(torch.int64), slice(lo, hi), lo
        key = ("modup", nl, gi, sh.mp, sh.rank)
        hit = self._tabs.get(key)
        if hit is None:
            cols = [i for i, t in enumerate(g.targets) if t % sh.mp == sh.rank]
            m = np.ascontiguousarray(g.m[:, cols])
            hit = self._tabs[key] = (
                [g.targets[i] for i in cols],
                upload(torch.from_numpy(m.astype(np.int64)), self.device),
                slice(lo + (sh.rank - lo) % sh.mp, hi, sh.mp),
                len(range(sh.rank, lo, sh.mp)))
        return hit

    # ------------------------------------------------------ the row shard
    def key_rows(self):
        """Rows of a key-switch key on this rank: num_all, or its shard's."""
        cfg = self.ctx.config
        sh = self.shard
        return cfg.num_all if sh is None else len(range(sh.rank, cfg.num_all, sh.mp))

    def shard_key(self, key):
        """This rank's rows of a key-switch key [dnum, 2, num_all, N] (a
        tensor or a host array), a copy, so the full key can be freed; the
        key itself without a shard."""
        sh = self.shard
        if sh is None:
            return key
        part = key[:, :, sh.rank::sh.mp]
        return part.contiguous() if isinstance(part, torch.Tensor) else np.ascontiguousarray(part)

    def _own_slices(self, nl):
        """This rank's positions in Q^{(nl)}P order: (Q slice, special
        slice), the global rows g < nl and num_q <= g with g % mp == rank."""
        sh = self.shard
        nq = self.ctx.config.num_q
        mp, r = (1, 0) if sh is None else (sh.mp, sh.rank)
        return slice(r, nl, mp), slice(nl + (r - nq) % mp, None, mp)

    def own_rows(self, x, nl):
        """This rank's rows of x [..., nl + alpha, N] in Q^{(nl)}P order
        (x itself without a shard)."""
        if self.shard is None:
            return x
        qs, ps = self._own_slices(nl)
        return torch.cat([x[..., qs, :], x[..., ps, :]], dim=-2)

    def _own_globals(self, nl):
        """The global prime rows of own_rows, in order."""
        qs, ps = self._own_slices(nl)
        sp = self._sp_rows()
        return list(range(nl))[qs] + sp[ps.start - nl::ps.step]

    def _shard_layout(self, nl):
        """(rows each rank owns at most, int64 index of Q^{(nl)}P order into
        the ranks' padded rows laid end to end) of the mp axis at nl."""
        sh = self.shard
        key = ("layout", nl, sh.mp)
        hit = self._tabs.get(key)
        if hit is None:
            nq, alpha = self.ctx.config.num_q, self.ctx.config.alpha
            glob = list(range(nl)) + [nq + i for i in range(alpha)]
            owned = [[g for g in glob if g % sh.mp == r] for r in range(sh.mp)]
            rmax = max(map(len, owned))
            idx = [(g % sh.mp) * rmax + owned[g % sh.mp].index(g) for g in glob]
            hit = self._tabs[key] = (rmax, upload(torch.tensor(idx, dtype=torch.int64),
                                                  self.device))
        return hit

    def assemble_rows(self, parts, nl):
        """Q^{(nl)}P rows [..., nl + alpha, N] from every rank's own_rows
        part (parts[r]: rank r's [..., R_r, N], or all of them stacked and
        padded to the same R): the interleave that follows the all-gather."""
        rmax, idx = self._shard_layout(nl)
        if not isinstance(parts, torch.Tensor):
            parts = torch.stack([_pad_rows(p, rmax) for p in parts])
        x = parts.movedim(0, -3)
        x = x.reshape(x.shape[:-3] + (-1, self.n))
        return x.index_select(-2, idx)

    def _gather_qp(self, x0, x1, nl):
        """Both key-switch accumulators over all of Q^{(nl)}P from this
        rank's rows of them: one all-gather over the mp group, issued
        whatever its size. Without a shard, x0 and x1 themselves."""
        sh = self.shard
        if sh is None:
            return x0, x1
        rmax, _ = self._shard_layout(nl)
        full = self.assemble_rows(sh.all_gather(_pad_rows(torch.stack([x0, x1]), rmax)), nl)
        return full[0], full[1]

    def _ks_inner(self, digits, nl, ksk):
        """Inner product of ModUp digits [..., nd, R, N] with a key-switch
        key -> (acc0, acc1) int32 [..., R, N] over the QP basis (R = nl +
        alpha, or this rank's rows of them under a row shard, with the
        key's shard)."""
        nd = digits.shape[-3]
        qs, _ = self._own_slices(nl)
        n_lo = len(range(qs.start, nl, qs.step))              # own Q rows < nl
        n_q = len(range(qs.start, self.ctx.config.num_q, qs.step))
        q = self._q(self._own_globals(nl))
        k = torch.cat([ksk[:nd, :, :n_lo], ksk[:nd, :, n_q:]], dim=2)
        d = digits.to(torch.int64)
        acc0 = _sum_mod(d * k[:, 0].to(torch.int64) % q, q, dim=-3)
        acc1 = _sum_mod(d * k[:, 1].to(torch.int64) % q, q, dim=-3)
        return acc0, acc1

    def _mod_down_pair(self, x0, x1, nl):
        """ModDown P -> Q^{(nl)} of both keyswitch halves [..., nl + alpha,
        N], batched."""
        lc = self.ctx.level(nl)
        sp_rows = self._sp_rows()
        xp_c = self._ntt(_stack2(x0[..., nl:, :], x1[..., nl:, :]), sp_rows,
                         inverse=True)
        u = mul_mod(xp_c, self._c(lc.md_t)[:, None],
                    self._q(sp_rows))                # [..., 2, alpha, N]
        q = self._q(range(nl))
        md_m = self._c(lc.md_m).to(torch.int64)      # [alpha, nl]
        conv = _sum_mod(u.to(torch.int64)[..., None, :] * md_m[:, :, None] % q,
                        q, dim=-3)                   # [..., 2, nl, N]
        conv = self._ntt(conv, range(nl))
        pv = self._c(lc.pinv)[:, None]
        out0 = mul_mod(sub_mod(x0[..., :nl, :], conv[..., 0, :, :], q), pv, q)
        out1 = mul_mod(sub_mod(x1[..., :nl, :], conv[..., 1, :, :], q), pv, q)
        return out0, out1

    def keyswitch(self, c_ntt, nl, ksk):
        """Switch the key under `c_ntt` (int32 [..., nl, N]) -> (b_add,
        a_add)."""
        acc0, acc1 = self._ks_inner(self.modup(c_ntt, nl), nl, ksk)
        return self._mod_down_pair(*self._gather_qp(acc0, acc1, nl), nl)

    # ------------------------------------------------------------ mul / rot
    def mul_ct(self, a, b, nl, rlk):
        """ct * ct multiply + relinearization."""
        q = self._q(range(nl))
        a0, a1 = a.unbind(-3)
        b0, b1 = b.unbind(-3)
        d0 = mul_mod(a0, b0, q)
        d1 = add_mod(mul_mod(a0, b1, q), mul_mod(a1, b0, q), q)
        ks0, ks1 = self.keyswitch(mul_mod(a1, b1, q), nl, rlk)
        return _stack2(add_mod(d0, ks0, q), add_mod(d1, ks1, q))

    def square_ct(self, a, nl, rlk):
        """ct * ct of one ciphertext with itself + relinearization."""
        q = self._q(range(nl))
        a0, a1 = a.unbind(-3)
        d0 = mul_mod(a0, a0, q)
        d1 = mul_mod(a0, a1, q)
        d1 = add_mod(d1, d1, q)
        ks0, ks1 = self.keyswitch(mul_mod(a1, a1, q), nl, rlk)
        return _stack2(add_mod(d0, ks0, q), add_mod(d1, ks1, q))

    def automorphism(self, planes, shift: int):
        """Slot-rotation automorphism in the orbit layout: roll each half of
        the last axis by -shift."""
        s = self.n // 2
        shp = planes.shape
        v = planes.reshape(shp[:-1] + (2, s))
        return torch.roll(v, -int(shift), dims=-1).reshape(shp)

    def conj_apply(self, planes):
        """Conjugation automorphism in the orbit layout: half swap."""
        s = self.n // 2
        shp = planes.shape
        return planes.reshape(shp[:-1] + (2, s)).flip(-2).reshape(shp)

    def rotate(self, ct, nl, steps: int, gk):
        """Left-rotate slots by `steps` with the galois key for that step."""
        shift = steps % (self.n // 2)
        c0, c1 = ct.unbind(-3)
        c0p = self.automorphism(c0, shift)
        ks0, ks1 = self.keyswitch(self.automorphism(c1, shift), nl, gk)
        return _stack2(add_mod(c0p, ks0, self._q(range(nl))), ks1)

    def conjugate(self, ct, nl, ck):
        """Complex-conjugate the slots (automorphism X -> X^{-1})."""
        c0, c1 = ct.unbind(-3)
        ks0, ks1 = self.keyswitch(self.conj_apply(c1), nl, ck)
        return _stack2(add_mod(self.conj_apply(c0), ks0, self._q(range(nl))), ks1)

    # ------------------------------------------------- hoisted rotation bank
    def rotate_apply(self, digits, c0, nl, shifts, gks):
        """K rotations from the hoisted ModUp digits of c1 (σ commutes with
        ModUp). shifts: K ints; gks: K keys. Returns int32 [K, ..., 2, nl,
        N]: the rotation axis leads, so entry k is rotation k of the whole
        batch."""
        q = self._q(range(nl))
        outs = []
        for shift, gk in zip(shifts, gks):
            acc0, acc1 = self._ks_inner(self.automorphism(digits, shift), nl, gk)
            b, a = self._mod_down_pair(*self._gather_qp(acc0, acc1, nl), nl)
            outs.append(_stack2(add_mod(self.automorphism(c0, shift), b, q), a))
        return torch.stack(outs)

    def rotate_batch(self, ct, nl, shifts, gks):
        """K rotations of ONE ciphertext (or of each in a batch) sharing a
        single ModUp of c1 (Halevi-Shoup hoisting). Returns int32 [K, ...,
        2, nl, N], the rotation axis first."""
        c0, c1 = ct.unbind(-3)
        return self.rotate_apply(self.modup(c1, nl), c0, nl, shifts, gks)

    # ------------------------------------------------ fused conv bank (MAC)
    def rot_mac(self, ct, nl, shifts, gks, pts, extras=(), fold_rescale_rows=0,
                extras_post=False, digits=None, plain_vals=(), plain_pts=()):
        """sum_k pts[k] * rot_{shifts[k]}(ct) (+ extras): the hoisted bank.

        ONE ModUp of ct[1] serves every rotation, and ModDown runs ONCE per
        group (lazy ModDown): the masks multiply the keyswitch accumulators
        in the extended Q^{(nl)}P basis. pts: K int32 [nl + alpha, N]
        planes; extras: ciphertext addends at the product's (level, scale);
        plain_vals/plain_pts: keyswitch-free taps (mask times ciphertext).
        Returns [..., 2, nl - fold_rescale_rows, N]."""
        k = len(shifts) if shifts is not None else 0
        if digits is None and k:
            digits = self.modup(ct[..., 1, :, :], nl)
        accs = None
        for i in range(k):
            accs = self._rot_mac_tap(digits, ct[..., 0, :, :], shifts[i], gks[i],
                                     pts[i], nl, accs)
        return self._rot_mac_fin(accs, plain_vals, plain_pts, extras, nl,
                                 fold_rescale_rows, extras_post)

    def _rot_mac_tap(self, digits, c0, shift, gk, pt, nl, accs=None):
        """One tap of the bank (the reference's _rot_mac_chunk, vmapped over
        a chunk of taps, is this loop body)."""
        kq = self._q(range(nl))
        kqp = self._q(self._own_globals(nl))
        a0, a1 = self._ks_inner(self.automorphism(digits, shift), nl, gk)
        rc = mul_mod(self.automorphism(c0, shift), pt[:nl], kq)
        pto = self.own_rows(pt, nl)
        r0 = mul_mod(a0, pto, kqp)
        r1 = mul_mod(a1, pto, kqp)
        if accs is not None:
            rc = add_mod(rc, accs[0], kq)
            r0 = add_mod(r0, accs[1], kqp)
            r1 = add_mod(r1, accs[2], kqp)
        return rc, r0, r1

    def _rot_mac_fin(self, accs, plain_vals, plain_pts, extras, nl, rs_rows,
                     extras_post):
        """Finish a group: one ModDown of the accumulators, the plain taps,
        then the folded rescale. extras_post: extras join AFTER the rescale
        (the PARS per-tap-rescale shape)."""
        q = self._q(range(nl))
        out = None
        if accs is not None:
            rc, r0, r1 = accs
            b, a = self._mod_down_pair(*self._gather_qp(r0, r1, nl), nl)
            out = _stack2(add_mod(rc, b, q), a)
        if plain_vals:
            vs = torch.stack(list(plain_vals)).to(torch.int64)   # [J, ..., 2, nl, N]
            ps = torch.stack(list(plain_pts)).to(torch.int64)    # [J, nl, N]
            ps = ps.reshape(ps.shape[:1] + (1,) * (vs.dim() - 3) + ps.shape[1:])
            s = _sum_mod(vs * ps % q, q)
            out = s if out is None else add_mod(out, s, q)
        if not extras_post:
            for e in extras:
                out = add_mod(out, e, q)
        if rs_rows:
            out = self.rescale_k(out, nl, rs_rows)
        if extras_post:
            q2 = self._q(range(nl - rs_rows))
            for e in extras:
                out = add_mod(out, e, q2)
        return out
