"""CKKS evaluator primitives over RNS limb planes (PyTorch).

Port of dacapo_tpu/crypto/ops.py, limited to what the MLP path runs. Every
op is a plain function of tensors; the level and scale metadata is handled
by the caller (vm/executor.py), as SEAL tracks ciphertext.scale().

Ciphertext polys: int32 [2, nl, N] in NTT domain, rows = Q primes 0..nl-1.
Plaintext:        int32 [nl, N] in NTT domain.
Key-switch keys:  int32 [dnum, 2, num_all, N] (NTT domain, full QP basis).

NTT-domain planes are in ORBIT ORDER (params.CKKSContext.orbit_perm): the
fixed reorder is a gather at the NTT boundary (`_ntt`), so a slot rotation is
a roll of each half. The NTT itself is the hand-written CUDA kernel for
tensors on the card and the plain PyTorch NTT for tensors on the CPU.

The reference's jit wrappers and table "pack" have no counterpart: device
tables are cached once per Evaluator. Where the reference adds terms one by
one with add_mod, the port sums canonical residues in int64 and reduces
once, which gives the same residue.
"""

import numpy as np
import torch

from .cuda.ntt_kernel import ntt_cuda
from .modmath import add_mod, sub_mod, neg_mod, mul_mod, host_shoup
from .ntt import ntt_fwd, ntt_inv
from .params import to_dev


def _sum_mod(terms, q):
    """sum(terms) mod q over dim 0 of canonical int64 residues -> int32."""
    return (terms.sum(0) % q).to(torch.int32)


class Evaluator:
    """Op library bound to one CKKSContext (and its device)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.n = ctx.n
        self.device = ctx.device
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

    def _rows(self, rows):
        """Row-index tensor of the NTT: int32 (kernel) or int64 (plain)."""
        key = ("rows", tuple(rows))
        t = self._tabs.get(key)
        if t is None:
            dtype = torch.int32 if self.device.type == "cuda" else torch.int64
            t = self._tabs[key] = torch.tensor(key[1], dtype=dtype,
                                               device=self.device)
        return t

    def _perm(self, name):
        t = self._tabs.get(name)
        if t is None:
            t = self._tabs[name] = torch.from_numpy(
                getattr(self.ctx, name).astype(np.int64)).to(self.device)
        return t

    # ---------------------------------------------------------------- NTT
    def _ntt(self, x, rows, inverse=False):
        """NTT/iNTT of x int32 [B, N]; row b of x uses prime rows[b]. The
        orbit reorder is a gather on the kernel boundary."""
        rows = tuple(rows)
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
        return out

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
        return torch.stack([add_mod(ct[0], pt, self._q(range(nl))), ct[1]])

    def mul_pt(self, ct, pt, nl):
        return mul_mod(ct, pt, self._q(range(nl)))

    def scalar_rows(self, k: int, nl: int):
        """Host (residue, shoup) uint32 [2, nl] of an integer multiplier K
        against the bottom nl q-rows — the argument of upscale_res and
        upscale_rescale_res (K = 2^bits, or vm/steer.py's corrected K)."""
        vals = [k % q for q in self.ctx.q_primes[:nl]]
        sh = [host_shoup(v, q) for v, q in zip(vals, self.ctx.q_primes[:nl])]
        return np.stack([np.array(vals, np.uint32), np.array(sh, np.uint32)])

    def upscale_res(self, ct, nl, ccs):
        """Multiply by the per-row scalar ccs[0] (ccs: int32 [2, nl])."""
        return mul_mod(ct, ccs[0][:, None], self._q(range(nl)))

    def upscale_rescale_res(self, ct, nl, ccs, k: int):
        """Scalar multiply followed by a k-row rescale."""
        return self.rescale_k(self.upscale_res(ct, nl, ccs), nl, k)

    def mod_drop(self, ct, k: int):
        """modswitch by k rows = drop the top k RNS rows (SEAL semantics)."""
        return ct[:, : ct.shape[1] - k, :]

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
        top_c = self._ntt(ct[:, nl - 1, :], [nl - 1] * 2, inverse=True)
        # centered lift: v' = v or v - q_top, as a residue mod q_i; q_top may
        # exceed q_i (q_top < 2 q_i), so reduce v first, then add the
        # precomputed correction (q_i - q_top mod q_i)
        q = self._q(rows_lo)                         # [nl-1, 1]
        v = top_c[:, None, :]                        # [2, 1, N]
        vm = torch.where(v >= q, v - q, v)
        r2 = add_mod(vm, self._c(lc.rs_diff)[:, None], q)
        lifted = torch.where(v > lc.rs_half, r2, vm)  # [2, nl-1, N]
        conv = self._ntt(lifted.reshape(2 * (nl - 1), self.n), rows_lo * 2)
        num = sub_mod(ct[:, : nl - 1, :], conv.reshape(2, nl - 1, self.n), q)
        return mul_mod(num, self._c(lc.rs_inv)[:, None], q)

    # ---------------------------------------------------------- keyswitch
    def _sp_rows(self):
        cfg = self.ctx.config
        return [cfg.num_q + i for i in range(cfg.alpha)]

    def modup(self, c_ntt, nl):
        """ModUp decomposition of `c_ntt` (int32 [nl, N], NTT domain) ->
        int32 [dnum_active, nl + alpha, N] digit planes over Q^{(nl)}P in
        NTT domain (hybrid key switching with approximate base conversion;
        see params.py). Rotations of one ciphertext share it (hoisting)."""
        lc = self.ctx.level(nl)
        c_coeff = self._ntt(c_ntt, range(nl), inverse=True)
        # every group's coeff-domain extension, then ONE batched NTT
        exts, targets = [], []
        for g in lc.groups:
            lo, hi = g.rows[0], g.rows[-1] + 1
            u = mul_mod(c_coeff[lo:hi], self._c(g.t_coef)[:, None], self._q(g.rows))
            tq = self._q(g.targets)                  # [T, 1]
            m = self._c(g.m).to(torch.int64)         # [g, T]
            exts.append(_sum_mod(
                u.to(torch.int64)[:, None, :] * m[:, :, None] % tq, tq))
            targets.extend(g.targets)
        ext_ntt = self._ntt(torch.cat(exts), targets)
        digits = []
        off = 0
        for g in lc.groups:
            lo, hi = g.rows[0], g.rows[-1] + 1
            ext = ext_ntt[off: off + len(g.targets)]
            off += len(g.targets)
            # own planes stay in NTT domain, scaled by S
            own = mul_mod(c_ntt[lo:hi], self._c(g.s_ntt)[:, None], self._q(g.rows))
            # targets are Q rows [0, lo) and [hi, nl), then the specials:
            # so the digit in Q^{(nl)}P row order is ext[:lo] | own | ext[lo:]
            digits.append(torch.cat([ext[:lo], own, ext[lo:]]))
        return torch.stack(digits)

    def _ks_inner(self, digits, nl, ksk):
        """Inner product of ModUp digits with a key-switch key ->
        (acc0, acc1) int32 [nl + alpha, N] over the QP basis."""
        nd = digits.shape[0]
        num_q = self.ctx.config.num_q
        q = self._q(list(range(nl)) + self._sp_rows())
        k = torch.cat([ksk[:nd, :, :nl], ksk[:nd, :, num_q:]], dim=2)
        d = digits.to(torch.int64)
        acc0 = _sum_mod(d * k[:, 0].to(torch.int64) % q, q)
        acc1 = _sum_mod(d * k[:, 1].to(torch.int64) % q, q)
        return acc0, acc1

    def _mod_down_pair(self, x0, x1, nl):
        """ModDown P -> Q^{(nl)} of both keyswitch halves, batched."""
        lc = self.ctx.level(nl)
        alpha = self.ctx.config.alpha
        sp_rows = self._sp_rows()
        xp_c = self._ntt(torch.cat([x0[nl:], x1[nl:]]), sp_rows * 2, inverse=True)
        u = mul_mod(xp_c.reshape(2, alpha, self.n), self._c(lc.md_t)[:, None],
                    self._q(sp_rows))                # [2, alpha, N]
        q = self._q(range(nl))
        md_m = self._c(lc.md_m).to(torch.int64)      # [alpha, nl]
        conv = _sum_mod((u.to(torch.int64)[:, :, None, :]
                         * md_m[None, :, :, None] % q).transpose(0, 1), q)
        conv = self._ntt(conv.reshape(2 * nl, self.n), list(range(nl)) * 2)
        conv = conv.reshape(2, nl, self.n)
        pv = self._c(lc.pinv)[:, None]
        out0 = mul_mod(sub_mod(x0[:nl], conv[0], q), pv, q)
        out1 = mul_mod(sub_mod(x1[:nl], conv[1], q), pv, q)
        return out0, out1

    def keyswitch(self, c_ntt, nl, ksk):
        """Switch the key under `c_ntt` (int32 [nl, N]) -> (b_add, a_add)."""
        acc0, acc1 = self._ks_inner(self.modup(c_ntt, nl), nl, ksk)
        return self._mod_down_pair(acc0, acc1, nl)

    # ------------------------------------------------------------ mul / rot
    def mul_ct(self, a, b, nl, rlk):
        """ct * ct multiply + relinearization."""
        q = self._q(range(nl))
        d0 = mul_mod(a[0], b[0], q)
        d1 = add_mod(mul_mod(a[0], b[1], q), mul_mod(a[1], b[0], q), q)
        ks0, ks1 = self.keyswitch(mul_mod(a[1], b[1], q), nl, rlk)
        return torch.stack([add_mod(d0, ks0, q), add_mod(d1, ks1, q)])

    def automorphism(self, planes, shift: int):
        """Slot-rotation automorphism in the orbit layout: roll each half of
        the last axis by -shift."""
        s = self.n // 2
        shp = planes.shape
        v = planes.reshape(shp[:-1] + (2, s))
        return torch.roll(v, -int(shift), dims=-1).reshape(shp)

    def rotate(self, ct, nl, steps: int, gk):
        """Left-rotate slots by `steps` with the galois key for that step."""
        shift = steps % (self.n // 2)
        c0p = self.automorphism(ct[0], shift)
        ks0, ks1 = self.keyswitch(self.automorphism(ct[1], shift), nl, gk)
        return torch.stack([add_mod(c0p, ks0, self._q(range(nl))), ks1])

    # ------------------------------------------------- hoisted rotation bank
    def rotate_apply(self, digits, c0, nl, shifts, gks):
        """K rotations from the hoisted ModUp digits of c1 (σ commutes with
        ModUp). shifts: K ints; gks: K keys. Returns int32 [K, 2, nl, N]."""
        q = self._q(range(nl))
        outs = []
        for shift, gk in zip(shifts, gks):
            acc0, acc1 = self._ks_inner(self.automorphism(digits, shift), nl, gk)
            b, a = self._mod_down_pair(acc0, acc1, nl)
            outs.append(torch.stack(
                [add_mod(self.automorphism(c0, shift), b, q), a]))
        return torch.stack(outs)

    def rotate_batch(self, ct, nl, shifts, gks):
        """K rotations of ONE ciphertext sharing a single ModUp of ct[1]
        (Halevi-Shoup hoisting). Returns int32 [K, 2, nl, N]."""
        return self.rotate_apply(self.modup(ct[1], nl), ct[0], nl, shifts, gks)

    # ------------------------------------------------ fused conv bank (MAC)
    def rot_mac(self, ct, nl, shifts, gks, pts, extras=(), fold_rescale_rows=0,
                extras_post=False, digits=None, plain_vals=(), plain_pts=()):
        """sum_k pts[k] * rot_{shifts[k]}(ct) (+ extras): the hoisted bank.

        ONE ModUp of ct[1] serves every rotation, and ModDown runs ONCE per
        group (lazy ModDown): the masks multiply the keyswitch accumulators
        in the extended Q^{(nl)}P basis. pts: K int32 [nl + alpha, N]
        planes; extras: ciphertext addends at the product's (level, scale);
        plain_vals/plain_pts: keyswitch-free taps (mask times ciphertext).
        Returns [2, nl - fold_rescale_rows, N]."""
        k = len(shifts) if shifts is not None else 0
        if digits is None and k:
            digits = self.modup(ct[1], nl)
        accs = None
        for i in range(k):
            accs = self._rot_mac_tap(digits, ct[0], shifts[i], gks[i], pts[i],
                                     nl, accs)
        return self._rot_mac_fin(accs, plain_vals, plain_pts, extras, nl,
                                 fold_rescale_rows, extras_post)

    def _rot_mac_tap(self, digits, c0, shift, gk, pt, nl, accs=None):
        """One tap of the bank (the reference's _rot_mac_chunk, vmapped over
        a chunk of taps, is this loop body)."""
        kq = self._q(range(nl))
        kqp = self._q(list(range(nl)) + self._sp_rows())
        a0, a1 = self._ks_inner(self.automorphism(digits, shift), nl, gk)
        rc = mul_mod(self.automorphism(c0, shift), pt[:nl], kq)
        r0 = mul_mod(a0, pt, kqp)
        r1 = mul_mod(a1, pt, kqp)
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
            b, a = self._mod_down_pair(r0, r1, nl)
            out = torch.stack([add_mod(rc, b, q), a])
        if plain_vals:
            vs = torch.stack(list(plain_vals)).to(torch.int64)   # [J, 2, nl, N]
            ps = torch.stack(list(plain_pts)).to(torch.int64)    # [J, nl, N]
            s = _sum_mod(vs * ps[:, None] % q, q)
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
