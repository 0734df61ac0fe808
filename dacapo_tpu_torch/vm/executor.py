"""HEVM executor: interprets the bytecode stream over the PyTorch crypto layer.

Port of the per-op path of dacapo_tpu/vm/executor.py (the reference's
`jit=False` path): one Evaluator call per (fused) instruction, the
counterpart of the reference C++ VM dispatch loop
(lib/Runtime/SEAL_HEVM.cpp:336-401). A bootstrap calls the emulated oracle
(crypto/bootstrap.py). Segment capture, batching and plaintext streaming are
later slices: every plaintext stays resident on the device.

Runtime metadata ((nl, scale) per register) is tracked on the host like SEAL
tracks ciphertext.scale()/levels, including the reference's scale-forcing
semantics in addcc/addcp (SEAL_HEVM.cpp:297-310).
"""

import hashlib
import sys

import numpy as np
import torch

from ..crypto.bootstrap import Bootstrapper
from ..crypto.params import to_dev
from ..crypto.scheme import Ciphertext
from .fuse import ssa_expand, build_fuse_plan, OP_ROTMAC, OP_UPRESCALE, cipher_reads
from .hevm import (
    HEVMProgram, OP_ENCODE, OP_ROTATE, OP_NEGATE, OP_RESCALE, OP_MODSWITCH,
    OP_UPSCALE, OP_ADDCC, OP_ADDCP, OP_MULCC, OP_MULCP, OP_BOOTSTRAP, OP_ALLOC,
)
from .steer import steer_scales


class HEVMExecutor:
    # Galois keys beyond this fraction of the card's memory stay in host RAM
    # behind a device LRU (crypto/keys.GaloisStore).
    KEY_BUDGET_FRAC = 0.55
    NTT_BATCH = (64, 16, 4, 1)   # plaintexts per batched-NTT launch (per nl)

    def __init__(self, scheme, program: HEVMProgram, constants):
        """scheme: crypto.Scheme with keys; constants: list of f64 arrays (.cst)."""
        self.s = scheme
        self.ev = scheme.ev
        self.rr = scheme.ctx.config.rescale_rows   # RNS rows per hevm level
        self.prog = program
        self.constants = constants
        # SSA-expand the register stream, then fuse the rot-mac banks
        self.ops, self.num_regs, self.res_dst = ssa_expand(program)
        self.ops, self._fused_pt_regs, self.num_regs = build_fuse_plan(
            self.ops, self.num_regs, self.res_dst)
        self.plains = [None] * program.num_ptxt      # device planes
        self.plain_meta = [None] * program.num_ptxt  # (nl, scale)
        self._uk_cache = {}
        self._last_outputs = None
        self.bootstrapper = Bootstrapper(scheme) if any(
            op.opcode == OP_BOOTSTRAP for op in program.ops) else None
        self.n_keys = len({o for o in program.rotation_offsets() if o != 0})
        self.key_bytes = self.n_keys * scheme.galois_key_bytes()
        self._set_memory_budgets()
        self._prepare_keys()

    def _set_memory_budgets(self):
        dev = self.s.device
        if dev.type != "cuda":
            return
        _, total = torch.cuda.mem_get_info(dev)
        if self.key_bytes > self.KEY_BUDGET_FRAC * total:
            print(f"[hevm] galois keys {self.key_bytes >> 20} MiB exceed budget "
                  f"{int(self.KEY_BUDGET_FRAC * total) >> 20} MiB: "
                  "streaming keys from host (LRU)", file=sys.stderr)
            self.s.set_key_budget(int(self.KEY_BUDGET_FRAC * total))

    def _prepare_keys(self):
        self.s.ensure_galois([o for o in self.prog.rotation_offsets() if o != 0])

    # ------------------------------------------------------------ preprocess
    def preprocess(self):
        """Pre-encode all plaintexts offline (SEAL_HEVM.cpp:242-267):
        payload-identical encodes are deduplicated, device NTTs batched per
        level, and encode scales / upscale multipliers follow the scale
        steering solution (vm/steer.py)."""
        enc = self.s.encoder
        ctx = self.s.ctx
        alpha = ctx.config.alpha
        st = steer_scales(self.prog, [int(q) for q in ctx.q_primes], self.rr,
                          ctx.config.prime_bits)
        nq = ctx.config.num_q
        self.plain_bytes = 0
        self._steer_res = {opi: self.ev.scalar_rows(k, nq)
                           for opi, (k, _nl) in st.up_k.items()}
        self._steer_kf = {opi: float(k) for opi, (k, _nl) in st.up_k.items()}
        if st.forced or st.conflicts:
            worst = max(map(abs, st.forced.values()), default=0.0)
            print(f"[steer] {len(st.forced)} forced adds "
                  f"(worst dlog2 {worst:.2e}), "
                  f"{len(st.conflicts)} encode conflicts",
                  file=sys.stderr, flush=True)
        uniq = {}          # (rhs, payload digest, scale) -> cid
        cid_info = []      # cid -> (data, nl, scale)
        cid_regs = []      # cid -> [dst regs]
        for opi, op in enumerate(self.prog.ops):
            if op.opcode != OP_ENCODE:
                continue
            level = op.rhs >> 10
            nl = (level + 1) * self.rr
            sc = st.enc_scale.get(opi, float(2.0 ** (op.rhs & 0x3FF)))
            if op.lhs == 0xFFFF:
                data = np.ones(1)
                key = (op.rhs, b"ones", sc)
            else:
                data = np.ascontiguousarray(self.constants[op.lhs])
                key = (op.rhs, hashlib.sha1(data.tobytes()).digest(), sc)
            cid = uniq.get(key)
            if cid is None:
                cid = uniq[key] = len(cid_info)
                cid_info.append((data, nl, sc))
                cid_regs.append([])
            cid_regs[cid].append(op.dst)
            self.plain_meta[op.dst] = (nl, sc)

        # plaintexts feeding fused rot-mac banks need the extended Q^{(nl)}P
        # basis (lazy-ModDown masks): extra `alpha` special-prime rows
        cid_qp = [any(r in self._fused_pt_regs for r in regs) for regs in cid_regs]
        sp_rows = [nq + i for i in range(alpha)]
        # host-encode the unique payloads grouped by (nl, qp-extended): one
        # vectorized FFT per batch, then one prime-major NTT per batch
        by_grp = {}
        for cid, (_, nl, _) in enumerate(cid_info):
            by_grp.setdefault((nl, cid_qp[cid]), []).append(cid)
        for (nl, qp), cids in by_grp.items():
            rows_list = list(range(nl)) + (sp_rows if qp else [])
            primes = [ctx.primes[r] for r in rows_list] if qp else None
            nrows = len(rows_list)
            i = 0
            while i < len(cids):
                bsz = next(b for b in self.NTT_BATCH if b <= len(cids) - i)
                chunk = cids[i: i + bsz]
                blk = enc.encode_batch([cid_info[c][0] for c in chunk],
                                       [cid_info[c][2] for c in chunk], nl,
                                       primes=primes)        # [bsz, nrows, N]
                flat = np.ascontiguousarray(blk.transpose(1, 0, 2)).reshape(
                    bsz * nrows, -1)
                rows = [r for r in rows_list for _ in range(bsz)]
                out = self.ev.ntt(to_dev(flat, self.s.device), rows)
                out = out.reshape(nrows, bsz, -1).transpose(0, 1)
                for k, c in enumerate(chunk):
                    planes = out[k].contiguous()
                    self.plain_bytes += planes.nbytes
                    for dst in cid_regs[c]:
                        self.plains[dst] = planes
                i += bsz
        self.n_plains = len(cid_info)
        print(f"[hevm] {self.n_plains} unique plaintexts of "
              f"{sum(1 for o in self.prog.ops if o.opcode == OP_ENCODE)} "
              f"encodes: {self.plain_bytes} bytes resident; {self.n_keys} "
              f"galois keys: {self.key_bytes} bytes", file=sys.stderr, flush=True)

    def _plain(self, idx, nl):
        p = self.plains[idx]
        return p if nl is None else p[:nl]

    def _plain_rows_qp(self, full, reg, nl):
        """Q^{(nl)}P rows of a QP-encoded plaintext: first nl Q rows plus the
        alpha special rows stored after the encode-level Q rows."""
        nl_enc = self.plain_meta[reg][0]
        alpha = self.s.ctx.config.alpha
        return torch.cat([full[:nl], full[nl_enc: nl_enc + alpha]])

    # ------------------------------------------------------------ dispatch
    def _exec_stream(self, ops, ciphers, meta, out_regs):
        """Interpret the instruction stream over device tensors. Mutates
        `ciphers`/`meta`; returns the tensors of `out_regs`.

        Rotations run LAZILY: every `rotatec` of the same source joins a
        pending bank, flushed as ONE hoisted batched rotation
        (Evaluator.rotate_batch) the first time any of its results is read.
        """
        ev = self.ev
        galois = self.s.keys.galois
        rlk = self.s.keys.rlk
        banks_by_src = {}      # (id(src), nl) -> bank
        bank_of_dst = {}       # dst reg -> bank

        def flush(bank):
            entries = bank["entries"]
            steps = [st for _, st in entries]
            out = ev.rotate_batch(bank["src"], bank["nl"], steps,
                                  [galois[st] for st in steps])
            for k, (dst, _) in enumerate(entries):
                ciphers[dst] = out[k]
                del bank_of_dst[dst]
            banks_by_src.pop(bank["key"], None)

        def materialize(reg):
            bank = bank_of_dst.get(reg)
            if bank is not None:
                flush(bank)
            return ciphers[reg]

        # free values after their last read (the SSA stream would otherwise
        # hold every intermediate ciphertext live); out_regs always survive
        last_use = {}
        defined = set()
        for i, op in enumerate(ops):
            for r in cipher_reads(op, self.num_regs):
                last_use[r] = i
            if op.opcode not in (OP_ALLOC, OP_ENCODE):
                defined.add(op.rescale_dst if getattr(op, "fold_rescale", False)
                            else op.dst)
        keep = set(out_regs)
        # (src_reg, nl) -> (src tensor, digits): hoisted ModUp digits, pinned
        # and identity-checked so a rebound register misses
        dig_cache = {}

        def release(op, i):
            for r in cipher_reads(op, self.num_regs):
                if (last_use.get(r) == i and r not in keep and r in defined
                        and r in ciphers and r not in bank_of_dst):
                    del ciphers[r]

        for opi, op in enumerate(ops):
            oc = op.opcode
            if oc in (OP_ALLOC, OP_ENCODE):
                continue
            if oc == OP_ROTMAC:
                nl, ssc = meta[op.src] if op.src >= 0 else meta[op.plain_vals[0]]
                psc = self.plain_meta[(op.pt_regs or op.plain_pts)[0]][1]
                extras = [materialize(r) for r in op.extra]
                pvals = [materialize(r) for r in op.plain_vals]
                ppts = [self._plain(r, nl) for r in op.plain_pts]
                src = digits = shifts = None
                gks, pts = [], []
                if op.src >= 0:
                    src = materialize(op.src)
                    shifts = list(op.steps)
                    gks = [galois[st] for st in op.steps]
                    pts = [self._plain_rows_qp(self._plain(r, None), r, nl)
                           for r in op.pt_regs]
                    dkey = (op.src, nl)
                    hit = dig_cache.get(dkey)
                    if hit is not None and hit[0] is src:
                        digits = hit[1]
                        dig_cache[dkey] = dig_cache.pop(dkey)  # LRU touch
                    else:
                        digits = ev.modup(src[1], nl)
                        if len(dig_cache) >= 8:
                            dig_cache.pop(next(iter(dig_cache)))
                        dig_cache[dkey] = (src, digits)
                rs = self.rr if (op.fold_rescale or op.taps_rescaled) else 0
                out = ev.rot_mac(src, nl, shifts, gks, pts, extras,
                                 fold_rescale_rows=rs,
                                 extras_post=op.taps_rescaled, digits=digits,
                                 plain_vals=pvals, plain_pts=ppts)
                sc = ssc * psc
                dst = op.rescale_dst if op.fold_rescale else op.dst
                for _ in range(rs):
                    sc /= self.s.ctx.q_primes[nl - 1]
                    nl -= 1
                ciphers[dst] = out
                meta[dst] = (nl, sc)
                release(op, opi)
                continue
            if oc == OP_ROTATE:
                nl, sc = meta[op.lhs]
                src = materialize(op.lhs)
                if op.rhs == 0:
                    ciphers[op.dst] = src
                else:
                    key = (id(src), nl)
                    bank = banks_by_src.get(key)
                    if bank is None:
                        bank = banks_by_src[key] = {
                            "key": key, "src": src, "nl": nl, "entries": []}
                    bank["entries"].append((op.dst, op.rhs))
                    bank_of_dst[op.dst] = bank
                meta[op.dst] = (nl, sc)
                release(op, opi)
                continue
            if op.lhs < self.num_regs:
                materialize(op.lhs)
            if oc in (OP_ADDCC, OP_MULCC) and op.rhs < self.num_regs:
                materialize(op.rhs)
            if oc == OP_NEGATE:
                nl, sc = meta[op.lhs]
                ciphers[op.dst] = ev.neg_ct(ciphers[op.lhs], nl)
                meta[op.dst] = (nl, sc)
            elif oc == OP_RESCALE:
                nl, sc = meta[op.lhs]
                ciphers[op.dst] = ev.rescale_k(ciphers[op.lhs], nl, self.rr)
                for _ in range(self.rr):        # composite: drop the pair
                    sc /= self.s.ctx.q_primes[nl - 1]
                    nl -= 1
                meta[op.dst] = (nl, sc)
            elif oc == OP_MODSWITCH:
                nl, sc = meta[op.lhs]
                ciphers[op.dst] = ev.mod_drop(ciphers[op.lhs], op.rhs * self.rr)
                meta[op.dst] = (nl - op.rhs * self.rr, sc)
            elif oc == OP_UPSCALE:
                nl, sc = meta[op.lhs]
                ciphers[op.dst] = ev.upscale_res(
                    ciphers[op.lhs], nl, self._getuk(op)[:, :nl])
                meta[op.dst] = (nl, sc * self._upk(op))
            elif oc == OP_UPRESCALE:
                nl, sc = meta[op.lhs]
                ciphers[op.dst] = ev.upscale_rescale_res(
                    ciphers[op.lhs], nl, self._getuk(op)[:, :nl], self.rr)
                sc *= self._upk(op)
                for _ in range(self.rr):
                    sc /= self.s.ctx.q_primes[nl - 1]
                    nl -= 1
                meta[op.dst] = (nl, sc)
            elif oc == OP_ADDCC:
                nl, _ = meta[op.lhs]
                _, sc = meta[op.rhs]  # SEAL forces lhs.scale = rhs.scale
                ciphers[op.dst] = ev.add_ct(ciphers[op.lhs], ciphers[op.rhs], nl)
                meta[op.dst] = (nl, sc)
            elif oc == OP_ADDCP:
                nl, _ = meta[op.lhs]
                _, psc = self.plain_meta[op.rhs]
                ciphers[op.dst] = ev.add_pt(
                    ciphers[op.lhs], self._plain(op.rhs, nl), nl)
                meta[op.dst] = (nl, psc)
            elif oc == OP_MULCC:
                nl, sa = meta[op.lhs]
                _, sb = meta[op.rhs]
                ciphers[op.dst] = ev.mul_ct(ciphers[op.lhs], ciphers[op.rhs], nl, rlk)
                meta[op.dst] = (nl, sa * sb)
            elif oc == OP_MULCP:
                nl, sa = meta[op.lhs]
                _, psc = self.plain_meta[op.rhs]
                ciphers[op.dst] = ev.mul_pt(
                    ciphers[op.lhs], self._plain(op.rhs, nl), nl)
                meta[op.dst] = (nl, sa * psc)
            elif oc == OP_BOOTSTRAP:
                # scale-preserving (the oracle reheats after a cooled lift):
                # the level becomes (target_level + 1) * rr rows
                nl, sc = meta[op.lhs]
                ciphers[op.dst], meta[op.dst] = self.bootstrapper.bootstrap(
                    ciphers[op.lhs], nl, sc, op.rhs)
            else:
                raise ValueError(f"bad opcode {oc}")
            release(op, opi)

        return [materialize(r) for r in out_regs]

    # --------------------------------------------- upscale multiplier args
    # Upscale multiplies by an integer K passed as a [2, num_q] (residue,
    # shoup) tensor: K = 2^up_bits, or the steering pass's corrected integer.
    def _upk(self, op):
        """The float multiplier of an upscale op (meta bookkeeping)."""
        if op.orig in self._steer_kf:
            return self._steer_kf[op.orig]
        return float(2.0 ** op.rhs)

    def _uk_host(self, op):
        if op.orig in self._steer_res:
            return self._steer_res[op.orig]
        return self.ev.scalar_rows(1 << op.rhs, self.s.ctx.config.num_q)

    def _getuk(self, op):
        key = op.orig if op.orig in self._steer_res else ("p2", op.rhs)
        arr = self._uk_cache.get(key)
        if arr is None:
            arr = self._uk_cache[key] = to_dev(self._uk_host(op), self.s.device)
        return arr

    # ------------------------------------------------------------- frontends
    def run(self, arg_values):
        """arg_values: list of numpy slot-value vectors. Returns decrypted
        [res][slots] like runner.getOutput."""
        arg_cts = []
        for i, v in enumerate(arg_values):
            nl = (self.prog.arg_level[i] + 1) * self.rr
            scale = float(2.0 ** self.prog.arg_scale[i])
            ct = self.s.encrypt(v, scale=scale, nl=nl)
            arg_cts.append((ct.data, nl, scale))
        self.run_encrypted(arg_cts)
        return self.decrypt_outputs()

    def run_encrypted(self, arg_cts):
        """Server-mode entry: arg_cts are pre-encrypted (data, nl, scale)
        triples. Leaves the output CIPHERTEXTS in self._last_outputs."""
        self._last_outputs = self._run_trace(arg_cts)
        return self._last_outputs

    def _run_trace(self, arg_cts):
        ciphers, meta = {}, {}
        for i, (data, nl, scale) in enumerate(arg_cts):
            ciphers[i] = data
            meta[i] = (nl, scale)
        outs = self._exec_stream(self.ops, ciphers, meta, self.res_dst)
        return outs, [meta[r] for r in self.res_dst]

    def decrypt_outputs(self):
        outs, out_meta = self._last_outputs
        return np.stack([self.s.decrypt(Ciphertext(data, sc))
                         for data, (nl, sc) in zip(outs, out_meta)])
