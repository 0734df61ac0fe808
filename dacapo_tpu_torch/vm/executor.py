"""HEVM executor: interprets the bytecode stream over the PyTorch crypto layer.

Port of dacapo_tpu/vm/executor.py, two of its paths:

* segment execution (`jit="auto"`, the default, or `"segment"`): the
  (SSA, fused) stream is cut into windows at bootstraps and every
  SEGMENT_MAX_OPS ops. On the card each window of at least SEGMENT_MIN_OPS
  ops is one CUDA graph, captured at load (`precompile_segments`) and
  replayed on every request: PyTorch's counterpart of the JAX package's
  per-window `jax.jit`. A bootstrap window runs between replays: the
  device oracle replays its own graph, one per cache key, captured at load
  (`capture_oracle`, crypto/bootstrap.py); the host-RNG oracle and the
  native bootstrap run eagerly, as do tiny windows. On the CPU the same plan
  runs every window eagerly; no graphs exist there.
* per-op dispatch (`jit=False`): one Evaluator call per (fused)
  instruction, the counterpart of the reference C++ VM dispatch loop
  (lib/Runtime/SEAL_HEVM.cpp:336-401).

`jit=True` takes the segment path too. The JAX package compiles a program
without bootstraps as one function there; that whole-program graph is not
ported: the MLP is one window anyway, and a bootstrapped program takes the
segment path under the JAX rule as well.

The NTT wrapper counts the launches it makes (crypto/cuda/ntt_kernel.py);
recording a kernel into a graph is not a launch, and a replay launches the
graph's kernels without the wrapper, so the NTT kernels a request runs inside
graphs are counted on the device (the profiler, chip_smoke.py).

Not ported: `_seg_struct_key` (structurally equal windows sharing one
compiled function): a graph bakes in the addresses of the resident galois
keys and plaintexts, so sharing one would mean copying those into static
buffers before every replay; the port keeps one graph per window.
`_pt_ingraph`, `_seg_pt_groups`, `_seg_plains_arg` and `SYNC_EVERY` serve
plaintext streaming and in-flight host uploads, and `_seg_fn_batch` the
batch/mesh path: none exists in the port, where every plaintext and key is
resident on the device (memory and batching, a later slice).

Runtime metadata ((nl, scale) per register) is tracked on the host like SEAL
tracks ciphertext.scale()/levels, including the reference's scale-forcing
semantics in addcc/addcp (SEAL_HEVM.cpp:297-310).
"""

import hashlib
import math
import sys
import time

import numpy as np
import torch

from ..crypto.bootstrap import Bootstrapper, EmulatedBootstrapper
from ..crypto.bootstrap_native import NativeBootstrapper
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
    SEGMENT_MAX_OPS = 96         # split long windows
    SEGMENT_MIN_OPS = 4          # below this, eager dispatch is cheaper

    def __init__(self, scheme, program: HEVMProgram, constants, host_rng=False):
        """scheme: crypto.Scheme with keys; constants: list of f64 arrays (.cst);
        host_rng: the oracle draws its randomness from the key generator's
        numpy RNG (crypto/bootstrap.py) instead of on the device."""
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
        self._seg_plan = None
        self._captured = None   # (what the graphs were captured for, {wi: graph})
        self._segprof = False
        self.seg_profile = None
        self.capture_stats = None
        self.replays = 0        # graph replays, over all requests
        self.debug = False      # per-op (nl, scale) trace (setDebug)
        # the scheme's native bootstrapper once enable_native_bootstrap ran,
        # else the oracle
        self.bootstrapper = Bootstrapper(scheme, host_rng=host_rng) if any(
            op.opcode == OP_BOOTSTRAP for op in program.ops) else None
        # device bytes of the keys a request reads: the program's rotation
        # keys and, with native bootstraps, their rotation keys and the
        # conjugation key
        n_slots = scheme.ctx.config.n_slots
        steps = {o % n_slots for o in program.rotation_offsets() if o % n_slots}
        native = isinstance(self.bootstrapper, NativeBootstrapper)
        if native:
            steps.update(self.bootstrapper.rotation_steps())
        self.n_keys = len(steps)
        self.key_bytes = (self.n_keys + native) * scheme.galois_key_bytes()
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

    def setDebug(self, flag=True):
        """Per-op level and scale trace on stderr, like the reference VMs'
        setDebug (SEAL_HEVM.cpp:269-334 prints op name + scale per
        instruction). A request with debug on takes the per-op path."""
        self.debug = bool(flag)

    def _prepare_keys(self):
        self.s.ensure_galois([o for o in self.prog.rotation_offsets() if o != 0])

    def _boot_signatures(self):
        """The distinct (input rows, scale, target level) of the program's
        bootstraps, in program order, by the metadata walk from the
        compiled arguments."""
        meta = dict(enumerate(self._arg_meta()))
        seen = {}
        for op in self.ops:
            if op.opcode == OP_BOOTSTRAP:
                seen.setdefault(meta[op.lhs] + (op.rhs,), None)
            self._meta_step(op, meta)
        return list(seen)

    def warm_bootstraps(self):
        """Run each distinct native bootstrap of the program once over a
        zero ciphertext: its galois keys, conjugation key and plaintext
        diagonals are made now. HEVM.load does this on the card, after
        preprocess; the CPU keeps the JAX package's lazy order.
        Returns the number run."""
        if not isinstance(self.bootstrapper, NativeBootstrapper):
            return 0
        sigs = self._boot_signatures()
        for nl, sc, target in sigs:
            zero = torch.zeros((2, nl, self.s.ctx.n), dtype=torch.int32,
                               device=self.s.device)
            self.bootstrapper.bootstrap(zero, nl, sc, target)
        return len(sigs)

    def capture_oracle(self):
        """Capture the device oracle's CUDA graph of each distinct bootstrap
        of the program (one per cache key, crypto/bootstrap.py), as the
        reference jits its oracle once per key. HEVM.load does this on the
        card; a bootstrap captures its key's graph at first use otherwise.
        Returns the number of graphs the oracle holds: 0 on the CPU, with
        native bootstraps and on the host-RNG path."""
        bs = self.bootstrapper
        if (self.s.device.type != "cuda" or not isinstance(bs, EmulatedBootstrapper)
                or bs.host_rng):
            return 0
        for nl, sc, target in self._boot_signatures():
            if nl >= 2:
                bs.capture(nl, sc, target)
        return len(bs._graphs)

    # ------------------------------------------------------------ preprocess
    def preprocess(self):
        """Pre-encode all plaintexts offline (SEAL_HEVM.cpp:242-267):
        payload-identical encodes are deduplicated, device NTTs batched per
        level, and encode scales / upscale multipliers follow the scale
        steering solution (vm/steer.py)."""
        self._captured = None     # the graphs read the plaintexts replaced here
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
                if self.debug:
                    self._dbg_rotmac(op, meta[dst])
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
                if self.debug:
                    self._dbg(op, meta[op.dst])
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
                # scale-preserving (the oracle reheats after a cooled lift,
                # the native path lands its StC on the input scale): the
                # level becomes (target_level + 1) * rr rows
                nl, sc = meta[op.lhs]
                ciphers[op.dst], meta[op.dst] = self.bootstrapper.bootstrap(
                    ciphers[op.lhs], nl, sc, op.rhs)
            else:
                raise ValueError(f"bad opcode {oc}")
            if self.debug:
                self._dbg(op, meta[op.dst])
            release(op, opi)

        return [materialize(r) for r in out_regs]

    _OPNAMES = {
        OP_ENCODE: "encode", OP_ROTATE: "rotatec", OP_NEGATE: "negatec",
        OP_RESCALE: "rescalec", OP_MODSWITCH: "modswitchc",
        OP_UPSCALE: "upscalec", OP_ADDCC: "addcc", OP_ADDCP: "addcp",
        OP_MULCC: "mulcc", OP_MULCP: "mulcp", OP_BOOTSTRAP: "bootstrapc",
    }

    def _dbg_rotmac(self, op, m):
        nl, sc = m
        print(f"[hevm] rot_mac    dst={op.rescale_dst if op.fold_rescale else op.dst:<5} "
              f"src={op.src:<5} taps={len(op.steps):<4} level={nl - 1:<3} "
              f"log2(scale)={math.log2(sc):.3f}", file=sys.stderr)

    def _dbg(self, op, m):
        nl, sc = m
        name = self._OPNAMES.get(op.opcode, f"op{op.opcode}")
        print(f"[hevm] {name:<10} dst={op.dst:<5} lhs={op.lhs:<5} "
              f"rhs={op.rhs:<6} level={nl - 1:<3} "
              f"log2(scale)={math.log2(sc):.3f}", file=sys.stderr)

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

    # --------------------------------------------------------------- segments
    def _window_plan(self, max_ops):
        """Split the (SSA, fused) program into windows at bootstraps and
        every `max_ops` ops, with each window's live-in/out cipher registers
        and resources (plain regs, rotation offsets). A fused rot-mac bank
        counts as one op but carries its own rotation-offset/plaintext
        lists. `outs`: the writes a later window or the result reads, in
        definition order; `dead`: the registers that no later window and
        not the result reads, dropped after the window."""
        windows = []
        cur = []

        def close():
            if cur:
                windows.append(("seg", list(cur)))
                cur.clear()

        for op in self.ops:
            if op.opcode in (OP_ALLOC, OP_ENCODE):
                continue
            if op.opcode == OP_BOOTSTRAP:
                close()
                windows.append(("boot", [op]))
            else:
                cur.append(op)
                if len(cur) >= max_ops:
                    close()
        close()

        infos = []
        for kind, ops in windows:
            reads, writes = [], set()
            plain_regs, rot_steps = [], []
            has_mulcc = False
            for op in ops:
                for r in cipher_reads(op, self.num_regs):
                    if r not in writes and r not in reads:
                        reads.append(r)
                if op.opcode == OP_ROTMAC:
                    for r in list(op.pt_regs) + list(op.plain_pts):
                        if r not in plain_regs:
                            plain_regs.append(r)
                    for st in op.steps:
                        if st not in rot_steps:
                            rot_steps.append(st)
                    writes.add(op.rescale_dst if op.fold_rescale else op.dst)
                    continue
                if op.opcode in (OP_ADDCP, OP_MULCP) and op.rhs not in plain_regs:
                    plain_regs.append(op.rhs)
                if op.opcode == OP_ROTATE and op.rhs != 0 and op.rhs not in rot_steps:
                    rot_steps.append(op.rhs)
                has_mulcc |= op.opcode == OP_MULCC
                writes.add(op.dst)
            infos.append(dict(kind=kind, ops=ops, ins=reads, writes=writes,
                              plain_regs=plain_regs, rot_steps=rot_steps,
                              has_mulcc=has_mulcc, dead=[]))

        live = set(self.res_dst)
        for info in reversed(infos):
            def_order = {}
            for i, op in enumerate(info["ops"]):
                d = op.rescale_dst if getattr(op, "fold_rescale", False) else op.dst
                def_order.setdefault(d, i)
            info["outs"] = sorted(info["writes"] & live,
                                  key=lambda r: def_order.get(r, 1 << 30))
            live = (live - info["writes"]) | set(info["ins"])
        last = {}
        for wi, info in enumerate(infos):
            for r in info["writes"]:
                last.setdefault(r, wi)
            for r in info["ins"]:
                last[r] = wi
        results = set(self.res_dst)
        for r, wi in last.items():
            if r not in results:
                infos[wi]["dead"].append(r)
        return infos

    def _segment_plan(self):
        if self._seg_plan is None:
            self._seg_plan = self._window_plan(self.SEGMENT_MAX_OPS)
        return self._seg_plan

    def _meta_step(self, op, meta):
        """Metadata transition of one op (mirrors _exec_stream bookkeeping).
        The bootstrap rule is scale-preserving, like both bootstrappers."""
        oc = op.opcode
        if oc in (OP_ALLOC, OP_ENCODE):
            return
        if oc == OP_UPRESCALE:
            nl, sc = meta[op.lhs]
            sc *= self._upk(op)
            for _ in range(self.rr):
                sc /= self.s.ctx.q_primes[nl - 1]
                nl -= 1
            meta[op.dst] = (nl, sc)
            return
        if oc == OP_ROTMAC:
            nl, ssc = meta[op.src] if op.src >= 0 else meta[op.plain_vals[0]]
            sc = ssc * self.plain_meta[(op.pt_regs or op.plain_pts)[0]][1]
            dst = op.rescale_dst if op.fold_rescale else op.dst
            if op.fold_rescale or op.taps_rescaled:
                for _ in range(self.rr):
                    sc /= self.s.ctx.q_primes[nl - 1]
                    nl -= 1
            meta[dst] = (nl, sc)
            return
        if oc in (OP_ROTATE, OP_NEGATE):
            meta[op.dst] = meta[op.lhs]
        elif oc == OP_RESCALE:
            nl, sc = meta[op.lhs]
            for _ in range(self.rr):
                sc /= self.s.ctx.q_primes[nl - 1]
                nl -= 1
            meta[op.dst] = (nl, sc)
        elif oc == OP_MODSWITCH:
            nl, sc = meta[op.lhs]
            meta[op.dst] = (nl - op.rhs * self.rr, sc)
        elif oc == OP_UPSCALE:
            nl, sc = meta[op.lhs]
            meta[op.dst] = (nl, sc * self._upk(op))
        elif oc == OP_ADDCC:
            meta[op.dst] = (meta[op.lhs][0], meta[op.rhs][1])
        elif oc == OP_ADDCP:
            meta[op.dst] = (meta[op.lhs][0], self.plain_meta[op.rhs][1])
        elif oc == OP_MULCC:
            meta[op.dst] = (meta[op.lhs][0], meta[op.lhs][1] * meta[op.rhs][1])
        elif oc == OP_MULCP:
            meta[op.dst] = (meta[op.lhs][0],
                            meta[op.lhs][1] * self.plain_meta[op.rhs][1])
        elif oc == OP_BOOTSTRAP:
            meta[op.dst] = ((op.rhs + 1) * self.rr, meta[op.lhs][1])

    def _trace_meta(self, arg_cts):
        """Output (nl, scale) of the program by the host walk alone."""
        meta = {i: (nl, scale) for i, (_, nl, scale) in enumerate(arg_cts)}
        for op in self.ops:
            self._meta_step(op, meta)
        return [meta[r] for r in self.res_dst]

    def _arg_meta(self):
        """(nl, scale) of each argument as compiled (what setInput makes)."""
        return [((self.prog.arg_level[i] + 1) * self.rr,
                 float(2.0 ** self.prog.arg_scale[i]))
                for i in range(self.prog.arg_length)]

    def precompile_segments(self, arg_meta=None):
        """Capture every window of the segment plan as a CUDA graph before
        the first request, as the JAX package compiles them here. arg_meta:
        [(nl, scale)] per argument, by default the compiled ones. Returns
        the number of graphs: 0 on the CPU, where the plan runs eagerly.
        Raises if a capture fails or the galois keys are not resident."""
        return len(self._graphs(arg_meta or self._arg_meta()))

    def _graphs(self, arg_meta):
        """{window index: graph record} of the segment plan for arguments of
        this metadata ({} on the CPU). The graphs are captured at first use
        and again whenever the key set or a device key tensor changed since
        (GaloisStore.generation): a graph reads the keys at the addresses
        it was captured with."""
        if self.s.device.type != "cuda":
            return {}
        keys = self.s.keys
        if keys.galois.budget is not None:
            self._captured = None
            raise RuntimeError(
                "galois keys are streamed from host memory under a device budget, "
                "and a CUDA graph bakes in their addresses: run with jit=False")
        meta = tuple(tuple(m) for m in arg_meta)
        hit = self._captured
        if (hit is not None and hit[0] == meta and hit[1] is keys
                and hit[2] is keys.galois and hit[3] == keys.galois.generation):
            return hit[4]
        self._captured = None                 # free the old graphs first
        graphs = self._capture(self._segment_plan(), arg_meta)
        # the key objects themselves (not ids): held here, they outlive the
        # graphs that read them
        self._captured = (meta, keys, keys.galois, keys.galois.generation, graphs)
        return graphs

    def _capture(self, plan, arg_meta):
        """Capture walk over the plan with _meta_step: one graph for every
        window of at least SEGMENT_MIN_OPS ops, all in one memory pool and
        in plan order (the replays keep that order, which is what lets the
        graphs share the pool). A register an earlier graph writes is read
        at that graph's static output; every other input (an argument, an
        oracle or eager-window output) gets a zeroed static buffer that the
        replay copies into. Nothing random is drawn: the MLP's first
        request stays bit-equal to the JAX package's."""
        dev = self.s.device
        n = self.s.ctx.n
        meta = dict(enumerate(arg_meta))
        graph_out = {}        # register -> static output of an earlier graph
        stream = torch.cuda.Stream(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for wi, info in enumerate(plan):
            if info["kind"] == "seg" and len(info["ops"]) >= self.SEGMENT_MIN_OPS:
                ins = [graph_out[r] if r in graph_out else
                       torch.zeros((2, meta[r][0], n), dtype=torch.int32, device=dev)
                       for r in info["ins"]]
                rec = graphs[wi] = self._seg_graph(
                    info, {r: meta[r] for r in info["ins"]}, ins, stream, pool)
                graph_out.update(zip(info["outs"], rec["outs"]))
            for op in info["ops"]:
                self._meta_step(op, meta)
            for r in info["dead"]:
                graph_out.pop(r, None)
        self.capture_stats = dict(
            windows=len(plan), graphs=len(graphs),
            **{k: sum(g[k] for g in graphs.values()) for k in ("warmup_s", "capture_s")})
        return graphs

    def _seg_graph(self, info, in_meta, ins, stream, pool):
        """Capture one window's _exec_stream into one CUDA graph over the
        static inputs `ins` (aligned with info["ins"]). The window first runs
        once eagerly on the capture stream over the same inputs: that fills
        the Evaluator's and the executor's device caches, since no upload
        from host memory may run under capture. Returns the record: graph,
        ins, outs (static outputs, aligned with info["outs"]), and seconds
        (capture_s: capture and instantiation)."""
        def body():
            return self._exec_stream(info["ops"], dict(zip(info["ins"], ins)),
                                     dict(in_meta), info["outs"])

        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body()
        stream.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()       # instantiated as the capture ends
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            outs = body()
        t2 = time.perf_counter()
        return dict(graph=graph, ins=ins, outs=outs, warmup_s=t1 - t0, capture_s=t2 - t1)

    def _run_segmented(self, arg_cts):
        """Replay walk: per window, the bootstrap (boot: the device oracle
        replays its graph and returns a copy of the output), an eager _exec_stream
        (no graph: tiny windows, and every window on the CPU), or: copy each
        input that is not already the graph's own static input in, replay,
        and bind the static outputs. Returns copies of the outputs, since the
        next replay overwrites a graph's outputs."""
        plan = self._segment_plan()
        graphs = self._graphs([(nl, sc) for _, nl, sc in arg_cts])
        ciphers, meta = {}, {}
        for i, (data, nl, scale) in enumerate(arg_cts):
            ciphers[i] = data
            meta[i] = (nl, scale)
        prof = [] if self._segprof else None
        for wi, info in enumerate(plan):
            t0 = time.perf_counter()
            rec = graphs.get(wi)
            if info["kind"] == "boot":
                op = info["ops"][0]
                nl, sc = meta[op.lhs]
                ciphers[op.dst], meta[op.dst] = self.bootstrapper.bootstrap(
                    ciphers[op.lhs], nl, sc, op.rhs)
                kind = "boot"
            elif rec is None:
                self._exec_stream(info["ops"], ciphers, meta, info["outs"])
                kind = "eager"
            else:
                for r, buf in zip(info["ins"], rec["ins"]):
                    if ciphers[r] is not buf:
                        buf.copy_(ciphers[r])
                rec["graph"].replay()
                self.replays += 1
                ciphers.update(zip(info["outs"], rec["outs"]))
                for op in info["ops"]:
                    self._meta_step(op, meta)
                kind = "graph"
            for r in info["dead"]:
                ciphers.pop(r, None)
            if prof is not None:
                if self.s.device.type == "cuda":
                    torch.cuda.synchronize(self.s.device)
                prof.append(dict(wi=wi, kind=kind, ops=len(info["ops"]),
                                 s=time.perf_counter() - t0))
        self.seg_profile = prof
        return ([ciphers[r].clone() for r in self.res_dst],
                [meta[r] for r in self.res_dst])

    def set_profiling(self, flag=True):
        """Per-window wall time of the segment path, with a synchronize after
        every window (which perturbs the total a little): each request leaves
        its list in self.seg_profile, and seg_report prints it."""
        self._segprof = bool(flag)

    def seg_report(self, file=None):
        """Print the last profiled request's windows (totals by kind, the
        slowest twelve) and return the totals: {kind: {seconds, windows,
        ops}}, kind "graph", "eager" or "boot"."""
        prof = self.seg_profile
        if not prof:
            return {}
        f = file or sys.stderr
        by_kind = {}
        for p in prof:
            k = by_kind.setdefault(p["kind"], dict(seconds=0.0, windows=0, ops=0))
            k["seconds"] += p["s"]
            k["windows"] += 1
            k["ops"] += p["ops"]
        print(f"[segprof] total {sum(p['s'] for p in prof):.4f}s over "
              f"{len(prof)} windows", file=f)
        for kind, k in sorted(by_kind.items(), key=lambda kv: -kv[1]["seconds"]):
            print(f"[segprof]   {kind:<6} {k['seconds']:8.4f}s  x{k['windows']} "
                  f"({k['ops']} ops)", file=f)
        for p in sorted(prof, key=lambda p: -p["s"])[:12]:
            print(f"[segprof]   top: w{p['wi']:<4} {p['kind']:<6} {p['ops']:>3} ops  "
                  f"{p['s']:.4f}s", file=f)
        return by_kind

    # ------------------------------------------------------------- frontends
    def run(self, arg_values, jit="auto"):
        """arg_values: list of numpy slot-value vectors. Returns decrypted
        [res][slots] like runner.getOutput."""
        arg_cts = []
        for i, v in enumerate(arg_values):
            nl = (self.prog.arg_level[i] + 1) * self.rr
            scale = float(2.0 ** self.prog.arg_scale[i])
            ct = self.s.encrypt(v, scale=scale, nl=nl)
            arg_cts.append((ct.data, nl, scale))
        self.run_encrypted(arg_cts, jit=jit)
        return self.decrypt_outputs()

    def run_encrypted(self, arg_cts, jit="auto"):
        """Server-mode entry: arg_cts are pre-encrypted (data, nl, scale)
        triples. Leaves the output CIPHERTEXTS in self._last_outputs.

        jit: "auto"/"segment" (the default) runs the segment plan, on the
        card as CUDA graphs (captured at first use unless
        precompile_segments ran), on the CPU eagerly; True does the same
        (module docstring); False dispatches per op, as does every request
        with debug on (setDebug)."""
        if self.debug:
            jit = False      # the trace prints per-op host metadata
        if jit is True or jit in ("auto", "segment"):
            outs = self._run_segmented(arg_cts)
        elif jit is False:
            outs = self._run_trace(arg_cts)
        else:
            raise ValueError(f"jit must be 'auto', 'segment', True or False, not {jit!r}")
        self._last_outputs = outs
        return outs

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
