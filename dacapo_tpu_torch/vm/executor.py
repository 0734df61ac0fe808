"""HEVM executor: interprets the bytecode stream over the PyTorch crypto layer.

Port of dacapo_tpu/vm/executor.py, its paths:

* segment execution (`jit="auto"`, the default, or `"segment"`): the
  (SSA, fused) stream is cut into windows at bootstraps and every
  SEGMENT_MAX_OPS ops. On the card each window of at least SEGMENT_MIN_OPS
  ops is one CUDA graph, captured at load (`precompile_segments`) and
  replayed on every request: PyTorch's counterpart of the JAX package's
  per-window `jax.jit`. A bootstrap window runs between replays: the
  device oracle replays its own graph, one per cache key, captured at load
  (`capture_oracle`, crypto/bootstrap.py); the native bootstrap replays one
  graph per input signature (`precompile_bootstraps`, below); the host-RNG
  oracle runs eagerly, as do tiny windows. On the CPU the same plan runs
  every window eagerly; no graphs exist there.
* per-op dispatch (`jit=False`): one Evaluator call per (fused)
  instruction, the counterpart of the reference C++ VM dispatch loop
  (lib/Runtime/SEAL_HEVM.cpp:336-401).

* the batch path (`run_encrypted_batch`, the reference's server-throughput
  entry): B ciphertexts [B, 2, nl, N] per argument through the same segment
  plan. The reference vmaps each window's function (`_seg_fn_batch`); here
  every Evaluator op takes the batch whole (crypto/ops.py), so on the card
  each window of at least SEGMENT_MIN_OPS ops is one CUDA graph over the
  batch, captured for one batch size (`precompile_segments(batch=B)`) and
  cached apart from the single-request graphs. A boot window refreshes the
  batch: the oracle with `bootstrap_batch` (on the card one graph per cache
  key and B, `capture_oracle(batch=B)`), the native bootstrap row by row,
  eagerly, as the reference does.
* the batch path over a mesh (`run_encrypted_batch(mesh=...)`, the
  reference's shardings of parallel/mesh.py, here on torch.distributed):
  every rank is given the whole batch and keeps its contiguous block of
  rows on the dp axis (np.array_split order), so it captures the batch
  graphs of its own block size; on the mp axis the key switch's QP rows
  are split (crypto/ops.py: one all-gather of the accumulators per key
  switch, recorded into the window graphs on the card) and each rank keeps
  only its rows of every key (Scheme.shard_keys). An oracle boot window
  all-gathers the batch over dp and refreshes all B rows, so its draws are
  those of mesh=None, and keeps this rank's; a native bootstrap draws
  nothing and runs this rank's rows only. The results are all-gathered
  over dp: every rank returns the whole batch.

* the whole-program path (`jit=True`): the JAX package's rule
  (dacapo_tpu/vm/executor.py run_encrypted) compiles the whole request into
  one function wherever the executor does not stream its plaintexts, debug
  is off, and the program has no bootstrap or only native ones; streaming
  and the emulated (oracle) bootstrap fall back to the segment path, debug
  to per-op dispatch. The port keeps that rule, and adds blockers of its
  own that send a request to the segment path too: a galois-key budget
  ("key_budget": the keys come through the key store's LRU), a mesh, and a
  native bootstrap signature the plane bound of the segment path cannot
  pin ("dropped_group"); `whole_path` says which, and every request leaves
  its (path, why) in `last_path`. On the card the whole program is one
  CUDA graph a request (`_whole_body`: the segment plan's windows and each
  native bootstrap's device work, recorded inline), captured by
  `precompile_whole` (HEVM.load) in a pool of its own after one eager
  warm-up, every bootstrap signature's planes pinned; a replay keeps each
  bootstrap's host bookkeeping (NativeBootstrapper.count_replay). On the
  CPU ("cpu") the same walk runs eagerly.

The NTT wrapper counts the launches it makes (crypto/cuda/ntt_kernel.py);
recording a kernel into a graph is not a launch, and a replay launches the
graph's kernels without the wrapper, so the NTT kernels a request runs inside
graphs are counted on the device (the profiler, chip_smoke.py).

Plaintexts (reference :61-306, :741-831). preprocess keeps them resident
as NTT-domain planes while their bytes (QP rows included) fit the plaintext
budget, PTXT_BUDGET_FRAC of the device memory `_hbm_limit` reports (the
JAX rule: DACAPO_TPU_HBM_BYTES when set, else the card's total; on the
CPU, 16 GiB for N >= 2^15 and no limit below, the JAX package's rule for a
backend without memory stats). Over budget it streams: every unique
payload is one compact 2-row record in a device pool (`_pt_pool`,
Encoder.encode_compact_batch), decoded on the device by
Evaluator.decode_plain at each use. A segment window of at least
SEGMENT_MIN_OPS ops decodes its plaintexts at its start, grouped by row
tuple (`_seg_pt_groups`, the reference's in-graph decode): on the card
inside its CUDA graph, from index tensors into the pool uploaded before
the capture, so a replay reads 2 rows per plaintext and no address in the
graph depends on an LRU; a batch graph does the same, the planes
broadcast over the batch (the reference decodes outside its vmapped
window; the values are the same). The per-op path and tiny windows read
through an LRU of decoded planes under the budget (`_plain`,
`_plain_prefetch` for a fused bank's masks, `_pt_insert`).

Galois keys (reference :60-97, `getgk` :317). Past KEY_BUDGET_FRAC of
the device memory (the port's `key_bytes` counts the native bootstrap's
keys and the conjugation key too) they live in host memory behind the key
store's device LRU (crypto/keys.GaloisStore), as in the reference, where
each window gets its keys as arguments. A graph bakes in the address of
every key it reads and an LRU eviction frees it, so under a budget each
window of at least SEGMENT_MIN_OPS ops reads its keys from fixed slots of
one device arena [S, dnum, 2, num_all, N] instead (`_key_arena`), on the
single and the batch path alike: before the window runs, each key whose
slot holds another one is copied in (`_stage_keys`), from the LRU's device
copy or from the store's pinned host slabs, on the stream the replays run
on, so a slot is never overwritten while an earlier window still reads it.
The slots are planned at capture from the request's key sequence with
Belady's rule (`plan_key_slots`; a plain LRU over a cyclic sequence longer
than its capacity misses on every access); the arena and the LRU share the
budget (`GaloisStore.reserve`), and the LRU serves what runs eagerly: the
per-op path, tiny windows, the native bootstrap. On the CPU the same slot
map and staging run, eagerly. Without a budget the graphs read the resident
keys in place: no arena, no copy.

Not ported: `_seg_struct_key` (structurally equal windows sharing one
compiled function): a graph bakes in the addresses of the resident galois
keys and plaintexts, so sharing one would mean copying those into static
buffers before every replay; the port keeps one graph per window. The
reference's legacy streaming mode (DACAPO_TPU_PT_INGRAPH=0: LRU-decoded
planes passed into the window) cannot feed a graph, because an LRU
eviction frees the planes whose addresses a graph baked in; streaming
windows always decode in-graph. `SYNC_EVERY` bounds the reference's host
uploads in flight (pinned streamed keys and plaintexts of every enqueued
window); here the plaintext pool is on the device before the first
request, and the key copies in flight are bounded by the arena's slots:
stream order makes a copy wait for the windows that read its slot.

The native bootstrap's plaintext diagonals and constants are the
bootstrapper's own (crypto/bootstrap_native.py), encoded once per input
signature; under a memory limit they hold at most what the galois keys and
the plaintexts leave of their budgets, less the plaintext LRU's share on the
request's path (`path_budgets`: its whole budget per op, the eager windows'
plaintexts on the segment path), planned over the request's bootstrap order
(`_plan_bootstrap_planes`, `_use_path`), and a dropped plane is encoded
again at its next use.

The native bootstrap's CUDA graphs (the JAX package compiles each of its
ops once per shape, crypto/ops.py `_jit`): on the card a segment request
replays one graph per input signature (NativeBootstrapper.capture), captured
after the segment graphs into their memory pool (a graph's only live output
is copied out as its replay ends, so any replay order is safe there) by
`precompile_bootstraps` at load, and again at a request's start when the
keys or the segment graphs changed or the per-op path dropped them. Each
boot window of the plan (`boot_plan`) is a replay or runs eagerly for one
stated reason: "per_op" (the per-op path dispatches op by op, as the JAX
package's does; it drops the graphs and their pinned planes, so its own
plane bound holds), "mesh", "key_budget" (the keys come through the key
store's LRU), "dropped_group" (under the plane bound the signature's planes
cannot stay pinned beside the others': NativeBootstrapper.graph_plan), or on
the CPU "cpu". `last_bootstraps` holds the last request's count of each; a
planned replay that does not happen raises. The batch path replays the same
single-ciphertext graph row by row.

Runtime metadata ((nl, scale) per register) is tracked on the host like SEAL
tracks ciphertext.scale()/levels, including the reference's scale-forcing
semantics in addcc/addcp (SEAL_HEVM.cpp:297-310).
"""

import hashlib
import math
import os
import sys
import time
from bisect import bisect_right
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..crypto.bootstrap import Bootstrapper, EmulatedBootstrapper
from ..crypto.bootstrap_native import NativeBootstrapper
from ..crypto.cuda import graphs, ntt_kernel
from ..crypto.ops import RowShard
from ..crypto.params import UploadUnderCapture, to_dev, upload
from ..crypto.scheme import Ciphertext
from .fuse import ssa_expand, build_fuse_plan, OP_ROTMAC, OP_UPRESCALE, cipher_reads
from .hevm import (
    HEVMProgram, OP_ENCODE, OP_ROTATE, OP_NEGATE, OP_RESCALE, OP_MODSWITCH,
    OP_UPSCALE, OP_ADDCC, OP_ADDCP, OP_MULCC, OP_MULCP, OP_BOOTSTRAP, OP_ALLOC,
)
from .steer import steer_scales


def plan_key_slots(seq, n_slots):
    """Slots for the galois keys of a request's graph windows, planned from
    the request's key sequence with Belady's rule: on a miss, the slot of
    the key whose next use lies furthest ahead, the request repeating,
    which copies the fewest keys for a cache of n_slots. seq: each graph
    window's keys, in request order (distinct within a window, at most
    n_slots of them). Periods are planned until the slots hold at the end
    of one what they held at its start. Returns (one {key: slot} per
    window, what each slot holds when a request starts (a key or None),
    the keys copied into a slot a request at that fixed point)."""
    period = len(seq)
    uses = {}
    for p, ks in enumerate(seq):
        for k in ks:
            uses.setdefault(k, []).append(p)

    def next_use(k, p):
        u = uses[k]
        i = bisect_right(u, p)
        return u[i] if i < len(u) else u[0] + period

    held, where = [None] * n_slots, {}
    for _ in range(8):
        start = list(held)
        maps = []
        for p, ks in enumerate(seq):
            m = {}
            for k in ks:
                s = where.get(k)
                if s is None:
                    if None in held:
                        s = held.index(None)
                    else:
                        s = max((i for i in range(n_slots) if held[i] not in ks),
                                key=lambda i: (next_use(held[i], p), -i))
                        del where[held[s]]
                    held[s], where[k] = k, s
                m[k] = s
            maps.append(m)
        if held == start:
            break
    # copies of this fixed map a request: where a slot's key differs from
    # the one it held before, cyclically
    by_slot = [[] for _ in range(n_slots)]
    for m in maps:
        for k, s in m.items():
            by_slot[s].append(k)
    copies = sum(sum(a != b for a, b in zip(ks, ks[-1:] + ks[:-1])) for ks in by_slot)
    return maps, held, copies


def key_slot_count(seq, budget, key_bytes, reserved=0):
    """The arena's slots for a request's key sequence `seq` (plan_key_slots)
    under a galois-key budget: as many keys as the budget holds besides
    `reserved` bytes and one key of room for the LRU, at most the distinct
    keys of `seq`, at least the most one window reads (which may pass the
    budget)."""
    cap = (budget - reserved) // key_bytes - 1
    return max(max(map(len, seq), default=0), min(len({k for ks in seq for k in ks}), cap))


def lru_key_copies(seq, n_slots):
    """The keys a plain LRU of n_slots keys copies a request on the same
    sequence (the second of two requests from empty: its steady state)."""
    lru = OrderedDict()
    for _ in range(2):
        copies = 0
        for ks in seq:
            for k in ks:
                if k in lru:
                    lru.move_to_end(k)
                else:
                    copies += 1
                    lru[k] = None
                    if len(lru) > n_slots:
                        lru.popitem(last=False)
    return copies


def host_ahead(fn, items, workers=8):
    """fn(item) for each item, in order, computed by up to `workers` threads
    at most twice as many items ahead of the caller: the host half of a
    load's encodes (numpy's FFTs and array arithmetic release the GIL) runs
    in parallel with itself and with the device half the caller does with
    each result. The same calls as a plain loop, so the same results."""
    items = list(items)
    workers = min(workers, os.cpu_count() or 1, len(items))
    if workers <= 1:
        yield from map(fn, items)
        return
    with ThreadPoolExecutor(workers) as pool:
        queued = deque(pool.submit(fn, item) for item in items[:2 * workers])
        for item in items[2 * workers:]:
            out = queued.popleft().result()
            queued.append(pool.submit(fn, item))
            yield out
        while queued:
            yield queued.popleft().result()


def check_bootstrap_reach(program, bs, rescale_rows):
    """Refuse a program whose native bootstraps target a level past what
    the native bootstrapper `bs` leaves of the chain
    (NativeBootstrapper.rows_left), with a ValueError naming both levels:
    HEVM.load and the executor call this before they make any key, where
    the bootstrap would otherwise stop in the middle of a request. Nothing
    to check without native bootstraps."""
    targets = [op.rhs for op in program.ops if op.opcode == OP_BOOTSTRAP]
    if not targets or not isinstance(bs, NativeBootstrapper):
        return
    rows = bs.rows_left()
    reach = rows // rescale_rows - 1
    if max(targets) > reach:
        raise ValueError(
            f"the program bootstraps to level {max(targets)}, past level {reach}, the "
            f"highest a native bootstrap with {bs.cfg} reaches on this profile (it leaves "
            f"{rows} of {bs.s.ctx.config.num_q} rows): compile it against a profile "
            f"whose levelUpperBound and bootstrapLevelUpperBound are at most {reach}")


def boot_window_plan(windows, verdict, path, key_budget=False, mesh=False):
    """[(window index, signature, None or why it runs eagerly)] of a
    request's native boot windows ([(window index, (rows, scale, target
    level))]): "per_op" on that path, else "mesh" over a mesh, else
    "key_budget" under a galois-key budget, else the plane bound's verdict
    (NativeBootstrapper.graph_plan: None, or "dropped_group")."""
    why = ("per_op" if path == "per_op" else "mesh" if mesh
           else "key_budget" if key_budget else None)
    return [(wi, sig, why or verdict[sig[:2]]) for wi, sig in windows]


class HEVMExecutor:
    # Galois keys beyond this fraction of the card's memory stay in host RAM
    # behind a device LRU (crypto/keys.GaloisStore).
    KEY_BUDGET_FRAC = 0.55
    # Plaintexts beyond this fraction stream from the compact device pool.
    PTXT_BUDGET_FRAC = 0.12
    NTT_BATCH = (64, 16, 4, 1)   # plaintexts per batched-NTT launch (per nl)
    PT_ENCODE_BATCH = 64         # payloads per compact-encode FFT batch
    PT_BATCH = (32, 8, 2, 1)     # plaintexts per LRU decode launch (a bank's masks)
    SEGMENT_MAX_OPS = 96         # split long windows
    SEGMENT_MIN_OPS = 4          # below this, eager dispatch is cheaper

    def __init__(self, scheme, program: HEVMProgram, constants, host_rng=False):
        """scheme: crypto.Scheme with keys; constants: list of f64 arrays (.cst);
        host_rng: the oracle draws its randomness from the key generator's
        numpy RNG (crypto/bootstrap.py) instead of on the device."""
        self._init_plan(scheme, program, constants)
        self.plains = [None] * program.num_ptxt      # device planes, or pool ids
        self._pt_rows = {}                           # cid -> decode row list
        self._pt_pool = None                         # int32 [cids, 2, N] (streaming)
        self._pt_dev = OrderedDict()                 # cid -> decoded planes (LRU)
        self._pt_dev_bytes = 0
        self._pt_groups = {}                         # window index -> decode groups
        self._pt_budget = None
        self._lru_budget = None  # the LRU's bound on this path (None: _pt_budget)
        self._path_budgets = None                    # _plan_bootstrap_planes
        self.plane_bound = True  # False: no bound on the native bootstrap's planes
        self._streaming = False
        self.plain_bytes = self.pool_bytes = 0
        self._uk_cache = {}
        self._last_outputs = None
        # the single-request graphs: (what they were captured for and read,
        # _capture_key; {wi: graph} of the segment plan, or the whole-program
        # graph's record), one kind at a time
        self._captured = None
        self.last_path = None   # the last request's (path, why), run_encrypted
        self._captured_batch = None   # the same for one batch size
        self._mesh = None       # the mesh of the batch path, once use_mesh ran
        self.mesh_collectives = 0   # mp all-gathers issued by graph replays
        self._arena = None      # galois-key slots of the graph windows (under a budget)
        self._arena_serial = 0
        # keys copied into arena slots, from the host and from the LRU's
        # device copies: counts and bytes, over all requests
        self.key_staging = dict(host=0, host_bytes=0, device=0, device_bytes=0)
        self._segprof = False
        self.seg_profile = None
        self.capture_stats = None
        self._seg_pool = None   # the memory pool of the single-request segment graphs
        self._boot_dep = None   # what the native bootstrap graphs were captured over
        self.last_bootstraps = None   # the last request's: replayed, eager by reason
        self.bootstrap_stats = None     # warm_bootstraps: signatures and planes
        self.replays = 0        # graph replays, over all requests
        # NTT calls the replayed graphs ran, over all requests (what each
        # graph recorded at capture, ntt_kernel.RECORDED)
        self.replayed_ntt = dict.fromkeys(ntt_kernel.RECORDED, 0)
        self.debug = False      # per-op (nl, scale) trace (setDebug)
        # the scheme's native bootstrapper once enable_native_bootstrap ran,
        # else the oracle
        self.bootstrapper = Bootstrapper(scheme, host_rng=host_rng) if any(
            op.opcode == OP_BOOTSTRAP for op in program.ops) else None
        check_bootstrap_reach(program, self.bootstrapper, self.rr)
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

    def _init_plan(self, scheme, program, constants):
        """What the metadata walk reads: the fused op stream and the
        plaintexts' (nl, scale) slots."""
        self.s = scheme
        self.ev = scheme.ev
        self.rr = scheme.ctx.config.rescale_rows   # RNS rows per hevm level
        self.prog = program
        self.constants = constants
        # SSA-expand the register stream, then fuse the rot-mac banks
        self.ops, self.num_regs, self.res_dst = ssa_expand(program)
        self.ops, self._fused_pt_regs, self.num_regs = build_fuse_plan(
            self.ops, self.num_regs, self.res_dst)
        self.plain_meta = [None] * program.num_ptxt  # (nl, scale)
        self._pt_cid = [None] * program.num_ptxt     # register -> dedup id
        self._seg_plan = None
        self._boot_win = {}                          # _boot_windows, by argument metadata

    @classmethod
    def plan_only(cls, scheme, program, constants):
        """An executor of `program` that makes no key, builds no
        bootstrapper and holds nothing on the device: its metadata walk
        (_boot_sequence, _plaintext_plan, _arg_meta) on a scheme without
        keys (scripts/native_resnet_plan.py)."""
        ex = cls.__new__(cls)
        ex._init_plan(scheme, program, constants)
        return ex

    def _hbm_limit(self):
        """Device bytes the budgets are fractions of (reference :71-87):
        DACAPO_TPU_HBM_BYTES when set, else the card's total memory; on the
        CPU, which reports none (as a JAX backend without memory stats), 16
        GiB for N >= 2^15 and no limit below."""
        env = os.environ.get("DACAPO_TPU_HBM_BYTES")
        if env:
            return int(env)
        if self.s.device.type == "cuda":
            return torch.cuda.mem_get_info(self.s.device)[1]
        return 16 << 30 if self.s.ctx.n >= (1 << 15) else None

    def _set_memory_budgets(self):
        limit = self._hbm_limit()
        if limit is None:
            return
        if self.key_bytes > self.KEY_BUDGET_FRAC * limit:
            print(f"[hevm] galois keys {self.key_bytes >> 20} MiB exceed budget "
                  f"{int(self.KEY_BUDGET_FRAC * limit) >> 20} MiB: "
                  "streaming keys from host (LRU)", file=sys.stderr)
            self.s.set_key_budget(int(self.KEY_BUDGET_FRAC * limit))
        self._pt_budget = int(self.PTXT_BUDGET_FRAC * limit)

    @property
    def streaming(self):
        """True when preprocess put the plaintexts in the compact pool."""
        return self._streaming

    def setDebug(self, flag=True):
        """Per-op level and scale trace on stderr, like the reference VMs'
        setDebug (SEAL_HEVM.cpp:269-334 prints op name + scale per
        instruction). A request with debug on takes the per-op path."""
        self.debug = bool(flag)

    def _prepare_keys(self):
        self.s.ensure_galois([o for o in self.prog.rotation_offsets() if o != 0])

    def _boot_sequence(self):
        """(input rows, scale, target level) of each of the program's
        bootstraps, in program order, by the metadata walk from the
        compiled arguments."""
        meta = dict(enumerate(self._arg_meta()))
        seq = []
        for op in self.ops:
            if op.opcode == OP_BOOTSTRAP:
                seq.append(meta[op.lhs] + (op.rhs,))
            self._meta_step(op, meta)
        return seq

    def _boot_signatures(self):
        """The distinct bootstrap signatures of _boot_sequence, in order."""
        return list(dict.fromkeys(self._boot_sequence()))

    def _boot_windows(self, arg_meta=None):
        """[(window index, (input rows, scale, target level))] of the
        segment plan's boot windows, by the metadata walk from arg_meta
        (default: the compiled arguments), walked once per arg_meta."""
        arg_meta = tuple(tuple(m) for m in (arg_meta or self._arg_meta()))
        out = self._boot_win.get(arg_meta)
        if out is None:
            meta = dict(enumerate(arg_meta))
            out = self._boot_win[arg_meta] = []
            for wi, info in enumerate(self._segment_plan()):
                for op in info["ops"]:
                    if op.opcode == OP_BOOTSTRAP:
                        out.append((wi, meta[op.lhs] + (op.rhs,)))
                    self._meta_step(op, meta)
        return out

    def boot_plan(self, path="segment", arg_meta=None):
        """[(window index, signature, None or why it runs eagerly)] of the
        native boot windows of a request on `path` (boot_window_plan, module
        docstring): None where the window replays its signature's CUDA
        graph on the card. Empty without native bootstraps."""
        bs = self.bootstrapper
        if not isinstance(bs, NativeBootstrapper):
            return []
        windows = self._boot_windows(arg_meta)
        return boot_window_plan(windows, bs.graph_plan([sig[:2] for _, sig in windows]), path,
                                self.s.keys.galois.budget is not None, self._mesh is not None)

    def _plan_bootstrap_planes(self, cid_info, cid_qp):
        """Under a memory limit (_hbm_limit), bound the native
        bootstrapper's cached diagonals and constants, planned over the
        request's bootstrap signatures (NativeBootstrapper.set_plane_budget),
        path by path (path_budgets, _use_path); the group of the signature
        the first bootstrap reads stays where held, so a load again on the
        same scheme does not encode it again. Each distinct input scale
        encodes its own
        CoeffToSlot planes: ResNet-20 on tpu_n15b has 7 such signatures, 37
        GB of planes unbounded."""
        bs = self.bootstrapper
        limit = self._hbm_limit()
        if not isinstance(bs, NativeBootstrapper) or limit is None:
            return
        self._path_budgets = self.path_budgets(
            limit, self.key_bytes, self.plain_bytes + self.pool_bytes, self._streaming,
            self.eager_plain_bytes(cid_info, cid_qp))
        bs.set_plane_budget(self._path_budgets["segment"][1],
                            [(nl, sc) for nl, sc, _ in self._boot_sequence()])

    @classmethod
    def path_budgets(cls, limit, key_bytes, plaintext_bytes, streaming, eager_bytes):
        """{path: (plaintext LRU bytes, native bootstrap plane bytes)} for
        the per-op and segment paths under a memory limit: the planes get
        what the galois keys and the plaintexts (resident planes or the
        compact pool) leave of their two budgets ((KEY_BUDGET_FRAC +
        PTXT_BUDGET_FRAC) of the limit; none when the keys take it all, and
        then only the running signature's stay), less what the plaintext
        LRU may hold on the path when the plaintexts stream: its whole
        budget per op, where every plaintext passes through it, and on the
        segment path `eager_bytes`, the plaintexts of the eager windows
        (the graphs decode theirs)."""
        pt_budget = int(cls.PTXT_BUDGET_FRAC * limit)
        free = (int((cls.KEY_BUDGET_FRAC + cls.PTXT_BUDGET_FRAC) * limit) - key_bytes
                - plaintext_bytes)
        lru = (dict(per_op=pt_budget, segment=min(pt_budget, eager_bytes)) if streaming
               else dict(per_op=0, segment=0))
        return {path: (b, max(free - b, 0)) for path, b in lru.items()}

    def eager_plain_bytes(self, cid_info, cid_qp):
        """Device bytes of the decoded planes of every plaintext that the
        segment plan's eager windows (below SEGMENT_MIN_OPS ops) read,
        through the plaintext LRU when the plaintexts stream
        (_plaintext_plan's cid_info and cid_qp)."""
        cids = {self._pt_cid[r] for info in self._segment_plan()
                if info["kind"] == "seg" and not self._graph_window(info)
                for r in info["plain_regs"]}
        return self.resident_plain_bytes([cid_info[c] for c in cids],
                                         [cid_qp[c] for c in cids])

    def _use_path(self, path):
        """Before a request on `path` ("per_op" or "segment"): the
        plaintext LRU's bound and the native bootstrapper's plane bound of
        the path (_plan_bootstrap_planes; `plane_bound` False lifts the
        latter); a lower bound drops what passes it now, all but the planes
        of the signature the request bootstraps first, which it would
        encode again at once (its bootstrap holds them anyway). The per-op
        path first drops the native bootstrap's graphs, which releases
        their pinned planes, and the whole-program graph's, to its bound
        (graph_epoch: the next segment or whole-program request captures
        them again). With streaming plaintexts it drops every graph of the
        executor too: the per-op path's plaintext LRU may take its whole
        budget, which the memory plan never left to the graphs' pools
        (SqueezeNet on tpu_n15b: 11.7 GB of segment graphs beside a 10.2 GB
        LRU pass an 80 GB card)."""
        if path == "per_op" and isinstance(self.bootstrapper, NativeBootstrapper):
            self.bootstrapper.drop_graphs()
            self._boot_dep = None
        if path == "per_op" and self._streaming:
            self._captured = self._captured_batch = None
        if self._path_budgets is None:
            return
        self._lru_budget, planes = self._path_budgets[path]
        self._trim_lru()
        self.bootstrapper.set_plane_budget(planes if self.plane_bound else None)

    def warm_bootstraps(self):
        """Run each distinct native bootstrap of the program once over a
        zero ciphertext: its galois keys, conjugation key and plaintext
        diagonals are made now. HEVM.load does this on the card, after
        preprocess; the CPU keeps the JAX package's lazy order.
        `bootstrap_stats` then holds the signatures run and what the
        bootstrapper holds after each (NativeBootstrapper.cached_planes).
        Returns the number run."""
        bs = self.bootstrapper
        if not isinstance(bs, NativeBootstrapper):
            return 0
        sigs = self._boot_signatures()
        after = []
        for nl, sc, target in sigs:
            zero = torch.zeros((2, nl, self.s.ctx.n), dtype=torch.int32,
                               device=self.s.device)
            bs.bootstrap(zero, nl, sc, target)
            after.append(bs.cached_planes())
        self.bootstrap_stats = dict(signatures=[list(sig) for sig in sigs],
                                    planes_after=after,
                                    galois_keys=len(self.s.keys.galois),
                                    plane_budget=bs.plane_budget, evictions=bs.evictions,
                                    reencodes=bs.reencodes)
        return len(sigs)

    def capture_oracle(self, batch=None):
        """Capture the device oracle's CUDA graph of each distinct bootstrap
        of the program (one per cache key, crypto/bootstrap.py), as the
        reference jits its oracle once per key; batch=B: the graphs over a
        batch of B (the batch path's). HEVM.load does this on the card; a
        bootstrap captures its key's graph at first use otherwise. Returns
        the number of graphs the oracle holds: 0 on the CPU, with native
        bootstraps and on the host-RNG path."""
        bs = self.bootstrapper
        if (self.s.device.type != "cuda" or not isinstance(bs, EmulatedBootstrapper)
                or bs.host_rng):
            return 0
        for nl, sc, target in self._boot_signatures():
            if nl >= 2:
                bs.capture(nl, sc, target, batch)
        return len(bs._graphs)

    def precompile_bootstraps(self, arg_meta=None):
        """Capture, on the card, the native bootstrap's CUDA graph of every
        signature the segment path's plan replays (boot_plan), after the
        segment graphs (precompile_segments; HEVM.load does both). Returns
        the number of graphs: 0 on the CPU and without native
        bootstraps."""
        arg_meta = arg_meta or self._arg_meta()
        self._graphs(arg_meta)
        self._boot_graphs(arg_meta)
        bs = self.bootstrapper
        return len(bs._graphs) if isinstance(bs, NativeBootstrapper) else 0

    def _boot_graphs(self, arg_meta):
        """Before a segment request: its boot windows' plan (boot_plan) as
        {window index: None (a replay) or why it runs eagerly}. On the card
        the graphs the plan replays are made: captured after the segment
        graphs into their pool (the first time, and again when the keys or
        the segment graphs changed, or after the per-op path dropped them;
        a signature no bootstrap has run yet is warmed first), the others
        dropped. capture_stats["boot"] gets their count, seconds and pool
        bytes. Raises if a capture fails."""
        bs = self.bootstrapper
        if not isinstance(bs, NativeBootstrapper):
            return {}
        if self.s.device.type == "cuda":
            for nl, sc, target in dict.fromkeys(sig for _, sig in self._boot_windows(arg_meta)):
                if (nl, sc) not in bs._sig_planes and bs.capture_blocker() is None:
                    bs.warm(nl, sc, target)
        plan = self.boot_plan("segment", arg_meta)
        if self.s.device.type != "cuda":
            return {wi: why or "cpu" for wi, _, why in plan}
        if self._seg_pool is None:
            self._seg_pool = torch.cuda.graph_pool_handle()
        want = list(dict.fromkeys(sig for _, sig, why in plan if why is None))
        if (self._boot_dep != ("pool", self._seg_pool) or set(bs._graphs) - set(want)
                or not all(map(bs._current, bs._graphs.values()))):
            bs.drop_graphs()
            if self.capture_stats is not None:
                self.capture_stats.pop("boot", None)
        self._boot_dep = ("pool", self._seg_pool)
        missing = [sig for sig in want if sig not in bs._graphs]
        if missing:
            recs = [bs.capture(*sig, pool=self._seg_pool) for sig in missing]
            torch.cuda.synchronize(self.s.device)
            if self.capture_stats is None:
                self.capture_stats = {}
            stats = self.capture_stats.setdefault("boot", dict(
                graphs=0, signatures=[], warmup_s=0.0, capture_s=0.0, instantiate_s=0.0,
                pool_bytes=0, ntt_in_graphs=dict.fromkeys(ntt_kernel.RECORDED, 0)))
            stats["graphs"] = len(bs._graphs)
            stats["signatures"] = [list(sig) for sig in bs._graphs]
            for rec in recs:
                for k in ("warmup_s", "capture_s", "instantiate_s", "pool_bytes"):
                    stats[k] += rec[k]
                for k, v in rec["ntt"].items():
                    stats["ntt_in_graphs"][k] += v
            stats["windows"] = sum(why is None for _, _, why in plan)
        return {wi: why for wi, _, why in plan}

    # ------------------------------------------------------------ preprocess
    def preprocess(self):
        """Pre-encode all plaintexts offline (SEAL_HEVM.cpp:242-267):
        payload-identical encodes are deduplicated, encode scales / upscale
        multipliers follow the scale steering solution (vm/steer.py). Under
        the plaintext budget they stay resident as NTT-domain planes, device
        NTTs batched per level; over it (module docstring) each unique
        payload becomes one compact record of the device pool."""
        # the graphs read the plaintexts replaced here (and the native
        # bootstrap's are planned again below)
        self._captured = self._captured_batch = None
        if isinstance(self.bootstrapper, NativeBootstrapper):
            self.bootstrapper.drop_graphs()
        enc = self.s.encoder
        ctx = self.s.ctx
        dev = self.s.device
        cid_info, cid_regs, cid_qp = self._plaintext_plan()
        nq, alpha = ctx.config.num_q, ctx.config.alpha
        sp_rows = [nq + i for i in range(alpha)]
        need = self.resident_plain_bytes(cid_info, cid_qp)
        self._streaming = self._pt_budget is not None and need > self._pt_budget
        self._pt_pool, self._pt_rows, self._pt_groups = None, {}, {}
        self._pt_dev, self._pt_dev_bytes = OrderedDict(), 0
        self.plain_bytes = self.pool_bytes = 0
        self.n_plains = len(cid_info)
        if self._streaming:
            # the compact pool, 2 rows of N words per unique payload, filled
            # chunk by chunk on the device
            pool = torch.empty((len(cid_info), 2, ctx.n), dtype=torch.int32, device=dev)
            starts = range(0, len(cid_info), self.PT_ENCODE_BATCH)

            def encode(i):
                chunk = cid_info[i: i + self.PT_ENCODE_BATCH]
                return enc.encode_compact_batch([c[0] for c in chunk], [c[2] for c in chunk])

            for i, records in zip(starts, host_ahead(encode, starts)):
                pool[i: i + len(records)] = to_dev(records, dev)
            self._pt_pool, self.pool_bytes = pool, pool.nbytes
            for cid, (_, nl, _) in enumerate(cid_info):
                self._pt_rows[cid] = list(range(nl)) + (sp_rows if cid_qp[cid] else [])
                for dst in cid_regs[cid]:
                    self.plains[dst] = cid          # a pool id: decoded at use
            held = (f"streaming: compact pool {self.pool_bytes} bytes (resident "
                    f"planes {need} bytes > budget {self._pt_budget})")
        else:
            self._preencode(cid_info, cid_regs, cid_qp, sp_rows)
            held = f"{self.plain_bytes} bytes resident"
        print(f"[hevm] {self.n_plains} unique plaintexts of "
              f"{sum(1 for o in self.prog.ops if o.opcode == OP_ENCODE)} "
              f"encodes: {held}; {self.n_keys} galois keys: {self.key_bytes} bytes",
              file=sys.stderr, flush=True)
        # every upscale's multiplier on the device now: a graph window that
        # would upload its own could not record at once (_seg_graph)
        for op in self.ops:
            if op.opcode in (OP_UPSCALE, OP_UPRESCALE):
                self._getuk(op)
        self._plan_bootstrap_planes(cid_info, cid_qp)

    def _plaintext_plan(self):
        """The host half of preprocess, which needs no key and no device:
        the scale steering solution, each encode's (nl, scale) in
        `plain_meta` (what the metadata walk reads) and the payload-identical
        dedup. Returns (cid -> (data, nl, scale), cid -> [dst regs],
        cid -> fed to a fused rot-mac bank: QP rows)."""
        ctx = self.s.ctx
        st = steer_scales(self.prog, [int(q) for q in ctx.q_primes], self.rr,
                          ctx.config.prime_bits)
        nq = ctx.config.num_q
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
            self._pt_cid[op.dst] = cid
            self.plain_meta[op.dst] = (nl, sc)
        # plaintexts feeding fused rot-mac banks need the extended Q^{(nl)}P
        # basis (lazy-ModDown masks): extra `alpha` special-prime rows
        cid_qp = [any(r in self._fused_pt_regs for r in regs) for regs in cid_regs]
        return cid_info, cid_regs, cid_qp

    def resident_plain_bytes(self, cid_info, cid_qp):
        """Device bytes of the plaintexts kept resident as NTT planes (what
        preprocess holds against the plaintext budget)."""
        ctx = self.s.ctx
        return sum((nl + (ctx.config.alpha if qp else 0)) * ctx.n * 4
                   for (_, nl, _), qp in zip(cid_info, cid_qp))

    def _preencode(self, cid_info, cid_regs, cid_qp, sp_rows):
        """The resident planes: host-encode the unique payloads grouped by
        (nl, qp-extended), one vectorized FFT per batch, then one
        prime-major NTT per batch."""
        by_grp = {}
        for cid, (_, nl, _) in enumerate(cid_info):
            by_grp.setdefault((nl, cid_qp[cid]), []).append(cid)
        jobs = []                       # (rows, cids) of each batch
        for (nl, qp), cids in by_grp.items():
            rows_list = list(range(nl)) + (sp_rows if qp else [])
            i = 0
            while i < len(cids):
                bsz = next(b for b in self.NTT_BATCH if b <= len(cids) - i)
                jobs.append((rows_list, cids[i: i + bsz]))
                i += bsz

        def encode(job):
            return self.s.encoder.scaled_coeffs_batch(
                [cid_info[c][0] for c in job[1]], [cid_info[c][2] for c in job[1]])

        for (rows_list, chunk), prod in zip(jobs, host_ahead(encode, jobs)):
            bsz, nrows = len(chunk), len(rows_list)
            blk = self.ev.encoded_residues(self.s.encoder, prod, rows_list)  # [bsz, nrows, N]
            flat = blk.transpose(0, 1).reshape(bsz * nrows, -1).contiguous()
            rows = [r for r in rows_list for _ in range(bsz)]
            out = self.ev.ntt(flat, rows)
            out = out.reshape(nrows, bsz, -1).transpose(0, 1)
            for k, c in enumerate(chunk):
                planes = out[k].contiguous()
                self.plain_bytes += planes.nbytes
                for dst in cid_regs[c]:
                    self.plains[dst] = planes

    def _pt_insert(self, cid, planes):
        """Add decoded planes to the LRU, then evict the oldest entries while
        over the budget (a single entry stays, however large)."""
        self._pt_dev[cid] = planes
        self._pt_dev_bytes += planes.nbytes
        self._trim_lru()

    def _trim_lru(self):
        limit = self._pt_budget if self._lru_budget is None else self._lru_budget
        while self._pt_dev_bytes > limit and len(self._pt_dev) > 1:
            _, old = self._pt_dev.popitem(last=False)
            self._pt_dev_bytes -= old.nbytes

    def _plain(self, idx, nl):
        """NTT planes [:nl] of plaintext register idx: resident, or when
        streaming decoded from the pool at first use and kept in the LRU."""
        p = self.plains[idx]
        if isinstance(p, int):
            hit = self._pt_dev.get(p)
            if hit is None:
                hit = self.ev.decode_plain(self._pt_pool[p: p + 1], self._pt_rows[p])[0]
                self._pt_insert(p, hit)
            else:
                self._pt_dev.move_to_end(p)
            p = hit
        return p if nl is None else p[:nl]

    def _plain_prefetch(self, regs):
        """Decode the plaintexts of a fused bank that the LRU lacks, PT_BATCH
        at a time per row tuple: one decode per chunk instead of one per
        mask (the eager paths)."""
        if not self._streaming:
            return
        missing = {}
        for r in regs:
            cid = self._pt_cid[r]
            if cid is not None and cid not in self._pt_dev:
                missing.setdefault(tuple(self._pt_rows[cid]), set()).add(cid)
        for rows, cidset in missing.items():
            cids = sorted(cidset)
            i = 0
            while i < len(cids):
                bsz = next(b for b in self.PT_BATCH if b <= len(cids) - i)
                chunk = cids[i: i + bsz]
                idx = upload(torch.tensor(chunk, dtype=torch.int64), self.s.device)
                out = self.ev.decode_plain(self._pt_pool[idx], rows)
                for k, cid in enumerate(chunk):
                    # a copy, so that an eviction frees its bytes
                    self._pt_insert(cid, out[k].clone() if bsz > 1 else out[k])
                i += bsz

    def _plain_rows_qp(self, full, reg, nl):
        """Q^{(nl)}P rows of a QP-encoded plaintext: first nl Q rows plus the
        alpha special rows stored after the encode-level Q rows."""
        nl_enc = self.plain_meta[reg][0]
        alpha = self.s.ctx.config.alpha
        return torch.cat([full[:nl], full[nl_enc: nl_enc + alpha]])

    # ------------------------------------------------------------ dispatch
    def _exec_stream(self, ops, ciphers, meta, out_regs, getplain=None, getgk=None):
        """Interpret the instruction stream over device tensors. Mutates
        `ciphers`/`meta`; returns the tensors of `out_regs`. getplain(reg,
        nl): a plaintext's planes; by default `_plain` (resident, or the
        LRU with a fused bank's masks prefetched), else a window's decoded
        planes (`_seg_body`). getgk(steps): a galois key; by default the
        key store (resident, or its LRU), else a window's arena slots.

        Rotations run LAZILY: every `rotatec` of the same source joins a
        pending bank, flushed as ONE hoisted batched rotation
        (Evaluator.rotate_batch) the first time any of its results is read.
        """
        ev = self.ev
        if getgk is None:
            getgk = self.s.keys.galois.__getitem__
        rlk = self.s.keys.rlk
        prefetch = None
        if getplain is None:
            getplain = self._plain
            if self._streaming:
                prefetch = self._plain_prefetch
        banks_by_src = {}      # (id(src), nl) -> bank
        bank_of_dst = {}       # dst reg -> bank

        def flush(bank):
            entries = bank["entries"]
            steps = [st for _, st in entries]
            out = ev.rotate_batch(bank["src"], bank["nl"], steps,
                                  [getgk(st) for st in steps])
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
                if prefetch is not None:
                    prefetch(list(op.pt_regs) + list(op.plain_pts))
                extras = [materialize(r) for r in op.extra]
                pvals = [materialize(r) for r in op.plain_vals]
                ppts = [getplain(r, nl) for r in op.plain_pts]
                src = digits = shifts = None
                gks, pts = [], []
                if op.src >= 0:
                    src = materialize(op.src)
                    shifts = list(op.steps)
                    gks = [getgk(st) for st in op.steps]
                    pts = [self._plain_rows_qp(getplain(r, None), r, nl)
                           for r in op.pt_regs]
                    dkey = (op.src, nl)
                    hit = dig_cache.get(dkey)
                    if hit is not None and hit[0] is src:
                        digits = hit[1]
                        dig_cache[dkey] = dig_cache.pop(dkey)  # LRU touch
                    else:
                        digits = ev.modup(src[..., 1, :, :], nl)
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
                    ciphers[op.lhs], getplain(op.rhs, nl), nl)
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
                    ciphers[op.lhs], getplain(op.rhs, nl), nl)
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

    def precompile_segments(self, arg_meta=None, batch=None):
        """Capture every window of the segment plan as a CUDA graph before
        the first request, as the JAX package compiles them here. arg_meta:
        [(nl, scale)] per argument, by default the compiled ones; batch=B:
        the graphs of the batch path over B ciphertexts (held apart from
        the single-request graphs, one batch size at a time). Returns the
        number of graphs: 0 on the CPU, where the plan runs eagerly.
        Raises if a capture fails."""
        return len(self._graphs(arg_meta or self._arg_meta(), batch))

    def _graphs(self, arg_meta, batch=None):
        """{window index: graph record} of the segment plan for arguments of
        this metadata and batch size (None: a single request; {} on the
        CPU), captured at first use and again whenever what they were
        captured for changed (_capture_key)."""
        if self.s.device.type != "cuda":
            return {}
        slot = "_captured" if batch is None else "_captured_batch"
        want = self._capture_key("segments", arg_meta, batch)
        graphs = self._held(slot, want)
        if graphs is not None:
            return graphs
        setattr(self, slot, None)             # free the old graphs first
        plan = self._segment_plan()
        graphs = (self._capture(plan, arg_meta) if batch is None
                  else self._capture(plan, arg_meta, batch))
        setattr(self, slot, want + (graphs,))
        return graphs

    def _capture_key(self, kind, arg_meta, batch=None):
        """What graphs of `kind` ("segments": the segment plan's, "whole":
        the whole-program graph) for arguments of arg_meta and a batch
        size are captured for and read besides their own buffers:
        ((kind, metadata, batch, where the keys are read from), the key
        objects). A graph reads the keys from the resident device key
        tensors (GaloisStore.generation: at the addresses it was captured
        with) or, under a budget, from the arena (made again when the
        budget changes; an LRU eviction changes nothing a graph reads, and
        a replaced key is staged). The whole-program graph also reads the
        conjugation key and the native bootstrap's planes it pinned, which
        `drop_graphs` releases (graph_epoch). The key objects themselves,
        not ids, are held with the graphs: they outlive the graphs that
        read them."""
        keys = self.s.keys
        arena = self._key_arena()
        dep = (("arena", arena["serial"]) if arena is not None
               else ("resident", keys.galois.generation))
        objs = (keys, keys.galois)
        if kind == "whole":
            bs = self.bootstrapper
            dep += (bs.graph_epoch if isinstance(bs, NativeBootstrapper) else None,)
            objs += (keys.conj,)
        return (kind, tuple(tuple(m) for m in arg_meta), batch, dep), objs

    def _held(self, slot, want):
        """The graphs held in `slot` where they were captured for `want`
        (_capture_key; key objects compared by identity), else None."""
        hit = getattr(self, slot)
        if (hit is not None and hit[0] == want[0]
                and all(a is b for a, b in zip(hit[1], want[1]))):
            return hit[2]
        return None

    def _graph_window(self, info):
        """A window that runs as one graph on the card (and through
        `_seg_body` on the CPU): a segment of at least SEGMENT_MIN_OPS ops."""
        return info["kind"] == "seg" and len(info["ops"]) >= self.SEGMENT_MIN_OPS

    def key_arena(self):
        """Make the galois-key slot arena now (HEVM.load does, under a key
        budget) and return its number of slots: 0 without a budget."""
        arena = self._key_arena()
        return 0 if arena is None else len(arena["held"])

    def _key_arena(self):
        """The arena of the graph windows' galois keys under a budget
        (module docstring), made at first use and again when the budget or
        the key store changed; None without a budget. Its slots are
        `key_slot_count`'s, with the conjugation key of a native bootstrap
        reserved beside them (an arena past the budget is said on stderr).
        On making it the host keys are pinned, the LRU evicts to leave the
        arena its bytes, and each slot gets the key it holds when a request
        starts."""
        galois = self.s.keys.galois
        old = self._arena
        if old is not None and old["galois"] is galois and old["budget"] == galois.budget:
            return old
        if old is not None:
            self._captured = self._captured_batch = None     # graphs over the old arena
            self._arena = None
            old["galois"].reserve(0)
        if galois.budget is None:
            return None
        galois.pin_host()
        plan = self._segment_plan()
        wins = [wi for wi, info in enumerate(plan)
                if self._graph_window(info) and info["rot_steps"]]
        seq = [plan[wi]["rot_steps"] for wi in wins]
        kb = self.s.galois_key_bytes()
        conj = kb if isinstance(self.bootstrapper, NativeBootstrapper) else 0
        n = key_slot_count(seq, galois.budget, kb, conj)
        if (n + 1) * kb + conj > galois.budget:
            print(f"[hevm] a window reads {n} galois keys: the arena's {n * kb} bytes "
                  f"leave the LRU less than one key of the budget {galois.budget}",
                  file=sys.stderr)
        maps, start, copies = plan_key_slots(seq, n)
        cfg = self.s.ctx.config
        # the LRU evicts to the budget's rest first: a load's bootstrap
        # warm-up may have left the LRU holding the bootstrap's keys
        # (SqueezeNet on tpu_n15b: 12 GB beside a 46.6 GB arena)
        galois.reserve(n * kb + conj)
        data = torch.empty((n, cfg.dnum, 2, self.ev.key_rows(), self.s.ctx.n),
                           dtype=torch.int32, device=galois.device)
        self._arena_serial += 1
        arena = self._arena = dict(
            galois=galois, budget=galois.budget, serial=self._arena_serial,
            slots=dict(zip(wins, maps)), data=data, held=[None] * n,
            copies=copies, lru_copies=lru_key_copies(seq, n))
        for s, st in enumerate(start):
            if st is not None:
                self._stage(arena, s, st)
        return arena

    def _stage(self, arena, s, st):
        """Copy key `st` into slot s unless it holds it (this version)."""
        galois = self.s.keys.galois
        want = (st, galois.version(st))
        if arena["held"][s] != want:
            src, on_device = galois.stage_source(st)
            arena["data"][s].copy_(src, non_blocking=True)
            arena["held"][s] = want
            kind = "device" if on_device else "host"
            self.key_staging[kind] += 1
            self.key_staging[kind + "_bytes"] += src.nbytes

    def _stage_keys(self, wi):
        """Before window wi runs under a budget: its keys into its slots."""
        arena = self._arena
        for st, s in arena["slots"].get(wi, {}).items():
            self._stage(arena, s, st)

    def _capture(self, plan, arg_meta, batch=None):
        """Capture walk over the plan with _meta_step: one graph for every
        window of at least SEGMENT_MIN_OPS ops, all in one memory pool and
        in plan order (the replays keep that order, which is what lets the
        graphs share the pool). A register an earlier graph writes is read
        at that graph's static output; every other input (an argument, an
        oracle or eager-window output) gets a zeroed static buffer, [B, 2,
        nl, N] for a batch of B, that the replay copies into. Nothing random
        is drawn: the MLP's first request stays bit-equal to the JAX
        package's. With streaming plaintexts each graph decodes its own
        (`_seg_body`): the stats count the rows a request decodes and the
        largest window's decoded bytes."""
        dev = self.s.device
        n = self.s.ctx.n
        lead = () if batch is None else (batch,)
        meta = dict(enumerate(arg_meta))
        graph_out = {}        # register -> static output of an earlier graph
        stream = torch.cuda.Stream(dev)
        pool = torch.cuda.graph_pool_handle()
        if batch is None:
            self._seg_pool = pool
        graphs = {}
        decode_rows = []      # rows each graph decodes
        for wi, info in enumerate(plan):
            if self._graph_window(info):
                if self._streaming:
                    decode_rows.append(sum(len(rows) * len(regs) for rows, regs, _
                                           in self._seg_pt_groups(wi, info)))
                ins = [graph_out[r] if r in graph_out else
                       torch.zeros(lead + (2, meta[r][0], n), dtype=torch.int32,
                                   device=dev)
                       for r in info["ins"]]
                rec = graphs[wi] = self._seg_graph(
                    wi, info, {r: meta[r] for r in info["ins"]}, ins, stream, pool)
                graph_out.update(zip(info["outs"], rec["outs"]))
            for op in info["ops"]:
                self._meta_step(op, meta)
            for r in info["dead"]:
                graph_out.pop(r, None)
        arena = self._arena
        stats = dict(
            windows=len(plan), graphs=len(graphs),
            **{k: sum(g[k] for g in graphs.values())
               for k in ("warmup_s", "capture_s", "collectives")},
            warmed=sum(g["warmed"] for g in graphs.values()),
            nodes=sum(g["nodes"] for g in graphs.values()),
            ntt_in_graphs={k: sum(g["ntt"][k] for g in graphs.values())
                           for k in ntt_kernel.RECORDED},
            key_slots=0 if arena is None else len(arena["held"]),
            key_arena_bytes=0 if arena is None else arena["data"].nbytes,
            key_copies_planned=0 if arena is None else arena["copies"],
            key_copies_lru=0 if arena is None else arena["lru_copies"])
        if self._streaming:
            stats.update(decode_rows=sum(decode_rows),
                         decode_max_bytes=max(decode_rows, default=0) * n * 4)
        if batch is None:
            self.capture_stats = stats
        else:
            self.batch_capture_stats = dict(stats, batch=batch)
        return graphs

    def _seg_pt_groups(self, wi, info):
        """Window wi's plaintext registers grouped by decode row tuple, in
        row-tuple order (reference _seg_pt_groups): [(rows, regs, index)],
        index the registers' pool ids as a device tensor. Made once per
        preprocess, before any capture, with each group's decode tables
        (Evaluator.decode_tables): nothing uploads under capture."""
        groups = self._pt_groups.get(wi)
        if groups is None:
            by_rows = {}
            for r in info["plain_regs"]:
                by_rows.setdefault(tuple(self._pt_rows[self._pt_cid[r]]), []).append(r)
            groups = self._pt_groups[wi] = [
                (rows, regs, upload(torch.tensor([self._pt_cid[r] for r in regs],
                                                 dtype=torch.int64), self.s.device))
                for rows, regs in sorted(by_rows.items())]
            for rows, regs, _ in groups:
                self.ev.decode_tables(rows, len(regs))
        return groups

    def _seg_body(self, wi, info, ciphers, meta):
        """Window wi (at least SEGMENT_MIN_OPS ops) as its graph runs it, and
        as the CPU runs it eagerly. With streaming plaintexts it first
        gathers each group's records from the pool and decodes them, one
        decode per group (the reference's in-graph decode), then interprets
        the window over those planes; under a key budget it reads its keys
        from its arena slots."""
        getplain = None
        if self._streaming:
            planes = {}
            for rows, regs, idx in self._seg_pt_groups(wi, info):
                planes.update(zip(regs, self.ev._decode_plain(self._pt_pool[idx], rows)))

            def getplain(r, nl):
                return planes[r] if nl is None else planes[r][:nl]

        getgk = None
        if self._arena is not None:
            slots, data = self._arena["slots"].get(wi, {}), self._arena["data"]

            def getgk(st):
                return data[slots[st]]

        return self._exec_stream(info["ops"], ciphers, meta, info["outs"], getplain, getgk)

    def _seg_graph(self, wi, info, in_meta, ins, stream, pool):
        """Capture window wi's _seg_body into one CUDA graph over the static
        inputs `ins` (aligned with info["ins"]). No upload from host memory
        may run under capture, so the window's device caches (the
        Evaluator's, the executor's, the decode tables) must be full before
        it records. It records at once; a cache that would fill under
        capture stops the recording before the copy (UploadUnderCapture),
        and then, or always over a mesh (every rank must make the same
        collectives), the window first runs once eagerly on the capture
        stream over the same inputs, which fills them, and records again.
        Returns the record: graph, ins, outs (static outputs, aligned with
        info["outs"]), warmup_s (0 where the window recorded at once),
        capture_s (recording and instantiation) and nodes."""
        def body():
            return self._seg_body(wi, info, dict(zip(info["ins"], ins)), dict(in_meta))

        shard = self.ev.shard
        gathers = shard.gathers if shard is not None else 0
        # over a mesh the graph records NCCL all-gathers, whose process
        # group's watchdog thread queries CUDA events while this thread
        # captures: only this thread's calls must be capture-safe
        mode = "global" if shard is None else "thread_local"
        ntt0 = dict(ntt_kernel.RECORDED)
        t0 = time.perf_counter()
        rec, warmup_s = None, 0.0
        if shard is None:
            try:
                rec = graphs.record(body, stream, pool, mode)
            except UploadUnderCapture:
                ntt_kernel.RECORDED.update(ntt0)     # the dropped recording's
        if rec is None:
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                body()
            stream.synchronize()
            # the dropped recording's seconds are counted here too
            warmup_s = time.perf_counter() - t0
            rec = graphs.record(body, stream, pool, mode)
        return dict(graph=rec["graph"], ins=ins, outs=rec["out"], warmup_s=warmup_s,
                    warmed=warmup_s > 0,
                    capture_s=rec["capture_s"] + rec["instantiate_s"], nodes=rec["nodes"],
                    collectives=(shard.gathers - gathers) if shard is not None else 0,
                    ntt={k: v - ntt0[k] for k, v in ntt_kernel.RECORDED.items()})

    def _run_segmented(self, arg_cts, batch=None, boot=None):
        """Replay walk: per window, the bootstrap (boot: the device oracle
        replays its graph and returns a copy of the output), an eager run
        (no graph: a tiny window's _exec_stream, and on the CPU every other
        window's _seg_body), or: copy each
        input that is not already the graph's own static input in, replay,
        and bind the static outputs. Under a key budget a window of at least
        SEGMENT_MIN_OPS ops first gets its keys staged into its arena slots.
        Returns copies of the outputs, since the next replay overwrites a
        graph's outputs. batch=B: every register holds B ciphertexts, and
        the batch graphs replay; boot(data, nl, scale, target) -> (data,
        (nl2, scale)): a boot window's refresh, by default `_bootstrap`
        (over a mesh the caller's). A native boot window replays its
        signature's graph where the plan says so (_boot_graphs) and raises
        if it does not; `last_bootstraps` counts the replays and the eager
        bootstraps by reason."""
        self._use_path("segment")
        plan = self._segment_plan()
        arg_meta = [(nl, sc) for _, nl, sc in arg_cts]
        graphs = self._graphs(arg_meta, batch)
        boot_why = self._boot_graphs(arg_meta)
        bs = self.bootstrapper
        counts = self.last_bootstraps = dict(replayed=0, eager={})
        arena = self._key_arena()
        ciphers, meta = {}, {}
        for i, (data, nl, scale) in enumerate(arg_cts):
            ciphers[i] = data
            meta[i] = (nl, scale)
        prof = [] if self._segprof else None
        for wi, info in enumerate(plan):
            t0 = time.perf_counter()
            rec = graphs.get(wi)
            if arena is not None and self._graph_window(info):
                self._stage_keys(wi)
            if info["kind"] == "boot":
                op = info["ops"][0]
                nl, sc = meta[op.lhs]
                calls, replays = getattr(bs, "calls", 0), getattr(bs, "replays", 0)
                ciphers[op.dst], meta[op.dst] = (
                    boot(ciphers[op.lhs], nl, sc, op.rhs) if boot is not None
                    else self._bootstrap(ciphers[op.lhs], nl, sc, op.rhs, batch))
                if wi in boot_why:
                    self._count_boots(counts, boot_why[wi], bs.calls - calls,
                                      bs.replays - replays)
                kind = "boot"
            elif rec is None and self._graph_window(info):
                self._seg_body(wi, info, ciphers, meta)     # the CPU
                kind = "eager"
            elif rec is None:
                self._exec_stream(info["ops"], ciphers, meta, info["outs"])
                kind = "eager"
            else:
                for r, buf in zip(info["ins"], rec["ins"]):
                    if ciphers[r] is not buf:
                        buf.copy_(ciphers[r])
                rec["graph"].replay()
                self.replays += 1
                self.mesh_collectives += rec["collectives"]
                for k, v in rec["ntt"].items():
                    self.replayed_ntt[k] += v
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

    @staticmethod
    def _count_boots(counts, why, calls, replays):
        """Add a boot window's bootstraps to a request's counts: the
        replays, and the eager ones under `why`; a window planned as a
        replay (why None) that ran eagerly raises: nothing falls back."""
        counts["replayed"] += replays
        if calls > replays:
            if why is None:
                raise RuntimeError("a native boot window planned as a CUDA graph replay ran "
                                   "eagerly")
            counts["eager"][why] = counts["eager"].get(why, 0) + calls - replays

    def _bootstrap(self, data, nl, sc, target, batch):
        """A boot window: one bootstrap, or one refresh of a batch (the
        oracle's bootstrap_batch; the native bootstrap row by row, as in
        the reference)."""
        bs = self.bootstrapper
        if batch is None or isinstance(bs, EmulatedBootstrapper):
            return bs.bootstrap(data, nl, sc, target)
        rows = [bs.bootstrap(data[b], nl, sc, target) for b in range(batch)]
        return torch.stack([r[0] for r in rows]), rows[0][1]

    # --------------------------------------------------------- whole program
    def whole_path(self):
        """(path, why) of a jit=True request (module docstring): the JAX
        package's rule (`dacapo_tpu/vm/executor.py` run_encrypted), then the
        port's blockers. ("per_op", "debug") with debug on; ("segment",
        why) where the JAX package falls back too, "streaming" (plaintexts
        in the compact pool) and "oracle" (the emulated bootstrap, host-RNG
        or device), and for the port's own blockers: "key_budget" (the keys
        come through the key store's LRU), "mesh" (the keys are split over
        a mesh) and "dropped_group" (a native bootstrap signature the plane
        bound of the segment path cannot pin, NativeBootstrapper.
        graph_plan); else ("whole", None), or ("whole", "cpu") off the card,
        where the same walk runs eagerly."""
        if self.debug:
            return "per_op", "debug"
        if self._streaming:
            return "segment", "streaming"
        bs = self.bootstrapper
        if isinstance(bs, EmulatedBootstrapper):
            return "segment", "oracle"
        if self.s.keys.galois.budget is not None:
            return "segment", "key_budget"
        if self._mesh is not None:
            return "segment", "mesh"
        if isinstance(bs, NativeBootstrapper):
            budget = bs.plane_budget
            if self._path_budgets is not None:
                budget = self._path_budgets["segment"][1] if self.plane_bound else None
            sigs = [(nl, sc) for nl, sc, _ in self._boot_sequence()]
            if any(bs.graph_plan(sigs, budget).values()):
                return "segment", "dropped_group"
        return "whole", None if self.s.device.type == "cuda" else "cpu"

    def _whole_body(self, datas, arg_meta, boot):
        """The whole program as one function of the argument tensors
        `datas` ((nl, scale) each in arg_meta): the segment plan's windows
        in order, each graph window's _seg_body and each tiny window's
        _exec_stream, and every boot window's boot(data, nl, scale,
        target) inline. Returns (outputs, their (nl, scale))."""
        ciphers = dict(enumerate(datas))
        meta = dict(enumerate(tuple(m) for m in arg_meta))
        for wi, info in enumerate(self._segment_plan()):
            if info["kind"] == "boot":
                op = info["ops"][0]
                nl, sc = meta[op.lhs]
                ciphers[op.dst], meta[op.dst] = boot(ciphers[op.lhs], nl, sc, op.rhs)
            elif self._graph_window(info):
                self._seg_body(wi, info, ciphers, meta)
            else:
                self._exec_stream(info["ops"], ciphers, meta, info["outs"])
            for r in info["dead"]:
                ciphers.pop(r, None)
        return [ciphers[r] for r in self.res_dst], [meta[r] for r in self.res_dst]

    def precompile_whole(self, arg_meta=None):
        """Capture the whole-program CUDA graph before the first jit=True
        request (HEVM.load does, where whole_path allows it), for arguments
        of `arg_meta` (default: the compiled ones). Returns the number of
        graphs: 1, or 0 on the CPU, where the walk runs eagerly. Raises
        where whole_path sends the requests elsewhere, or if the capture
        fails."""
        path, why = self.whole_path()
        if path != "whole":
            raise RuntimeError(f"jit=True requests take the {path} path here: {why}")
        if self.s.device.type != "cuda":
            return 0
        self._whole_graph(arg_meta or self._arg_meta())
        return 1

    def _whole_graph(self, arg_meta):
        """The whole-program graph's record for arguments of arg_meta,
        captured at first use and again whenever what it was captured for
        changed (_capture_key): a key replaced, other argument metadata,
        preprocess run again, segment graphs captured in its place, and
        the native bootstrapper's graphs dropped (the per-op path, a
        segment request's boot graphs), which released its pinned
        planes."""
        rec = self._held("_captured", self._capture_key("whole", arg_meta))
        return rec if rec is not None else self._capture_whole(arg_meta)

    def _capture_whole(self, arg_meta):
        """Record _whole_body into one CUDA graph in a memory pool of its
        own, over zeroed static inputs. The segment graphs and the native
        bootstrap's graphs are freed first (a jit=True executor holds no
        other single-request graphs). One eager warm-up runs the walk first
        on the capture stream, each native bootstrap with its host
        bookkeeping (as `warm` does, the count and the request's position
        are restored after), and pins each signature's planes as it ran;
        then the walk is recorded with each bootstrap's device work
        (NativeBootstrapper._bootstrap), noting each one's signature and
        NTT calls for the replays' bookkeeping. Nothing uploads under
        capture (crypto/params.upload raises: a failed capture raises).
        capture_stats["whole"] gets the graph's nodes, windows and
        bootstraps, warm-up, recording and instantiation seconds, pool
        bytes and NTT calls recorded."""
        self._captured = None                 # free the old graphs first
        bs = self.bootstrapper if isinstance(self.bootstrapper, NativeBootstrapper) else None
        if bs is not None:
            bs.drop_graphs()
            self._boot_dep = None
        dev, n = self.s.device, self.s.ctx.n
        stream = torch.cuda.Stream(dev)
        ins = [torch.zeros((2, nl, n), dtype=torch.int32, device=dev) for nl, _ in arg_meta]
        t0 = time.perf_counter()
        saved = (bs.calls, bs._pos) if bs is not None else None

        def warm_boot(data, nl, sc, target):
            out = NativeBootstrapper.bootstrap(bs, data, nl, sc, target)
            bs._pin((int(nl), float(sc)))
            return out

        stream.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(stream):
                self._whole_body(ins, arg_meta, warm_boot)
        finally:
            if bs is not None:
                bs.calls, bs._pos = saved
        stream.synchronize()
        warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        boots = []
        ntt0 = dict(ntt_kernel.RECORDED)

        def rec_boot(data, nl, sc, target):
            b0 = dict(ntt_kernel.RECORDED)
            out = bs._bootstrap(data, nl, sc, target)
            boots.append(((int(nl), float(sc), int(target)),
                          {k: v - b0[k] for k, v in ntt_kernel.RECORDED.items()}))
            return out

        rec = graphs.record(lambda: self._whole_body(ins, arg_meta, rec_boot), stream,
                            torch.cuda.graph_pool_handle())
        outs, out_meta = rec["out"]
        total = {k: v - ntt0[k] for k, v in ntt_kernel.RECORDED.items()}
        whole = dict(
            graph=rec["graph"], ins=ins, outs=outs, out_meta=out_meta, boots=boots,
            # the windows' NTT calls; each bootstrap's go to the bootstrapper
            ntt={k: v - sum(b[k] for _, b in boots) for k, v in total.items()})
        # after the warm-up, which may have made keys
        self._captured = self._capture_key("whole", arg_meta) + (whole,)
        self.capture_stats = {"whole": dict(
            graphs=1, windows=len(self._segment_plan()), bootstraps=len(boots),
            signatures=[list(sig) for sig in dict.fromkeys(sig for sig, _ in boots)],
            nodes=rec["nodes"], warmup_s=warmup_s, capture_s=rec["capture_s"],
            instantiate_s=rec["instantiate_s"],
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved, ntt_in_graphs=total)}
        return whole

    def _run_whole(self, arg_cts):
        """A jit=True request on the whole-program path. On the card: copy
        the arguments into the graph's static inputs, replay it once, and
        keep, for each bootstrap it holds, the host bookkeeping a replay of
        its own graph keeps (NativeBootstrapper.count_replay); the outputs
        are cloned. On the CPU the walk runs eagerly, each native bootstrap
        through `bootstrap` (counted eager, "cpu"). `last_bootstraps`
        counts the request's bootstraps, as the segment path does."""
        self._use_path("segment")
        arg_meta = [(nl, sc) for _, nl, sc in arg_cts]
        bs = self.bootstrapper
        counts = self.last_bootstraps = dict(replayed=0, eager={})
        if self.s.device.type != "cuda":
            calls = getattr(bs, "calls", 0)
            outs, out_meta = self._whole_body([d for d, _, _ in arg_cts], arg_meta,
                                              None if bs is None else bs.bootstrap)
            if isinstance(bs, NativeBootstrapper):
                self._count_boots(counts, "cpu", bs.calls - calls, 0)
            return [o.clone() for o in outs], out_meta
        rec = self._whole_graph(arg_meta)
        for buf, (data, _, _) in zip(rec["ins"], arg_cts):
            buf.copy_(data)
        rec["graph"].replay()
        self.replays += 1
        for k, v in rec["ntt"].items():
            self.replayed_ntt[k] += v
        for (nl, sc, _), ntt in rec["boots"]:
            bs.count_replay(nl, sc, ntt)
        counts["replayed"] = len(rec["boots"])
        return [o.clone() for o in rec["outs"]], list(rec["out_meta"])

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
        precompile_segments ran), on the CPU eagerly; False dispatches per
        op; True asks for the whole program as one function, the JAX
        package's rule: the whole-program path (one CUDA graph a request on
        the card, captured at first use unless precompile_whole ran; on the
        CPU the same walk eagerly) where the executor does not stream its
        plaintexts and the program has no bootstrap or only native ones,
        else the segment path, as the JAX package falls back; the port
        also sends it to the segment path under a galois-key budget, over a
        mesh, and where the plane bound cannot pin every bootstrap
        signature (whole_path). With debug on (setDebug) every request
        dispatches per op. `last_path` holds the request's (path, why):
        why is None where the path is the one asked for (whole_path's
        reasons otherwise, "debug" with debug on)."""
        if not (isinstance(jit, bool) or jit in ("auto", "segment")):
            raise ValueError(f"jit must be 'auto', 'segment', True or False, not {jit!r}")
        if self.debug:
            path, why = "per_op", "debug"    # the trace prints per-op host metadata
        elif jit is True:
            path, why = self.whole_path()
        else:
            path, why = ("per_op" if jit is False else "segment"), None
        self.last_path = (path, why)
        run = dict(whole=self._run_whole, segment=self._run_segmented,
                   per_op=self._run_trace)[path]
        self._last_outputs = outs = run(arg_cts)
        return outs

    def run_encrypted_batch(self, arg_cts, mesh=None):
        """Batched server entry (the reference's run_encrypted_batch):
        arg_cts = [(data [B, 2, nl, N], nl, scale)], the same B for every
        argument. Walks the segment plan over the batch (module docstring):
        on the card as the batch graphs of B, captured at first use unless
        precompile_segments(batch=B) ran; on the CPU eagerly. mesh: a
        parallel.mesh.Mesh this rank belongs to (every rank of it calls with
        the same batch): the rank runs its block of rows (B >= dp, any B)
        with its rows of the keys, and every rank gets the whole batch back.
        Leaves (outs [each [B, 2, nl, N]], out_meta) in _last_outputs and
        returns them."""
        sizes = {int(data.shape[0]) for data, _, _ in arg_cts}
        if len(sizes) != 1 or any(data.dim() != 4 for data, _, _ in arg_cts):
            raise ValueError("every argument must be a batch [B, 2, nl, N] of one B, got "
                             f"{[tuple(data.shape) for data, _, _ in arg_cts]}")
        b = sizes.pop()
        if mesh is None:
            if self._mesh is not None:
                raise ValueError("this executor's keys are split over a mesh: pass it")
            self._last_outputs = self._run_segmented(arg_cts, batch=b)
            return self._last_outputs
        from ..parallel.mesh import batch_rows, gather_batch
        self.use_mesh(mesh)
        rows = batch_rows(mesh, b)
        mine = rows.stop - rows.start

        def boot(data, nl, sc, target):
            if isinstance(self.bootstrapper, EmulatedBootstrapper):
                out, m2 = self._bootstrap(gather_batch(mesh, data, b), nl, sc, target, b)
                return out[rows], m2
            return self._bootstrap(data, nl, sc, target, mine)

        outs, meta = self._run_segmented([(data[rows], nl, sc) for data, nl, sc in arg_cts],
                                         batch=mine, boot=boot)
        self._last_outputs = ([gather_batch(mesh, o, b) for o in outs], meta)
        return self._last_outputs

    def use_mesh(self, mesh):
        """Run the requests of this executor over `mesh` from now on (the
        batch path's; run_encrypted_batch calls it): the scheme keeps this
        rank's rows of every key-switch key (Scheme.shard_keys) and the
        Evaluator's key switches gather over the mesh's mp group. A native
        bootstrap's keys are made first, full, so that no key is drawn in a
        request: every rank then has drawn the same. The graphs captured
        over the full keys are dropped. Another mesh raises."""
        if self._mesh is mesh:
            return
        if self._mesh is not None:
            raise ValueError("this executor already runs over another mesh")
        if isinstance(self.bootstrapper, NativeBootstrapper):
            self.s.ensure_galois(self.bootstrapper.rotation_steps())
            self.s.keygen.ensure_conj(self.s.keys)
        self._captured = self._captured_batch = None
        self.s.shard_keys(RowShard(mesh.mp, mesh.mp_rank, mesh.mp_group))
        native = isinstance(self.bootstrapper, NativeBootstrapper)
        self.key_bytes = (self.n_keys + native) * self.s.galois_key_bytes()
        self._mesh = mesh

    def _run_trace(self, arg_cts):
        self._use_path("per_op")
        ciphers, meta = {}, {}
        for i, (data, nl, scale) in enumerate(arg_cts):
            ciphers[i] = data
            meta[i] = (nl, scale)
        bs = self.bootstrapper
        calls = getattr(bs, "calls", 0)
        outs = self._exec_stream(self.ops, ciphers, meta, self.res_dst)
        self.last_bootstraps = dict(replayed=0, eager={})
        if isinstance(bs, NativeBootstrapper):
            self._count_boots(self.last_bootstraps, "per_op", bs.calls - calls, 0)
        return outs, [meta[r] for r in self.res_dst]

    def decrypt_outputs(self):
        """The last request's results, decrypted: [results, slots], or [B,
        results, slots] after run_encrypted_batch."""
        outs, out_meta = self._last_outputs
        if outs and outs[0].dim() == 4:
            return np.stack([
                np.stack([self.s.decrypt(Ciphertext(data[b], sc))
                          for data, (nl, sc) in zip(outs, out_meta)])
                for b in range(outs[0].shape[0])])
        return np.stack([self.s.decrypt(Ciphertext(data, sc))
                         for data, (nl, sc) in zip(outs, out_meta)])
