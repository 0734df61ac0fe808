"""User-facing HEVM runner (PyTorch): the reference python driver's UX.

Port of dacapo_tpu/runtime/runner.py (reference python/hecate/hecate/
runner.py): `setLibnHW`/`current_profile` select the profile, `HEVM` keeps a
keyset directory (generated when absent), `load(cst, hevm)`, `setInput`
(encrypt), `run`, `getOutput` (decrypt all results) and the `printer` result
block, in three modes (the reference's initFullVM/initClientVM/initServerVM):

* "full": every key; encrypt, run and decrypt in one process.
* "client": secret and public key only. `loadClient` reads the program's
  header, `setInput` encrypts, `getCtxt` ships an argument, and
  `decrypt_result` decrypts a shipped result. It evaluates nothing and
  builds no bootstrapper.
* "server": public and evaluation keys only, no secret key: a pregenerated
  keyset is required (a full HEVM's load makes and persists the program's
  galois keys; its make_keys makes them without loading the program). `setCtxt` receives the arguments, `run` evaluates and
  returns None, `getOutputCtxt` ships each result. `load` refuses, before
  any key generation or capture, a program it cannot serve without the
  secret: one that bootstraps with the oracle (it decrypts), or one whose
  rotation keys, or whose native bootstrap's rotation and conjugation keys,
  the keyset lacks.

Ciphertexts travel as `serialize_ct` bytes, the JAX package's format, so
either package's client can talk to either package's server.

On a profile made for native bootstrapping (`native_bootstrap=True`:
tpu_n15b, tpu_n16) a full `HEVM()` enables the native bootstrapper
(crypto/bootstrap_native.py) with the reference's radix rule, and a server
enables it at `load` for a program that bootstraps; `DACAPO_TPU_BOOT=native`
enables it on any sparse-secret profile at `load`. On the card, `load` runs
each of the program's native bootstraps once over a zero input
(`load_seconds["bootstrap_warmup"]`), so their galois keys, conjugation key
and plaintext diagonals are made at load and not in the first request;
these key draws then come before the first `setInput`'s encryption. On the
CPU they stay lazy, in the JAX package's order.

A bootstrap on any other profile runs the oracle (crypto/bootstrap.py), by
default on its device path: on the card `load` captures one CUDA graph per
distinct bootstrap (`load_seconds["oracle_capture"]`), which the segment and
per-op paths both replay. `host_rng=True` draws the oracle's randomness from
the key generator's numpy RNG instead (the JAX package's
DACAPO_TPU_ORACLE_JIT=0 path), which the CPU tests hold bit for bit.

Device memory (vm/executor.py, the JAX package's plan): galois keys past
55 % and plaintexts past 12 % of the device memory stream. The memory is
DACAPO_TPU_HBM_BYTES when set, else the card's total (on the CPU: 16 GiB
for N >= 2^15). `DACAPO_TPU_HBM_BYTES=17179869184` picks the JAX package's
16 GiB plan, under which ResNet-20's plaintexts stream from the compact
device pool; `executor.streaming` says which mode `load` chose, and its
part of `load_seconds` is "compact_encode" instead of "preencode". Keys
past their budget stay in pinned host memory (`load_seconds["key_pin"]`),
and the segment path reads them from a slot arena on the device that each
window's keys are copied into before it runs
(`load_seconds["key_arena"]`: made and filled for the first request).

`jit` selects the executor's path (vm/executor.py): "auto" (the default) or
"segment" runs the segment plan, as CUDA graphs that `load` captures on the
card (`load_seconds["capture"]`) and eagerly on the CPU; True does the same
(the JAX package's whole-program function is not ported); False dispatches
per op, as does every request after `setDebug(True)`.
Unlike the JAX runner, a failed capture raises: no path falls back to
per-op dispatch by itself.

Batches (the reference's setInputBatch/runBatch): `setInputBatch(i, data
[B, slots])` encrypts B rows of argument i, `runBatch()` runs them through
the executor's batch path (vm/executor.py:run_encrypted_batch) and returns
[B, results, slots] in full mode, None in server mode. On the card
`precompile_batch(B)` after `load` captures the batch graphs (the oracle's
and the segments') before the first batch
(`load_seconds["batch_oracle_capture"]`, `["batch_capture"]`).
`runBatch(mesh=...)` and `precompile_batch(B, mesh=...)` run the batch
over a parallel.mesh.Mesh: every rank of it runs the same calls, holds its
rows of the keys and its block of the batch, and gets the whole result
(vm/executor.py). Keys a native bootstrap makes after the keys were split
are not written to the keyset directory, which holds full keys only.
"""

import json
import os
import shutil
import struct
import time

import numpy as np
import torch

from ..crypto import keys as keymod
from ..crypto.bootstrap_native import BootstrapConfig, sized_for_secret
from ..crypto.params import PROFILES, to_dev, to_host
from ..crypto.scheme import Ciphertext, Scheme
from ..ir.serialize import read_cst
from ..vm.executor import HEVMExecutor
from ..vm.hevm import HEVMProgram, OP_BOOTSTRAP

MODES = ("full", "client", "server")

_selected_profile = os.environ.get("DACAPO_TPU_PROFILE", "tpu_n15")


def setLibnHW(argv):
    """argv-compatible profile selection (reference runner.py:123-171): the
    first profile name among argv[1:], else the reference's trailing
    `<lib> <hw>` pair ("SEAL ..." -> tpu_n15, "HEAAN ..." -> tpu_n16).
    Returns the selected profile, which HEVM(profile=None) takes."""
    global _selected_profile
    cand = [a for a in argv[1:] if isinstance(a, str)]
    for a in cand:
        if a in PROFILES:
            _selected_profile = a
            return _selected_profile
    joined = " ".join(cand).upper()
    if "HEAAN" in joined:
        _selected_profile = "tpu_n16"
    elif "SEAL" in joined:
        _selected_profile = "tpu_n15"
    return _selected_profile


def current_profile():
    return _selected_profile


def keyset_fingerprint(scheme):
    """The keyset's params.json "primes" entry: "orbit-v1" says NTT planes
    are stored in orbit order (params.orbit_perm); the JAX package's runner
    writes and checks the same string, so keysets interchange."""
    return "orbit-v1:" + repr(sorted(scheme.ctx.primes))


class HEVM:
    """The VM driver in one of three modes (module docstring).

    profile: a crypto profile name, by default the selected one
    (setLibnHW, DACAPO_TPU_PROFILE). device: "cuda" (the default) or "cpu".
    Keysets live in ~/.hevm/torch/<profile> unless keyset_dir is given; the
    directory format is shared with the JAX package. jit: "auto",
    "segment", True or False; host_rng: the oracle's randomness from the
    host (module docstring)."""

    def __init__(self, profile=None, keyset_dir=None, device=None, jit="auto",
                 host_rng=False, mode="full"):
        if not (jit in ("auto", "segment") or isinstance(jit, bool)):
            raise ValueError(f"jit must be 'auto', 'segment', True or False, not {jit!r}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
        self.profile = profile or _selected_profile
        self.mode = mode
        self.jit = jit
        self.host_rng = host_rng
        self.scheme = Scheme(self.profile, device=device)
        self.device = self.scheme.device
        self.keyset_dir = keyset_dir or os.path.expanduser(
            f"~/.hevm/torch/{self.profile}")
        self._load_or_gen_keys()
        if self.scheme.ctx.config.native_bootstrap and mode == "full":
            self._native_bootstrapper()
        self.executor = None
        self.prog = None
        self._arg_cts = {}
        self._arg_cts_batch = {}
        self._out = None
        self._debug = False

    def _load_or_gen_keys(self):
        d = self.keyset_dir
        fp_path = os.path.join(d, "params.json")
        fingerprint = keyset_fingerprint(self.scheme)
        have = os.path.exists(os.path.join(d, "s_ntt.npy")) or (
            self.mode == "server" and os.path.exists(os.path.join(d, "rlk.npy")))
        if have:
            # stale keysets (profile parameters changed) must not be reused
            try:
                with open(fp_path) as f:
                    have = json.load(f)["primes"] == fingerprint
            except (OSError, ValueError, KeyError):
                have = False
        if have:
            self.scheme.keys = keymod.load_keyset(d, self.device, mode=self.mode)
            return
        if self.mode == "server":
            raise RuntimeError(
                f"server VM needs a pregenerated keyset at {d} for profile "
                f"{self.profile!r} (a full HEVM, or `python -m dacapo_tpu_torch.cli "
                "keygen`, makes one)")
        if os.path.isdir(d):
            shutil.rmtree(d)   # stale keyset: incremental saves must not mix
        self.scheme.generate_keys()
        keymod.save_keyset(self.scheme.keys, d)
        with open(fp_path, "w") as f:
            json.dump({"primes": fingerprint}, f)

    def _native_bootstrapper(self):
        """The scheme's native bootstrapper, built once: more slots take a
        bigger butterfly radix (fewer CtS/StC levels, more rotations per
        level), the reference's rule (runtime/runner.py:75-82); a sparse
        secret of Hamming weight past 101 (at N = 2^15) takes a wider
        ModRaise bound K and degree 40 (bootstrap_native.sized_for_secret:
        K = 24 at h = 192, where the reference keeps K = 16)."""
        s = self.scheme
        if s._native_bs is None:
            cfg = s.ctx.config
            if cfg.secret_h <= 0:
                raise ValueError(
                    f"profile {self.profile!r} has a dense secret: native "
                    "bootstrapping needs a sparse one (secret_h > 0)")
            if self.mode == "server" and s.keys.conj is None:
                raise RuntimeError(
                    f"server VM: the keyset at {self.keyset_dir} lacks the conjugation "
                    "key the native bootstrap needs, and a server makes no keys: load "
                    "the program on a full HEVM first")
            radix = 7 if cfg.n_slots >= (1 << 14) else 5
            s.enable_native_bootstrap(sized_for_secret(BootstrapConfig(radix=radix),
                                                       cfg.secret_h, cfg.n))
        return s._native_bs

    def _check_server_keys(self):
        """A server holds no secret key: refuse a program that would need it
        (an oracle bootstrap decrypts; a missing key would be generated),
        before the executor exists."""
        boots = any(op.opcode == OP_BOOTSTRAP for op in self.prog.ops)
        s = self.scheme
        if boots and (s.ctx.config.native_bootstrap
                      or os.environ.get("DACAPO_TPU_BOOT", "") == "native"):
            self._native_bootstrapper()
        if boots and s._native_bs is None:
            raise RuntimeError(
                "server VM: the program bootstraps with the oracle, which decrypts "
                "with the secret key a server does not hold; serve it on a native-"
                "bootstrap profile (or DACAPO_TPU_BOOT=native), or in full mode")
        half = s.ctx.n // 2
        need = {o % half for o in self.prog.rotation_offsets() if o % half}
        if boots:
            need.update(st % half for st in s._native_bs.rotation_steps())
        missing = sorted(st for st in need if st not in s.keys.galois)
        if missing:
            raise RuntimeError(
                f"server VM: the keyset at {self.keyset_dir} lacks the galois keys of "
                f"rotation steps {missing[:8]}{' ...' if len(missing) > 8 else ''} "
                f"({len(missing)} of {len(need)}), and a server makes no keys: load the "
                "program on a full HEVM first")

    def setDebug(self, flag=True):
        """Per-op level and scale trace on stderr (the executor's setDebug);
        requests then take the per-op path."""
        self._debug = bool(flag)
        if self.executor is not None:
            self.executor.setDebug(flag)

    def load(self, cst_path, hevm_path):
        """Full and server modes: constants + bytecode -> executor +
        pre-encoded plaintexts, and on the card the native bootstraps'
        warm-up, the oracle graphs and the segment graphs. The seconds of
        each part are kept in `load_seconds`."""
        if self.mode == "client":
            raise RuntimeError("a client VM evaluates nothing: use loadClient")
        laps = [time.perf_counter()]

        def lap():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            laps.append(time.perf_counter())

        self.prog = HEVMProgram.load(hevm_path)
        constants = read_cst(cst_path)
        if self.mode == "server":
            self._check_server_keys()
        elif os.environ.get("DACAPO_TPU_BOOT", "") == "native":
            # the native bootstrap instead of the oracle (reference
            # HEAAN_HEVM.cpp:386-399 vs SEAL_HEVM.cpp:324-334); one that
            # __init__ built is kept
            self._native_bootstrapper()
        lap()
        # the executor generates the program's missing galois keys (a full VM)
        self.executor = HEVMExecutor(self.scheme, self.prog, constants,
                                     host_rng=self.host_rng)
        self.executor.setDebug(self._debug)
        lap()
        parts = ["read", "galois_keygen"]
        galois = self.scheme.keys.galois
        if galois.budget is not None:
            # keys past the budget: their host copies into pinned slabs
            galois.pin_host()
            lap()
            parts.append("key_pin")
        self.executor.preprocess()
        lap()
        # a streaming executor's plaintexts are the compact pool's encode
        parts.append("compact_encode" if self.executor.streaming else "preencode")
        if self.device.type == "cuda" and self.executor.warm_bootstraps():
            lap()
            parts.append("bootstrap_warmup")
        if self.device.type == "cuda" and self.executor.capture_oracle():
            lap()
            parts.append("oracle_capture")
        if self.mode == "full":
            # persist newly generated keys (existing files are kept)
            keymod.save_keyset(self.scheme.keys, self.keyset_dir, skip_existing=True)
            lap()
            parts.append("keyset_write")
        if galois.budget is not None and self.jit is not False:
            # the graph windows' key slots, filled for the first request
            self.executor.key_arena()
            lap()
            parts.append("key_arena")
        if self.device.type == "cuda" and self.jit is not False:
            self.executor.precompile_segments()
            lap()
            parts.append("capture")
        self.load_seconds = dict(zip(parts, np.diff(laps).tolist()))

    def make_keys(self, hevm_path):
        """Full mode: make the galois keys a program needs without loading
        it (no constants, no plaintexts, no graphs): its rotation offsets,
        in the order the executor asks for them, then, when it bootstraps
        natively, the bootstrap's rotation steps (the conjugation key is
        made with the bootstrapper). Nothing is written: a server of the
        program needs the keyset's server half after this
        (save_keyset(parts=("public", "eval"))). Returns the number of
        galois keys made."""
        if self.mode != "full":
            raise RuntimeError(f"only a full VM makes keys; this VM is {self.mode!r}")
        prog = HEVMProgram.load(hevm_path)
        s = self.scheme
        before = len(s.keys.galois)
        s.ensure_galois([o for o in prog.rotation_offsets() if o != 0])
        if any(op.opcode == OP_BOOTSTRAP for op in prog.ops) and (
                s.ctx.config.native_bootstrap
                or os.environ.get("DACAPO_TPU_BOOT", "") == "native"):
            s.ensure_galois(self._native_bootstrapper().rotation_steps())
        return len(s.keys.galois) - before

    def precompile_batch(self, batch, mesh=None):
        """Capture, on the card, the graphs of the batch path for `batch`
        ciphertexts: the device oracle's, one per bootstrap cache key, and
        one per segment window; load_seconds["batch_oracle_capture"] and
        ["batch_capture"] get their seconds. A later batch of another size
        captures its own at first use. mesh: the batch's mesh (runBatch);
        the oracle's graphs then take all `batch` rows and the segments'
        this rank's block of them. Returns the number of segment graphs (0
        on the CPU, which runs the batch eagerly, and with jit=False)."""
        if self.executor is None:
            raise RuntimeError("load a program first")
        if self.device.type != "cuda" or self.jit is False:
            return 0
        rows = batch
        if mesh is not None:
            from ..parallel.mesh import batch_rows
            self.executor.use_mesh(mesh)
            block = batch_rows(mesh, batch)
            rows = block.stop - block.start
        t0 = time.perf_counter()
        if self.executor.capture_oracle(batch):
            torch.cuda.synchronize(self.device)
            self.load_seconds["batch_oracle_capture"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graphs = self.executor.precompile_segments(batch=rows)
        torch.cuda.synchronize(self.device)
        self.load_seconds["batch_capture"] = time.perf_counter() - t0
        return graphs

    def loadClient(self, hevm_path):
        """Client mode: the program's header only (each argument's level and
        scale, the result registers); no constants, no executor (reference
        loadClient, SEAL_HEVM.cpp:431-436)."""
        if self.mode != "client":
            raise RuntimeError(f"loadClient is the client's loader; this VM is {self.mode!r}")
        self.prog = HEVMProgram.load(hevm_path)

    # --------------------------------------------------------------- client
    def setInput(self, i, data):
        """Encode+encrypt argument i at its compiled (level, scale)."""
        nl = (self.prog.arg_level[i] + 1) * self.scheme.ctx.config.rescale_rows
        scale = float(2.0 ** self.prog.arg_scale[i])
        ct = self.scheme.encrypt(np.asarray(data, dtype=np.float64), scale=scale, nl=nl)
        self._arg_cts[i] = (ct.data, nl, scale)

    def setInputBatch(self, i, data):
        """Encrypt a batch for argument i: data [B, slots], row by row in
        the reference's order (the same draws as B setInput calls)."""
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim != 2:
            raise ValueError(f"setInputBatch takes [B, slots], got shape {arr.shape}")
        nl = (self.prog.arg_level[i] + 1) * self.scheme.ctx.config.rescale_rows
        scale = float(2.0 ** self.prog.arg_scale[i])
        cts = [self.scheme.encrypt(row, scale=scale, nl=nl).data for row in arr]
        self._arg_cts_batch[i] = (torch.stack(cts), nl, scale)

    def getCtxt(self, i):
        """Serialized argument i (set by setInput or setCtxt), else result i
        of the last run, for transport (reference getCtxt,
        SEAL_HEVM.cpp:463-473)."""
        if i in self._arg_cts:
            data, nl, scale = self._arg_cts[i]
        else:
            outs, meta = self.executor._last_outputs
            data, (nl, scale) = outs[i], meta[i]
        return serialize_ct(data, nl, scale)

    def setCtxt(self, i, blob):
        """Receive a transported ciphertext as argument i."""
        self._arg_cts[i] = deserialize_ct(blob, self.device)

    def getResIdx(self, i):
        """The register that holds result i."""
        return self.prog.res_dst[i]

    def decrypt_result(self, blob):
        """Decrypt a transported result ciphertext (client or full mode)."""
        if self.scheme.keys.s_ntt is None:
            raise RuntimeError("this VM holds no secret key: only a client or a full VM "
                               "decrypts")
        data, _, scale = deserialize_ct(blob, self.device)
        return self.scheme.decrypt(Ciphertext(data, scale))

    # --------------------------------------------------------------- server
    def run(self):
        """Evaluate the program over the encrypted arguments. A full VM
        decrypts the results (getOutput); a server returns None and ships
        them with getOutputCtxt."""
        return self._evaluate(self._arg_cts, "neither set (setInput) nor received (setCtxt)",
                              lambda args: self.executor.run_encrypted(args, jit=self.jit))

    def runBatch(self, mesh=None):
        """Evaluate the program over the batches setInputBatch encrypted. A
        full VM returns the decrypted [B, results, slots]; a server returns
        None. mesh: a parallel.mesh.Mesh that every rank calls this over
        (module docstring)."""
        return self._evaluate(self._arg_cts_batch, "not set (setInputBatch)",
                              lambda args: self.executor.run_encrypted_batch(args, mesh=mesh))

    def _evaluate(self, arg_cts, unset, execute):
        if self.mode == "client":
            raise RuntimeError("a client VM evaluates nothing")
        n_args = self.prog.arg_length
        missing = [i for i in range(n_args) if i not in arg_cts]
        if missing:
            raise RuntimeError(f"arguments {missing} were {unset}")
        keys = self.scheme.keys
        n_keys = (len(keys.galois), keys.conj is not None)
        execute([arg_cts[i] for i in range(n_args)])
        if self.mode != "full":
            self._out = None
            return None
        self._out = self.executor.decrypt_outputs()
        keys = self.scheme.keys          # a mesh's first batch replaces them
        if (len(keys.galois), keys.conj is not None) != n_keys and keys.shard is None:
            # keys the native bootstrap made during the run (the CPU makes
            # them lazily) persist for later runs
            keymod.save_keyset(keys, self.keyset_dir, skip_existing=True)
        return self._out

    def getOutput(self):
        return self._out

    def getOutputCtxt(self, i):
        """Serialized i-th result ciphertext (server -> client transport)."""
        outs, meta = self.executor._last_outputs
        data, (nl, scale) = outs[i], meta[i]
        return serialize_ct(data, nl, scale)

    def printer(self, latency, rms):
        print("=======================================")
        print(f"Profile: {self.profile} (torch-HEVM {self.device.type}, {self.mode})")
        print(f"Latency: {latency}")
        print(f"RMS: {rms}")
        print("=======================================")


# ------------------------------------------------------- ciphertext transport
def serialize_ct(data, nl, scale):
    """uint32 [2, nl, N] (tensor or array) + metadata -> bytes; the same
    format as the JAX package's serialize_ct."""
    arr = to_host(data) if isinstance(data, torch.Tensor) else np.asarray(data)
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    header = struct.pack("<IId", arr.shape[1], arr.shape[2], float(scale))
    return header + arr.tobytes()


def deserialize_ct(blob, device):
    """bytes -> (int32 [2, nl, N] tensor on `device`, nl, scale)."""
    nl, n, scale = struct.unpack_from("<IId", blob, 0)
    off = struct.calcsize("<IId")
    arr = np.frombuffer(blob, dtype=np.uint32, offset=off).reshape(2, nl, n)
    return to_dev(arr, device), int(nl), float(scale)
