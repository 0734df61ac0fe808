"""User-facing HEVM runner (PyTorch): the reference python driver's UX.

Port of the `full` mode of dacapo_tpu/runtime/runner.py (reference
python/hecate/hecate/runner.py): `HEVM` with keyset autogeneration,
`load(cst, hevm)`, `setInput` (encrypt), `run`, `getOutput` (decrypt all
results) and the `printer` result block. Client and server modes are a later
slice of the port.

On a profile made for native bootstrapping (`native_bootstrap=True`:
tpu_n15b, tpu_n16) `HEVM()` enables the native bootstrapper
(crypto/bootstrap_native.py) with the reference's radix rule, and every
bootstrap runs it; `DACAPO_TPU_BOOT=native` enables it on any sparse-secret
profile at `load`. On the card, `load` runs each of the program's native
bootstraps once over a zero input (`load_seconds["bootstrap_warmup"]`), so
their galois keys, conjugation key and plaintext diagonals are made at load
and not in the first request; these key draws then come before the first
`setInput`'s encryption. On the CPU they stay lazy, in the JAX package's
order.

A bootstrap on any other profile runs the oracle (crypto/bootstrap.py), by
default on its device path: on the card `load` captures one CUDA graph per
distinct bootstrap (`load_seconds["oracle_capture"]`), which the segment and
per-op paths both replay. `host_rng=True` draws the oracle's randomness from
the key generator's numpy RNG instead (the JAX package's
DACAPO_TPU_ORACLE_JIT=0 path), which the CPU tests hold bit for bit.

`jit` selects the executor's path (vm/executor.py): "auto" (the default) or
"segment" runs the segment plan, as CUDA graphs that `load` captures on the
card (`load_seconds["capture"]`) and eagerly on the CPU; True does the same
(the JAX package's whole-program function is not ported); False dispatches
per op.
Unlike the JAX runner, a failed capture raises: no path falls back to
per-op dispatch by itself.
"""

import json
import os
import shutil
import struct
import time

import numpy as np
import torch

from ..crypto import keys as keymod
from ..crypto.bootstrap_native import BootstrapConfig
from ..crypto.params import to_dev, to_host
from ..crypto.scheme import Scheme
from ..ir.serialize import read_cst
from ..vm.executor import HEVMExecutor
from ..vm.hevm import HEVMProgram


class HEVM:
    """The VM driver, initFullVM mode (all keys; encrypt + run + decrypt).

    device: "cuda" (the default) or "cpu". Keysets live in
    ~/.hevm/torch/<profile> unless keyset_dir is given; the directory format
    is shared with the JAX package. jit: "auto", "segment", True or False;
    host_rng: the oracle's randomness from the host (module docstring)."""

    def __init__(self, profile="tpu_n15", keyset_dir=None, device=None, jit="auto",
                 host_rng=False):
        if not (jit in ("auto", "segment") or isinstance(jit, bool)):
            raise ValueError(f"jit must be 'auto', 'segment', True or False, not {jit!r}")
        self.profile = profile
        self.jit = jit
        self.host_rng = host_rng
        self.scheme = Scheme(profile, device=device)
        self.device = self.scheme.device
        self.keyset_dir = keyset_dir or os.path.expanduser(
            f"~/.hevm/torch/{profile}")
        self._load_or_gen_keys()
        if self.scheme.ctx.config.native_bootstrap:
            self._native_bootstrapper()
        self.executor = None
        self.prog = None
        self._arg_cts = {}
        self._out = None

    def _load_or_gen_keys(self):
        d = self.keyset_dir
        fp_path = os.path.join(d, "params.json")
        # "orbit-v1": NTT planes stored in orbit order (params.orbit_perm);
        # the same fingerprint as the JAX package, so keysets interchange
        fingerprint = "orbit-v1:" + repr(sorted(self.scheme.ctx.primes))
        have = os.path.exists(os.path.join(d, "s_ntt.npy"))
        if have:
            # stale keysets (profile parameters changed) must not be reused
            try:
                with open(fp_path) as f:
                    have = json.load(f)["primes"] == fingerprint
            except (OSError, ValueError, KeyError):
                have = False
        if have:
            self.scheme.keys = keymod.load_keyset(d, self.device)
            return
        if os.path.isdir(d):
            shutil.rmtree(d)   # stale keyset: incremental saves must not mix
        self.scheme.generate_keys()
        keymod.save_keyset(self.scheme.keys, d)
        with open(fp_path, "w") as f:
            json.dump({"primes": fingerprint}, f)

    def _native_bootstrapper(self):
        """The scheme's native bootstrapper, built once: more slots take a
        bigger butterfly radix (fewer CtS/StC levels, more rotations per
        level), the reference's rule (runtime/runner.py:75-82)."""
        s = self.scheme
        if s._native_bs is None:
            cfg = s.ctx.config
            if cfg.secret_h <= 0:
                raise ValueError(
                    f"profile {self.profile!r} has a dense secret: native "
                    "bootstrapping needs a sparse one (secret_h > 0)")
            radix = 7 if cfg.n_slots >= (1 << 14) else 5
            s.enable_native_bootstrap(BootstrapConfig(radix=radix))
        return s._native_bs

    def load(self, cst_path, hevm_path):
        """Constants + bytecode -> executor + pre-encoded plaintexts, and on
        the card the native bootstraps' warm-up, the oracle graphs and the
        segment graphs. The seconds of each part are kept in
        `load_seconds`."""
        laps = [time.perf_counter()]

        def lap():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            laps.append(time.perf_counter())

        self.prog = HEVMProgram.load(hevm_path)
        constants = read_cst(cst_path)
        if os.environ.get("DACAPO_TPU_BOOT", "") == "native":
            # the native bootstrap instead of the oracle (reference
            # HEAAN_HEVM.cpp:386-399 vs SEAL_HEVM.cpp:324-334); one that
            # __init__ built is kept
            self._native_bootstrapper()
        lap()
        # the executor generates the program's missing galois keys
        self.executor = HEVMExecutor(self.scheme, self.prog, constants,
                                     host_rng=self.host_rng)
        lap()
        self.executor.preprocess()
        lap()
        parts = ["read", "galois_keygen", "preencode"]
        if self.device.type == "cuda" and self.executor.warm_bootstraps():
            lap()
            parts.append("bootstrap_warmup")
        if self.device.type == "cuda" and self.executor.capture_oracle():
            lap()
            parts.append("oracle_capture")
        # persist newly generated keys (existing files are kept)
        keymod.save_keyset(self.scheme.keys, self.keyset_dir, skip_existing=True)
        lap()
        parts.append("keyset_write")
        if self.device.type == "cuda" and self.jit is not False:
            self.executor.precompile_segments()
            lap()
            parts.append("capture")
        self.load_seconds = dict(zip(parts, np.diff(laps).tolist()))

    def setInput(self, i, data):
        """Encode+encrypt argument i at its compiled (level, scale)."""
        nl = (self.prog.arg_level[i] + 1) * self.scheme.ctx.config.rescale_rows
        scale = float(2.0 ** self.prog.arg_scale[i])
        ct = self.scheme.encrypt(np.asarray(data, dtype=np.float64), scale=scale, nl=nl)
        self._arg_cts[i] = (ct.data, nl, scale)

    def run(self):
        n_args = self.prog.arg_length
        keys = self.scheme.keys
        n_keys = (len(keys.galois), keys.conj is not None)
        self.executor.run_encrypted([self._arg_cts[i] for i in range(n_args)],
                                    jit=self.jit)
        self._out = self.executor.decrypt_outputs()
        if (len(keys.galois), keys.conj is not None) != n_keys:
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
        print(f"Profile: {self.profile} (torch-HEVM {self.device.type}, full)")
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
