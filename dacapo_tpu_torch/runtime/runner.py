"""User-facing HEVM runner (PyTorch): the reference python driver's UX.

Port of the `full` mode of dacapo_tpu/runtime/runner.py (reference
python/hecate/hecate/runner.py): `HEVM` with keyset autogeneration,
`load(cst, hevm)`, `setInput` (encrypt), `run`, `getOutput` (decrypt all
results) and the `printer` result block. Client and server modes are a later
slice of the port.
"""

import json
import os
import shutil
import struct
import time

import numpy as np
import torch

from ..crypto import keys as keymod
from ..crypto.params import to_dev, to_host
from ..crypto.scheme import Scheme
from ..ir.serialize import read_cst
from ..vm.executor import HEVMExecutor
from ..vm.hevm import HEVMProgram


class HEVM:
    """The VM driver, initFullVM mode (all keys; encrypt + run + decrypt).

    device: "cuda" (the default) or "cpu". Keysets live in
    ~/.hevm/torch/<profile> unless keyset_dir is given; the directory format
    is shared with the JAX package."""

    def __init__(self, profile="tpu_n15", keyset_dir=None, device=None):
        self.profile = profile
        self.scheme = Scheme(profile, device=device)
        self.device = self.scheme.device
        self.keyset_dir = keyset_dir or os.path.expanduser(
            f"~/.hevm/torch/{profile}")
        self._load_or_gen_keys()
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

    def load(self, cst_path, hevm_path):
        """Constants + bytecode -> executor + pre-encoded plaintexts. The
        seconds of each part are kept in `load_seconds`."""
        laps = [time.perf_counter()]

        def lap():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            laps.append(time.perf_counter())

        self.prog = HEVMProgram.load(hevm_path)
        constants = read_cst(cst_path)
        lap()
        # the executor generates the program's missing galois keys
        self.executor = HEVMExecutor(self.scheme, self.prog, constants)
        lap()
        self.executor.preprocess()
        lap()
        # persist newly generated galois keys (existing files are kept)
        keymod.save_keyset(self.scheme.keys, self.keyset_dir, skip_existing=True)
        lap()
        self.load_seconds = dict(zip(
            ("read", "galois_keygen", "preencode", "keyset_write"),
            np.diff(laps).tolist()))

    def setInput(self, i, data):
        """Encode+encrypt argument i at its compiled (level, scale)."""
        nl = (self.prog.arg_level[i] + 1) * self.scheme.ctx.config.rescale_rows
        scale = float(2.0 ** self.prog.arg_scale[i])
        ct = self.scheme.encrypt(np.asarray(data, dtype=np.float64), scale=scale, nl=nl)
        self._arg_cts[i] = (ct.data, nl, scale)

    def run(self):
        n_args = self.prog.arg_length
        self.executor.run_encrypted([self._arg_cts[i] for i in range(n_args)])
        self._out = self.executor.decrypt_outputs()
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
