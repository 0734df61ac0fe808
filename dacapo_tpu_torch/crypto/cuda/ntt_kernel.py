"""ctypes binding of the hand-written CUDA NTT kernel (csrc/ntt.cu).

Replaces dacapo_tpu/crypto/pallas/ntt_kernel.py (`ntt_pallas` and its
`PallasNTT` dispatcher). The kernel is compiled with nvcc for sm_90a into
`build/` beside the package at first use (keyed by a hash of the source) and
loaded with ctypes; its C function returns cudaGetLastError() of the launch.

`ntt_cuda` takes CUDA tensors only and raises on anything else: the plain
version for CPU tensors is crypto/ntt.py, chosen by Evaluator._ntt.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MIN_LOGN, MAX_LOGN = 8, 16

# launches of each mode: one per call that launched the kernel (its two
# passes), counted where it launches and nowhere else. A call under CUDA
# graph capture records the kernel into the graph and launches nothing, so
# it is not counted; a replay runs the graph's kernels without this wrapper
# (they are counted on the device, by the profiler)
LAUNCHES = {"ntt_fwd_cuda": 0, "ntt_inv_cuda": 0}
# calls recorded into a CUDA graph under capture (no launch): the executor
# keeps each graph's share, so a replay's NTT calls are known without a trace
RECORDED = {"ntt_fwd_cuda": 0, "ntt_inv_cuda": 0}
BUILD_INFO = {}          # seconds, nvcc output of the build in this process

_lib = None


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA NTT kernel cannot be built")
    return path


def build():
    """Compile (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    out = BUILD_DIR / f"libdacapo_ntt_{hashlib.sha256(src).hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        BUILD_INFO["nvcc_output"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["library"] = str(out)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dacapo_ntt.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.dacapo_ntt.restype = ci
    lib.dacapo_cuda_error_string.argtypes = [ci]
    lib.dacapo_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_logn(n: int) -> int:
    logn = n.bit_length() - 1
    if n != 1 << logn or not MIN_LOGN <= logn <= MAX_LOGN:
        raise ValueError(f"CUDA NTT takes N = 2^{MIN_LOGN}..2^{MAX_LOGN}, got {n}")
    return logn


def _check(t, name, dtype, shape=None):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"ntt_cuda: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"ntt_cuda: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"ntt_cuda: {name} must be contiguous and 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"ntt_cuda: {name} has shape {tuple(t.shape)}, want {shape}")


def ntt_cuda(x, rows, tables, inverse=False):
    """Forward (or inverse) NTT of int32 [B, N] planes on the card.

    rows: int32 [B] CUDA tensor, the prime row of each plane. tables: the
    context's device tables (CKKSContext.dev): `q`, `ninv`, `ninv_shoup`
    [P] and `tw`/`tw_shoup` (forward) or `itw`/`itw_shoup` (inverse) [P, N].
    Returns a new int32 [B, N] tensor, launched on the current stream as
    the kernel's two passes (one count per call, none under capture)."""
    if x.dim() != 2:
        raise ValueError(f"ntt_cuda: x must be [B, N], got {tuple(x.shape)}")
    b, n = x.shape
    logn = _check_logn(n)
    key = "itw" if inverse else "tw"
    tw, tws = tables[key], tables[key + "_shoup"]
    p = tw.shape[0]
    _check(x, "x", torch.int32)
    _check(rows, "rows", torch.int32, (b,))
    _check(tw, key, torch.int32, (p, n))
    _check(tws, key + "_shoup", torch.int32, (p, n))
    for k in ("q", "ninv", "ninv_shoup"):
        _check(tables[k], k, torch.int32, (p,))
    for t in (rows, tw, tws, tables["q"]):
        if t.device != x.device:
            raise ValueError("ntt_cuda: all tensors must be on one device")
    y = torch.empty_like(x)
    if b == 0:
        return y
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        rc = lib.dacapo_ntt(
            x.data_ptr(), y.data_ptr(), rows.data_ptr(), b, logn, int(inverse),
            tw.data_ptr(), tws.data_ptr(), tables["q"].data_ptr(),
            tables["ninv"].data_ptr(), tables["ninv_shoup"].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"CUDA NTT launch failed: {lib.dacapo_cuda_error_string(rc).decode()}")
    (RECORDED if capturing else LAUNCHES)["ntt_inv_cuda" if inverse else "ntt_fwd_cuda"] += 1
    return y


class TraceLossError(RuntimeError):
    """A profiler trace that lost kernel records: a mode's two NTT passes
    were not seen the same number of times."""


_PASS_NAME = re.compile(r"ntt_pass<\s*\d+\s*,\s*(\w+)\s*,\s*(\w+)\s*>")


def passes_in_profile(events):
    """{mode name: (pass-A kernels, pass-B kernels)} that a torch.profiler
    trace saw run on the device, graph replays included: `events` are the
    trace's key_averages() rows. Reads a trace and adds nothing to
    LAUNCHES."""
    passes = {}
    for e in events:
        m = _PASS_NAME.search(e.key)
        if m and str(e.device_type).endswith("CUDA"):
            key = (m.group(2) in ("true", "1"), m.group(1) in ("true", "1"))
            passes[key] = passes.get(key, 0) + e.count
    return {name: (passes.get((inverse, False), 0), passes.get((inverse, True), 0))
            for name, inverse in (("ntt_fwd_cuda", False), ("ntt_inv_cuda", True))}


def launches_in_profile(events):
    """NTT calls of each mode that a torch.profiler trace saw run on the
    device (passes_in_profile). Each call runs one `ntt_pass<LOGN, PASS_B,
    INVERSE>` kernel of each pass, so a mode's calls are its pass-A
    kernels; unequal pass counts (a trace that lost records) raise
    TraceLossError."""
    out = {}
    for name, (a, b) in passes_in_profile(events).items():
        if a != b:
            raise TraceLossError(f"{name}: the trace holds {a} pass-A and {b} pass-B kernels")
        out[name] = a
    return out
