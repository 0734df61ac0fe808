"""ctypes binding of the native artifact core (csrc/hevm_core.cpp).

Port of dacapo_tpu/vm/native.py. The C++ library owns the artifact layer:
.hevm/.cst binary IO, bytecode validation and register-reuse compaction,
where the reference keeps its native runtime (SEAL_HEVM.cpp loaders,
ReuseBuffer.cpp). vm/hevm.py and ir/serialize.py go through it wherever the
JAX package goes through its own.

The port builds its own copy of the source (csrc/hevm_core.cpp, the same
file as native/hevm_core.cpp) with g++ at first use into `build/` beside the
package, keyed by a hash of the source and the flags; several processes may
build at once, each into a temporary file moved into place. A failed build
raises: nothing falls back quietly. DACAPO_TPU_NO_NATIVE=1 selects the
pure-Python reader, writer and validator instead (and `reuse_compact` then
returns the program unchanged), as in the reference; the tests hold each
path against the other.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "hevm_core.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-fno-exceptions", "-fno-rtti", "-shared"]

# calls into the library, by entry point (chip_smoke.py checks them)
CALLS = {"hevm_load": 0, "hevm_save": 0, "hevm_validate": 0,
         "hevm_reuse_buffers": 0, "cst_load": 0, "cst_save": 0}
BUILD_INFO = {}          # seconds (build and load), library path, built here

_lib = None


def enabled():
    """False when DACAPO_TPU_NO_NATIVE selects the pure-Python paths."""
    return not os.environ.get("DACAPO_TPU_NO_NATIVE")


def build():
    """Compile (unless this source's library exists) and load the library;
    returns the handle. Raises if the compiler is missing or fails."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libhevm_core_{tag}.so"
    t0 = time.perf_counter()
    built = not out.exists()
    if built:
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found: the native artifact core cannot be built "
                               "(DACAPO_TPU_NO_NATIVE=1 selects the pure-Python path)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f64p = ctypes.POINTER(ctypes.c_double)
    vp = ctypes.c_void_p
    sigs = {
        "hevm_load": (vp, [ctypes.c_char_p]),
        "hevm_save": (ctypes.c_int, [vp, ctypes.c_char_p]),
        "hevm_create": (vp, [ctypes.c_uint64, ctypes.c_uint64, u64p, u64p, u64p, u64p,
                             u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                             ctypes.c_uint64, u16p]),
        "hevm_meta": (None, [vp, u64p]),
        "hevm_copy_arrays": (None, [vp] + [u64p] * 5),
        "hevm_copy_ops": (None, [vp, u16p]),
        "hevm_validate": (ctypes.c_int64, [vp]),
        "hevm_reuse_buffers": (ctypes.c_int64, [vp]),
        "hevm_free": (None, [vp]),
        "cst_load": (vp, [ctypes.c_char_p]),
        "cst_count": (ctypes.c_uint64, [vp]),
        "cst_len": (ctypes.c_uint64, [vp, ctypes.c_uint64]),
        "cst_copy": (None, [vp, ctypes.c_uint64, f64p]),
        "cst_save": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_uint64, u64p, f64p]),
        "cst_free": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(out), built=built)
    _lib = lib
    return lib


def get_lib():
    """The loaded library, built at first use; None when DACAPO_TPU_NO_NATIVE
    is set."""
    return build() if enabled() else None


def _call(lib, name, *args):
    CALLS[name] += 1
    return getattr(lib, name)(*args)


def _u64arr(vals):
    return np.ascontiguousarray(np.asarray(vals, dtype=np.uint64))


def _u64ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _handle_from_program(lib, prog):
    ops = np.zeros((max(len(prog.ops), 1), 4), dtype=np.uint16)
    for i, op in enumerate(prog.ops):
        ops[i] = (op.opcode & 0xFFFF, op.dst & 0xFFFF, op.lhs & 0xFFFF, op.rhs & 0xFFFF)
    arrs = [_u64arr(prog.arg_scale), _u64arr(prog.arg_level), _u64arr(prog.res_scale),
            _u64arr(prog.res_level), _u64arr(prog.res_dst)]
    return lib.hevm_create(
        len(prog.arg_scale), len(prog.res_scale), *[_u64ptr(a) for a in arrs],
        prog.init_level, prog.num_ctxt, prog.num_ptxt, len(prog.ops),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))


def _program_from_handle(lib, h, cls, op_cls):
    meta = np.zeros(6, dtype=np.uint64)
    lib.hevm_meta(h, _u64ptr(meta))
    argn, resn, nops, nct, npt, init_level = (int(x) for x in meta)
    arrs = [np.zeros(max(argn, 1), dtype=np.uint64) for _ in range(2)] + \
           [np.zeros(max(resn, 1), dtype=np.uint64) for _ in range(3)]
    lib.hevm_copy_arrays(h, *[_u64ptr(a) for a in arrs])
    ops = np.zeros((max(nops, 1), 4), dtype=np.uint16)
    lib.hevm_copy_ops(h, ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    p = cls()
    p.arg_scale = arrs[0][:argn].tolist()
    p.arg_level = arrs[1][:argn].tolist()
    p.res_scale = arrs[2][:resn].tolist()
    p.res_level = arrs[3][:resn].tolist()
    p.res_dst = arrs[4][:resn].tolist()
    p.init_level, p.num_ctxt, p.num_ptxt = init_level, nct, npt
    p.ops = [op_cls(int(o[0]), int(o[1]), int(o[2]), int(o[3])) for o in ops[:nops]]
    return p


def save_program(prog, path):
    """Native .hevm writer; False when the native core is disabled."""
    lib = get_lib()
    if lib is None:
        return False
    h = _handle_from_program(lib, prog)
    try:
        rc = _call(lib, "hevm_save", h, os.fsencode(path))
    finally:
        lib.hevm_free(h)
    if rc != 0:
        raise IOError(f"native hevm_save failed for {path}")
    return True


def load_program(path, cls, op_cls):
    """Native .hevm reader; None when the native core is disabled."""
    lib = get_lib()
    if lib is None:
        return None
    h = _call(lib, "hevm_load", os.fsencode(path))
    if not h:
        raise IOError(f"native hevm_load failed for {path}")
    try:
        return _program_from_handle(lib, h, cls, op_cls)
    finally:
        lib.hevm_free(h)


def validate_program(prog):
    """-1 if OK, else the index of the first invalid op (-2: bad result).
    None when the native core is disabled."""
    lib = get_lib()
    if lib is None:
        return None
    h = _handle_from_program(lib, prog)
    try:
        return int(_call(lib, "hevm_validate", h))
    finally:
        lib.hevm_free(h)


def reuse_buffers_program(prog, cls, op_cls):
    """Native register-reuse compaction: a new program; None when the
    native core is disabled."""
    lib = get_lib()
    if lib is None:
        return None
    h = _handle_from_program(lib, prog)
    try:
        if int(_call(lib, "hevm_reuse_buffers", h)) < 0:
            raise ValueError("program failed validation before reuse")
        return _program_from_handle(lib, h, cls, op_cls)
    finally:
        lib.hevm_free(h)


def read_cst_native(path):
    """Native .cst reader; None when the native core is disabled."""
    lib = get_lib()
    if lib is None:
        return None
    h = _call(lib, "cst_load", os.fsencode(path))
    if not h:
        raise IOError(f"native cst_load failed for {path}")
    out = []
    try:
        for i in range(int(lib.cst_count(h))):
            n = int(lib.cst_len(h, i))
            buf = np.zeros(max(n, 1), dtype=np.float64)
            lib.cst_copy(h, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            out.append(buf[:n])
    finally:
        lib.cst_free(h)
    return out


def write_cst_native(payloads, path):
    """Native .cst writer; False when the native core is disabled."""
    lib = get_lib()
    if lib is None:
        return False
    arrs = [np.ascontiguousarray(np.asarray(a, dtype=np.float64).ravel()) for a in payloads]
    lens = _u64arr([a.size for a in arrs])
    flat = np.concatenate(arrs) if arrs else np.zeros(1, dtype=np.float64)
    rc = _call(lib, "cst_save", os.fsencode(path), len(arrs), _u64ptr(lens),
               flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise IOError(f"native cst_save failed for {path}")
    return True
