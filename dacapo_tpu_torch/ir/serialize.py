"""Reference-compatible constant files (.cst).

The read/write half of dacapo_tpu/ir/serialize.py, in pure Python. Layout
(reference lib/Dialect/Earth/Transforms/ElideConstant.cpp:40-53 write side,
lib/Runtime/SEAL_HEVM.cpp:182-200 read side):
    int64 count, then per constant: int64 len, f64 data[len].
"""

import struct

import numpy as np


def write_cst(payloads, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<q", len(payloads)))
        for arr in payloads:
            a = np.asarray(arr, dtype="<f8").ravel()
            f.write(struct.pack("<q", a.size))
            f.write(a.tobytes())


def read_cst(path):
    out = []
    with open(path, "rb") as f:
        (count,) = struct.unpack("<q", f.read(8))
        for _ in range(count):
            (ln,) = struct.unpack("<q", f.read(8))
            out.append(np.frombuffer(f.read(8 * ln), dtype="<f8").copy())
    return out
