"""Test-session set-up that pytest loads before it collects tests/ (it
imports neither jax nor the two packages, so tests/conftest.py still sets
XLA_FLAGS before JAX loads):

* the JAX package's native core (native/libhevm_core.so, which
  dacapo_tpu/vm/native.py builds with `make` at first use) is built here,
  once, under a file lock. Every pytest-xdist worker imports every test
  module, and tests/test_native_core.py asks for the library while it is
  collected: six workers that each ran `make` on a missing library wrote it
  under one another, and a worker that loaded it half-written skipped that
  module's 6 tests and one of tests/test_torch_native_core.py for the whole
  run (5 of 24 processes, started six at a time from a clean native/, got no
  library);
* each xdist worker runs PyTorch's CPU kernels on its share of the cores
  (cores // workers, at least 1): with PyTorch's default of one thread per
  core in each of six workers, a test that takes 18 s alone took 260 s in
  the suite.
"""

import fcntl
import os
import subprocess

_ROOT = os.path.dirname(os.path.abspath(__file__))


def _build_native_core():
    native = os.path.join(_ROOT, "native")
    if not os.path.isfile(os.path.join(native, "Makefile")):
        return
    lock_dir = os.path.join(_ROOT, "dacapo_tpu_torch", "build")     # gitignored
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "native_core.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", native, "-s"], capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            pass        # no toolchain: the native tests say so and skip
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _share_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


_build_native_core()
_share_the_cores()
