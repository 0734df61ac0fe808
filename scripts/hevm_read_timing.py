#!/usr/bin/env python3
"""Read the committed ResNet-20 program (artifacts/resnet_dacapo40_tpu_n15/
ResNet.hevm, 31,852 ops) through the native artifact core
(dacapo_tpu_torch/vm/native.py, csrc/hevm_core.cpp, built with g++ at first
use) and through the pure-Python reader, three times each:

    python3 scripts/hevm_read_timing.py

Prints the core's build, the median seconds of each reader and whether the
two programs are equal op for op, as one JSON line; exits non-zero if they
differ. Runs on the host (no card needed).
"""

import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    from dacapo_tpu_torch.vm import native
    from dacapo_tpu_torch.vm.hevm import HEVMProgram
    native.build()
    path = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "resnet_dacapo40_tpu_n15",
                        "ResNet.hevm")
    times, progs = {}, {}
    for name, load in (("native", HEVMProgram.load), ("python", HEVMProgram._load_py)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            progs[name] = load(path)
            ts.append(time.perf_counter() - t0)
        times[name] = statistics.median(ts)
    a, b = progs["native"], progs["python"]
    equal = [(o.opcode, o.dst, o.lhs, o.rhs) for o in a.ops] == [
        (o.opcode, o.dst, o.lhs, o.rhs) for o in b.ops] and a.res_dst == b.res_dst
    print(json.dumps(dict(build=native.BUILD_INFO, resnet_ops=len(a.ops),
                          resnet_hevm_load_s=times, equal=equal), default=str))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
