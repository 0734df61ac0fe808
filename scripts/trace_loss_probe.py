#!/usr/bin/env python3
"""How often a torch.profiler trace of one request drops NTT kernel records,
on the card: Multivariate (tpu_n14, pars/40, the basic list's row) at B=8 on
a resident HEVM and on one under a 64 MiB plan (plaintexts streamed, keys in
the key arena), each batch request profiled N times back to back, as
chip_smoke.py's profile_request does, then N times each after an empty
profiler session.

    python3 scripts/trace_loss_probe.py [N]      # default N = 20

Prints one line per VM and variant: traces whose forward or inverse NTT
passes were seen unequally often (nk.TraceLossError), and the NTT calls each
trace held. Needs a CUDA card; works in a temporary directory.
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import numpy as np
    import torch
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        print("trace_loss_probe: no CUDA device", file=sys.stderr)
        return 2
    from dacapo_tpu_torch import HEVM
    from dacapo_tpu_torch.crypto.cuda import ntt_kernel as nk
    from dacapo_tpu_torch.examples.tests import Multivariate as row
    from dacapo_tpu_torch.runtime.harness import compile_traced
    n_runs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    work = tempfile.mkdtemp(prefix="trace_probe_")
    inputs, _, _ = row.case(4096, seed=100)
    traced = os.path.join(work, "traced")
    row.trace(dirs=traced, nt=4096)
    hevm = compile_traced("Multivariate", "pars", 40, row.PROFILE, traced,
                          os.path.join(work, "optimized"))
    cst = os.path.join(traced, "_hecate_Multivariate.cst")
    keydir = os.path.join(work, "keys")
    vms = {}
    for name, plan in (("resident", None), ("64MiB plan", 64 << 20)):
        if plan:
            os.environ["DACAPO_TPU_HBM_BYTES"] = str(plan)
        try:
            vm = HEVM(row.PROFILE, keyset_dir=keydir)
            vm.load(cst, hevm)
        finally:
            os.environ.pop("DACAPO_TPU_HBM_BYTES", None)
        vm.precompile_batch(8)
        for i in range(len(inputs)):
            vm.setInputBatch(i, np.stack([row.case(4096, seed=100 + b)[0][i] for b in range(8)]))
        vms[name] = vm
    card = torch.cuda.get_device_name(0)

    def drain():
        """An empty profiler session: it takes the records a finished
        session's kernels deliver late, which would land in the next one."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    for name, vm in vms.items():
        args = [vm._arg_cts_batch[i] for i in range(len(inputs))]
        for variant in ("plain", "drained"):
            lossy, calls = 0, []
            for _ in range(n_runs):
                if variant == "drained":
                    drain()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    vm.executor.run_encrypted_batch(args)
                    torch.cuda.synchronize()
                try:
                    got = nk.launches_in_profile(prof.key_averages())
                    calls.append(got["ntt_fwd_cuda"] + got["ntt_inv_cuda"])
                except nk.TraceLossError:
                    lossy += 1
            print(f"[probe] {card}: {name}, {variant}: {lossy} of {n_runs} traces lost "
                  f"NTT pass records; NTT calls the others held: {sorted(calls)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
