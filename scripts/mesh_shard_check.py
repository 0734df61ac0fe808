#!/usr/bin/env python3
"""The mesh's row-subset arithmetic on one card, in one process and without
a collective (dacapo_tpu_torch/parallel/mesh.py:shard_check):

    python3 scripts/mesh_shard_check.py        # needs a CUDA card

At tpu_n15's top level (nl = 28), each rank's rows of a mul_ct key switch
and of a two-tap rot-mac group at mp = 2 and 4, assembled, must equal the
unsharded accumulators bit for bit; the NTT at every batch size the row
subsets launched must equal the plain NTT in both modes (the largest timed
against its bound); and the device key bytes one rank holds at each mp
(Multivariate's 12 tpu_n14 keys, ResNet-20's 202 tpu_n15 keys) are counted.
A check of the kernels and tables on row subsets, not of the collectives;
chip_smoke.py still holds the NTT at these batch sizes (MESH_SHARD_BATCHES).
Prints the card's name and power limit and one JSON line; exits non-zero on
a mismatch.
"""

import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch
    if not torch.cuda.is_available():
        print("mesh_shard_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dacapo_tpu_torch.crypto import ntt as ntt_mod, params
    from dacapo_tpu_torch.crypto.cuda import ntt_kernel as nk
    from dacapo_tpu_torch.crypto.scheme import Scheme
    from dacapo_tpu_torch.parallel.mesh import shard_check
    s = Scheme("tpu_n15", device="cuda")
    s.generate_keys(rot_steps=(1, 2))
    out = {}
    shapes = cs.NttShapes()
    shapes.start()
    try:
        for mp in (2, 4):
            t0 = time.perf_counter()
            r = out[f"mp{mp}"] = shard_check(s, mp)
            torch.cuda.synchronize()
            r["seconds"] = time.perf_counter() - t0
    finally:
        shapes.stop()
    del s
    gc.collect()
    torch.cuda.empty_cache()
    keys = {}
    for profile, n_keys in (("tpu_n14", 12), ("tpu_n15", 202)):
        cfg = params.PROFILES[profile]
        keys[profile] = {mp: max(len(range(r, cfg.num_all, mp)) for r in range(mp))
                         * cfg.dnum * 2 * cfg.n * 4 * n_keys for mp in (1, 2, 4)}
    out["key_bytes_a_rank"] = keys
    out["ntt"] = cs.batch_kernel_checks(torch, params, ntt_mod, nk, "tpu_n15",
                                        sorted(shapes.sizes), "mesh shards mp 2, 4")
    cs.log("[mesh] shard arithmetic at tpu_n15 nl=28: " + "; ".join(
        f"mp {mp}: {out[f'mp{mp}']['mismatches']} mismatched elements, key rows "
        f"{out[f'mp{mp}']['rows']}, {out[f'mp{mp}']['seconds']:.3f} s" for mp in (2, 4))
        + f"; key bytes a rank by mp: {keys}")
    cs.log(cs.card_line())
    cs.log(json.dumps(out, default=str))
    bad = [mp for mp in (2, 4) if out[f"mp{mp}"]["mismatches"]]
    if bad:
        print(f"the sharded accumulators differ from the unsharded at mp {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
