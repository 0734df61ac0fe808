"""Exact-float simulator of `.hevm` programs (copy of dacapo_tpu/vm/simulate.py).

Interprets the bytecode over RAW message vectors (message * scale, float64)
with the SAME scale bookkeeping the real VM uses (executor._meta_step /
SEAL_HEVM.cpp:268-334 forced-scale semantics), but no rings, no noise, no
device. Two uses:

* **Artifact verification**: run the compiled program on a test input and
  compare against the golden model — separates compiler/scale-management
  bugs (visible here) from crypto-kernel precision (only visible on device).
  A planner whose add operands disagree in scale shows up as a large
  simulated error; crypto noise does not exist here.
* **Scale audit**: `audit=True` records every ADDCC/ADDCP whose operand
  scales disagree by more than `tol` — the silent mis-scaling class the
  round-4 bootstrap-cooling bug belonged to (ADVICE r4 #2).

Raw-space semantics (c = m * scale): add raw, mul raw (scale multiplies),
rescale divides raw & scale by the dropped primes, upscale multiplies by
2^bits, bootstrap is scale- and raw-preserving (the runtime contract both
bootstrappers implement), encode loads constant * 2^scale_bits.
"""

from dataclasses import dataclass, field

import numpy as np

from .hevm import (
    HEVMProgram, OP_ENCODE, OP_ROTATE, OP_NEGATE, OP_RESCALE, OP_MODSWITCH,
    OP_UPSCALE, OP_ADDCC, OP_ADDCP, OP_MULCC, OP_MULCP, OP_BOOTSTRAP,
    OP_ALLOC,
)


def profile_primes(profile: str):
    """The q-prime chain of a crypto profile WITHOUT building the full
    context (no twiddle tables): replicates CKKSContext.__init__'s chain
    selection (crypto/params.py:201-219)."""
    from ..crypto.params import PROFILES
    from ..crypto.primes import gen_balanced_pairs, gen_ntt_primes

    config = PROFILES[profile]
    if config.rescale_rows == 2:
        q = gen_balanced_pairs(config.n, config.num_q // 2, config.prime_bits)
    else:
        chain = gen_ntt_primes(config.n, config.num_all, config.prime_bits)
        q = chain[config.alpha:]
    return q, config.rescale_rows, config.n // 2


@dataclass
class SimResult:
    outputs: list                    # [(vec float64 [nt], scale)]
    scale_mismatches: list = field(default_factory=list)
    max_raw_log2: float = 0.0        # headroom audit vs the chain modulus


def simulate(prog: HEVMProgram, constants, inputs, profile: str,
             audit=True, tol_log2=1e-6, steer=False):
    """Run `prog` on float vectors.

    constants: list of numpy payloads (the .cst sidecar, index = encode lhs).
    inputs: list of numpy [<= nt] message vectors (one per program arg).
    Returns SimResult with decoded (message, scale) outputs in res_dst order.

    steer=True models the executor's exact-scale plaintext policy
    (executor.py preprocess): a plaintext's encode scale is a free REAL
    parameter, so ADDCP operands encode at the ciphertext's true scale
    (exact match) and MULCP/upscalec masks encode at target/s_ct so the
    product lands exactly on the planner's canonical 2^bits — re-anchoring
    the composite-prime-pair drift (pair products are 2^60*(1±4e-5), not
    2^60) before it accumulates across forced-scale adds.

    steer="global" additionally runs the sequential drift solver
    (solve_steering) so each forced add's operands match EXACTLY, not just
    canonically: remaining mismatches only where no free encode lies on
    either operand path.
    """
    q_primes, rr, nt = profile_primes(profile)
    solved = None
    if steer == "global":
        from .steer import solve_steering
        solved = solve_steering(prog, q_primes, rr)

    cts = {}          # reg -> (raw float64 [nt], nl, scale)
    pts = {}          # reg -> (raw float64 [nt], nl, scale)
    for i, v in enumerate(inputs):
        sc = float(2.0 ** prog.arg_scale[i])
        nl = (prog.arg_level[i] + 1) * rr
        vec = np.zeros(nt)
        vv = np.asarray(v, np.float64).ravel()
        vec[: vv.size] = vv
        cts[i] = (vec * sc, nl, sc)

    mismatches = []
    max_raw = 0.0
    pbits = {i: float(prog.arg_scale[i]) for i in range(len(inputs))}
    rf = 30.0 * rr        # planner bits dropped per rescale (rf=60 at rr=2)

    def enc(op):
        level = op.rhs >> 10
        sbits = op.rhs & 0x3FF
        nl = (level + 1) * rr
        if op.lhs == 0xFFFF:
            vec = np.ones(nt)
        else:
            vec = np.zeros(nt)
            vv = np.asarray(constants[op.lhs], np.float64).ravel()
            vec[: vv.size] = vv[:nt]
            if vv.size == 1:
                vec[:] = vv[0]
        # steer mode: store the message; scale chosen at use time
        pts[op.dst] = (vec, nl, float(sbits))

    def drop(raw, nl, sc, k):
        for _ in range(k):
            q = q_primes[nl - 1]
            raw = raw / q
            sc /= q
            nl -= 1
        return raw, nl, sc

    for opi, op in enumerate(prog.ops):
        oc = op.opcode
        if oc == OP_ALLOC:
            continue
        if oc == OP_ENCODE:
            enc(op)
            continue
        if oc == OP_ROTATE:
            raw, nl, sc = cts[op.lhs]
            cts[op.dst] = (np.roll(raw, -op.rhs), nl, sc)
            pbits[op.dst] = pbits[op.lhs]
        elif oc == OP_NEGATE:
            raw, nl, sc = cts[op.lhs]
            cts[op.dst] = (-raw, nl, sc)
            pbits[op.dst] = pbits[op.lhs]
        elif oc == OP_RESCALE:
            raw, nl, sc = cts[op.lhs]
            cts[op.dst] = drop(raw, nl, sc, rr)
            pbits[op.dst] = pbits[op.lhs] - rf
        elif oc == OP_MODSWITCH:
            raw, nl, sc = cts[op.lhs]
            r2, n2, _ = drop(raw, nl, sc, op.rhs * rr)
            cts[op.dst] = (raw, n2, sc)      # modswitch keeps raw & scale
            pbits[op.dst] = pbits[op.lhs]
        elif oc == OP_UPSCALE:
            raw, nl, sc = cts[op.lhs]
            if steer:
                # integer multiplier re-anchoring drift to canonical 2^bits:
                # K = round(2^(u+pb)/s_true); relative granularity 2^-u
                # (flagship programs use u in {20, 40} -> residual <= 5e-7)
                x = solved.upscale_x.get(opi, 0.0) if solved else 0.0
                f = float(round(2.0 ** (op.rhs + pbits[op.lhs] + x) / sc))
            else:
                f = 2.0 ** op.rhs
            cts[op.dst] = (raw * f, nl, sc * f)
            pbits[op.dst] = pbits[op.lhs] + op.rhs
        elif oc == OP_ADDCC:
            ra, nla, sa = cts[op.lhs]
            rb, nlb, sb = cts[op.rhs]
            if audit and abs(np.log2(sa) - np.log2(sb)) > tol_log2:
                mismatches.append((opi, "addcc", np.log2(sa), np.log2(sb)))
            cts[op.dst] = (ra + rb, min(nla, nlb), sb)
            pbits[op.dst] = pbits[op.rhs]
        elif oc == OP_ADDCP:
            ra, nla, sa = cts[op.lhs]
            vec, nlb, bbits = pts[op.rhs]
            sb = sa if steer else float(2.0 ** bbits)
            if audit and abs(np.log2(sa) - np.log2(sb)) > tol_log2:
                mismatches.append((opi, "addcp", np.log2(sa), np.log2(sb)))
            cts[op.dst] = (ra + vec * sb, nla, sb)
            pbits[op.dst] = bbits
        elif oc == OP_MULCC:
            ra, nla, sa = cts[op.lhs]
            rb, nlb, sb = cts[op.rhs]
            cts[op.dst] = (ra * rb, min(nla, nlb), sa * sb)
            pbits[op.dst] = pbits[op.lhs] + pbits[op.rhs]
        elif oc == OP_MULCP:
            ra, nla, sa = cts[op.lhs]
            vec, nlb, bbits = pts[op.rhs]
            if steer:
                # land the product exactly on the planner's canonical 2^bits
                # (plus the solver's correction when running globally)
                x = solved.mulcp_x.get(opi, 0.0) if solved else 0.0
                sb = 2.0 ** (pbits[op.lhs] + bbits + x) / sa
            else:
                sb = float(2.0 ** bbits)
            cts[op.dst] = (ra * (vec * sb), nla, sa * sb)
            pbits[op.dst] = pbits[op.lhs] + bbits
        elif oc == OP_BOOTSTRAP:
            raw, nl, sc = cts[op.lhs]
            cts[op.dst] = (raw, (op.rhs + 1) * rr, sc)
            pbits[op.dst] = pbits[op.lhs]
        else:
            raise ValueError(f"bad opcode {oc}")
        if oc != OP_ENCODE:
            r = cts[op.dst][0]
            m = float(np.max(np.abs(r)))
            if m > 0:
                max_raw = max(max_raw, np.log2(m))

    outs = []
    for r in prog.res_dst:
        raw, nl, sc = cts[r]
        outs.append((raw / sc, sc))
    return SimResult(outs, mismatches, max_raw)


def simulate_artifacts(name, pipeline, waterline, profile, inputs,
                       traced_dir="traced", out_dir="optimized", **kw):
    """Convenience: load the on-disk artifacts the way the runner does
    (runtime/runner.py load) and simulate."""
    import os
    from ..ir.serialize import read_cst

    hv = os.path.join(out_dir, pipeline,
                      f"{name}.{waterline}._hecate_{name}.hevm")
    cst = os.path.join(traced_dir, f"_hecate_{name}.cst")
    prog = HEVMProgram.load(hv)
    constants = read_cst(cst)
    return simulate(prog, constants, inputs, profile, **kw)
