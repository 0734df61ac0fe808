"""Exact-scale steering solver for compiled HEVM programs.

Copy of dacapo_tpu/vm/steer.py.

Composite-rescale chains (32-bit limb pairs standing in for one 60-bit
prime, crypto/primes.py gen_balanced_pairs) drop pair products that are
2^60*(1+delta) with |delta| up to ~4e-5 — so the TRUE scale of a ciphertext
drifts off the planner's canonical 2^bits as rescales accumulate, and every
forced-scale add (SEAL semantics: operands assumed at the planner scale,
SEAL_HEVM.cpp:268-334) injects a relative error of the operands' drift
difference. Measured on the flagship ResNet artifact this was the DOMINANT
end-to-end error: sim RMS 1.85e-2 from 1435 mismatched adds vs the 9.5e-4
reference bar (vm/simulate.py audit).

The fix uses the degrees of freedom the runtime already owns:

* a plaintext's encode scale is a free REAL parameter (encode just rounds
  m * S) — each MULCP mask can place its product at ANY target scale;
* ADDCP plaintexts can encode at the ciphertext operand's true scale;
* UPSCALE (factor 2^u) can multiply by any INTEGER K instead, hitting a
  real target with relative granularity 2^-u (flagship u in {20, 40}).

Pass 1 (this module) walks the program symbolically in log2 space: each
ciphertext register carries its drift-from-planner-bits as an affine
expression over fresh variables (one per steerable MULCP/UPSCALE site);
every ADDCC imposes drift_lhs == drift_rhs, solved sequentially by
assigning the latest free variable in the difference. Pass 2 (the executor
preprocess / simulator) encodes plaintexts and upscale multipliers at the
solved scales. Adds with no free variable on either path remain forced and
are reported (their count drives the prime-pair quality requirement).
"""

from dataclasses import dataclass, field

import numpy as np

from .hevm import (
    OP_ENCODE, OP_ROTATE, OP_NEGATE, OP_RESCALE, OP_MODSWITCH, OP_UPSCALE,
    OP_ADDCC, OP_ADDCP, OP_MULCC, OP_MULCP, OP_BOOTSTRAP, OP_ALLOC,
)

_TOL = 1e-9          # log2 drift below this counts as matched


@dataclass
class SteerPlan:
    # op index -> solved log2 correction x (target = canonical * 2^x)
    mulcp_x: dict = field(default_factory=dict)
    upscale_x: dict = field(default_factory=dict)
    # op index of forced (unsolvable) adds -> residual dlog2
    forced: dict = field(default_factory=dict)

    @property
    def max_forced(self):
        return max(map(abs, self.forced.values()), default=0.0)


def _merge(a, b, sign=1.0):
    if not b:
        return a
    out = dict(a)
    for k, v in b.items():
        v2 = out.get(k, 0.0) + sign * v
        if v2 == 0.0:
            out.pop(k, None)
        else:
            out[k] = v2
    return out


def solve_steering(prog, q_primes, rr, prime_bits=None):
    """Solve per-site scale corrections; see module docstring.

    q_primes: the actual prime chain (crypto profile order, row 0 bottom).
    rr: rescale_rows (limb rows per IR level).
    Returns a SteerPlan.
    """
    if prime_bits is None:
        prime_bits = int(round(np.log2(float(q_primes[-1]))))
    # per-row drift of one dropped row vs the planner's 2^prime_bits
    row_delta = [prime_bits - float(np.log2(float(q))) for q in q_primes]

    assign = {}
    var_sites = {}         # var id -> ("mulcp"|"upscale", opi)

    def walk(solving):
        """One pass; when `solving`, assign free vars at mismatched adds.
        Returns {opi: residual} for adds unmatched under current assign."""
        nvar = 0
        forced = {}
        # per ct reg: (const_drift, {var: coef}, nl)
        regs = {i: (0.0, {}, (prog.arg_level[i] + 1) * rr)
                for i in range(prog.arg_length)}

        def val(c, vs):
            return c + sum(coef * assign.get(v, 0.0)
                           for v, coef in vs.items())

        for opi, op in enumerate(prog.ops):
            oc = op.opcode
            if oc in (OP_ALLOC, OP_ENCODE):
                continue
            if oc in (OP_ROTATE, OP_NEGATE):
                regs[op.dst] = regs[op.lhs]
            elif oc == OP_RESCALE:
                c, vs, nl = regs[op.lhs]
                for k in range(rr):
                    c += row_delta[nl - 1 - k]
                regs[op.dst] = (c, vs, nl - rr)
            elif oc == OP_MODSWITCH:
                c, vs, nl = regs[op.lhs]
                regs[op.dst] = (c, vs, nl - op.rhs * rr)
            elif oc in (OP_UPSCALE, OP_MULCP):
                _, _, nl = regs[op.lhs]
                v = nvar
                nvar += 1
                var_sites[v] = ("upscale" if oc == OP_UPSCALE else "mulcp",
                                opi)
                regs[op.dst] = (0.0, {v: 1.0}, nl)
            elif oc == OP_ADDCP:
                # plaintext encodes at the ciphertext's true scale: exact
                regs[op.dst] = regs[op.lhs]
            elif oc == OP_MULCC:
                cl, vl, nl = regs[op.lhs]
                cr, vr, nr = regs[op.rhs]
                regs[op.dst] = (cl + cr, _merge(vl, vr), min(nl, nr))
            elif oc == OP_BOOTSTRAP:
                c, vs, _ = regs[op.lhs]
                # both bootstrappers preserve the true scale exactly
                regs[op.dst] = (c, vs, (op.rhs + 1) * rr)
            elif oc == OP_ADDCC:
                cl, vl, nl = regs[op.lhs]
                cr, vr, nr = regs[op.rhs]
                dc, dv = cl - cr, _merge(vl, vr, -1.0)
                resid = val(dc, dv)
                if solving and abs(resid) > _TOL:
                    free = [v for v in dv if v not in assign]
                    if free:
                        v = max(free)        # latest site: most local fix
                        assign[v] = -resid / dv[v]
                        resid = 0.0
                if abs(resid) > _TOL:
                    forced[opi] = resid
                regs[op.dst] = (cr, vr, min(nl, nr))
            else:
                raise ValueError(f"bad opcode {oc}")
        return forced

    # solve passes until converged (an assignment made by a later add can
    # disturb an earlier one; rare in practice), then one frozen audit pass
    prev = None
    for _ in range(4):
        forced = walk(solving=True)
        if prev is not None and set(forced) == set(prev):
            break
        prev = forced
    plan = SteerPlan(forced=walk(solving=False))
    for v, x in assign.items():
        kind, opi = var_sites[v]
        (plan.mulcp_x if kind == "mulcp" else plan.upscale_x)[opi] = x
    return plan


@dataclass
class SteerExec:
    """Concrete per-op steering data for the executor (pass 2)."""
    enc_scale: dict = field(default_factory=dict)   # encode opi -> float scale
    up_k: dict = field(default_factory=dict)        # upscale opi -> (int K, nl)
    forced: dict = field(default_factory=dict)      # add opi -> dlog2 residual
    conflicts: list = field(default_factory=list)   # multi-use encode clashes


def steer_scales(prog, q_primes, rr, prime_bits=None):
    """Solve the plan, then walk the program with TRUE scales to produce the
    concrete encode scales and integer upscale multipliers the runtime
    applies. Shared by the executor preprocess and the simulator."""
    if prime_bits is None:
        prime_bits = int(round(np.log2(float(q_primes[-1]))))
    plan = solve_steering(prog, q_primes, rr, prime_bits)
    out = SteerExec(forced=plan.forced)

    ts = {}          # reg -> true scale (float)
    pb = {}          # reg -> planner bits (float)
    nls = {}         # reg -> active rows
    for i in range(prog.arg_length):
        ts[i] = float(2.0 ** prog.arg_scale[i])
        pb[i] = float(prog.arg_scale[i])
        nls[i] = (prog.arg_level[i] + 1) * rr
    pt = {}          # pt reg -> (encode opi, bits)

    def pt_use(opi_use, reg, want):
        """Resolve the encode feeding `reg` to scale `want` (first use
        wins; later conflicting uses are recorded and get the first scale)."""
        enc_opi, bits = pt[reg]
        got = out.enc_scale.get(enc_opi)
        if got is None:
            out.enc_scale[enc_opi] = got = float(want)
        elif abs(np.log2(got) - np.log2(want)) > 1e-7:
            out.conflicts.append((enc_opi, opi_use,
                                  float(np.log2(want / got))))
        return got

    for opi, op in enumerate(prog.ops):
        oc = op.opcode
        if oc == OP_ALLOC:
            continue
        if oc == OP_ENCODE:
            pt[op.dst] = (opi, op.rhs & 0x3FF)
            continue
        if oc in (OP_ROTATE, OP_NEGATE):
            ts[op.dst], pb[op.dst], nls[op.dst] = \
                ts[op.lhs], pb[op.lhs], nls[op.lhs]
        elif oc == OP_RESCALE:
            s, nl = ts[op.lhs], nls[op.lhs]
            for k in range(rr):
                s /= float(q_primes[nl - 1 - k])
            ts[op.dst] = s
            pb[op.dst] = pb[op.lhs] - prime_bits * rr
            nls[op.dst] = nl - rr
        elif oc == OP_MODSWITCH:
            ts[op.dst], pb[op.dst] = ts[op.lhs], pb[op.lhs]
            nls[op.dst] = nls[op.lhs] - op.rhs * rr
        elif oc == OP_UPSCALE:
            x = plan.upscale_x.get(opi, 0.0)
            k = int(round(2.0 ** (op.rhs + pb[op.lhs] + x) / ts[op.lhs]))
            out.up_k[opi] = (k, nls[op.lhs])
            ts[op.dst] = ts[op.lhs] * k
            pb[op.dst] = pb[op.lhs] + op.rhs
            nls[op.dst] = nls[op.lhs]
        elif oc == OP_ADDCP:
            got = pt_use(opi, op.rhs, ts[op.lhs])
            ts[op.dst] = got
            pb[op.dst] = pt[op.rhs][1]
            nls[op.dst] = nls[op.lhs]
        elif oc == OP_MULCP:
            x = plan.mulcp_x.get(opi, 0.0)
            bits = pt[op.rhs][1]
            want = 2.0 ** (pb[op.lhs] + bits + x) / ts[op.lhs]
            got = pt_use(opi, op.rhs, want)
            ts[op.dst] = ts[op.lhs] * got
            pb[op.dst] = pb[op.lhs] + bits
            nls[op.dst] = nls[op.lhs]
        elif oc == OP_MULCC:
            ts[op.dst] = ts[op.lhs] * ts[op.rhs]
            pb[op.dst] = pb[op.lhs] + pb[op.rhs]
            nls[op.dst] = min(nls[op.lhs], nls[op.rhs])
        elif oc == OP_ADDCC:
            ts[op.dst], pb[op.dst] = ts[op.rhs], pb[op.rhs]
            nls[op.dst] = min(nls[op.lhs], nls[op.rhs])
        elif oc == OP_BOOTSTRAP:
            ts[op.dst], pb[op.dst] = ts[op.lhs], pb[op.lhs]
            nls[op.dst] = (op.rhs + 1) * rr
        else:
            raise ValueError(f"bad opcode {oc}")
    return out
