"""ELASM scale management (copy of dacapo_tpu/passes/elasm.py).

Ports ScaleManagementScheduler.cpp:30-95 (random plan mutation over SMU
edges + apply_schedule materialization) and ELASMExplorer.cpp:40-179
(`parallel` clones x `num_iter` iterations; inner pipeline
scheduler -> SNR -> upscale bubbling -> canonicalize -> early modswitch ->
canonicalize/CSE -> error+latency estimators; cost = sqrt(latency) *
(beta + log2 error); per-explorer Metropolis accept with gamma).
"""

import math

import numpy as np

from ..ir.config import current_config
from ..ir.earth import Function, Op, infer_type
from .smu import ScaleManagementUnit
from .scale import snr_rescaling
from .hoist import early_modswitch, upscale_bubbling
from .rewrite import canonicalize, cse
from .estimator import latency_estimator, error_estimator


def scale_management_scheduler(fn: Function, smu=None, rng=None, config=None):
    cfg = config or current_config()
    if smu is None:
        smu = ScaleManagementUnit(fn)
    if "sm_plan_edge" not in fn.attrs:
        fn.attrs["sm_plan_edge"] = []
        fn.attrs["sm_plan_scale"] = []
        fn.attrs["sm_plan_level"] = []
    elif not fn.attrs.get("no_mutation"):
        rng = rng or np.random.default_rng()
        n_edges = max(1, smu.edge_num)
        plan_num = int(rng.poisson(int(math.sqrt(n_edges))))
        plan = {}
        for _ in range(plan_num):
            e = int(rng.integers(0, n_edges))
            plan[e] = (max(0, int(rng.integers(-15, 16))),
                       int(rng.integers(0, 3)))
        fn.attrs["sm_plan_edge"] = list(plan.keys())
        fn.attrs["sm_plan_scale"] = [v[0] for v in plan.values()]
        fn.attrs["sm_plan_level"] = [v[1] for v in plan.values()]

    # materialize apply_schedule on every cipher operand of the chosen edges
    pending = {}
    for e, sc, lv in zip(fn.attrs["sm_plan_edge"], fn.attrs["sm_plan_scale"],
                         fn.attrs["sm_plan_level"]):
        if e >= smu.edge_num:
            continue
        for (op, k) in smu.edge_to_oper[e]:
            v = op.operands[k]
            if not v.ty.is_cipher:
                continue
            ap = Op("apply_schedule", [v],
                    {"scaleFactor": sc, "levelFactor": lv}, v.ty, op.loc)
            op.operands[k] = ap.result
            pending.setdefault(id(op), []).append(ap)
    if pending:
        new_ops = []
        for op in fn.ops:
            new_ops.extend(pending.get(id(op), []))
            new_ops.append(op)
        fn.ops = new_ops
    return fn


def _inner_pipeline(fn, waterline, output_val, cfg, rng):
    smu = ScaleManagementUnit(fn)   # from attached attrs on clones
    scale_management_scheduler(fn, smu, rng, cfg)
    snr_rescaling(fn, waterline, output_val, smu=smu, config=cfg)
    upscale_bubbling(fn)
    canonicalize(fn)
    early_modswitch(fn)
    canonicalize(fn)
    cse(fn)
    err = error_estimator(fn, cfg)
    lat = latency_estimator(fn, cfg)
    return lat, err


def _explore_chains(fn, n_chains, num_iter, waterline, output_val,
                    beta, gamma, rng, cfg):
    """Run `n_chains` independent Metropolis explorer chains for `num_iter`
    iterations; returns (best_plan, best_cost). The reference treats ANY
    pass failure on a mutated plan as the infeasibility probe
    (ELASMExplorer.cpp applyPlan -> failed() check), so every exception from
    the inner pipeline skips that sample rather than aborting the search;
    unexpected kinds are counted and reported once per chain block so real
    bugs stay visible without killing the worker pool."""
    from .scale import TypeInferenceError

    def cost_func(lat, err):
        return math.sqrt(max(lat, 1e-12)) * (beta + math.log2(max(err, 1e-300)))

    plans = [([], [], [])] * n_chains
    costs = [float("inf")] * n_chains
    opt_cost = float("inf")
    opt_plan = ([], [], [])
    unexpected = {}   # exception name -> count (non-TypeInference skips)

    for _ in range(num_iter):
        for i in range(n_chains):
            dup, _ = fn.clone()
            dup.attrs["sm_plan_edge"] = list(plans[i][0])
            dup.attrs["sm_plan_scale"] = list(plans[i][1])
            dup.attrs["sm_plan_level"] = list(plans[i][2])
            try:
                lat, err = _inner_pipeline(dup, waterline, output_val, cfg, rng)
            except TypeInferenceError:
                continue
            except Exception as e:          # infeasible-plan probe (see doc)
                unexpected[type(e).__name__] = \
                    unexpected.get(type(e).__name__, 0) + 1
                continue
            cost = cost_func(lat, err)
            plan = (dup.attrs["sm_plan_edge"], dup.attrs["sm_plan_scale"],
                    dup.attrs["sm_plan_level"])
            alpha = min(1.0, 2.0 ** (-gamma * (1.0 - costs[i] / cost)))
            if rng.uniform() < alpha:
                plans[i] = plan
                costs[i] = cost
            if cost < opt_cost:
                opt_plan = plan
                opt_cost = cost
    if unexpected:
        import sys
        print(f"elasm: skipped infeasible plans with non-TypeInference "
              f"errors: {unexpected}", file=sys.stderr)
    return opt_plan, opt_cost


def _elasm_worker(args):
    """Process-pool entry: one block of explorer chains (the reference fans
    its 20 explorers out over std::threads, ELASMExplorer.cpp:93-111)."""
    (fn_path, n_chains, num_iter, waterline, output_val, beta, gamma,
     seed, cfg) = args
    from ..ir.serialize import load_function
    fn = load_function(fn_path)
    rng = np.random.default_rng(seed)
    plan, cost = _explore_chains(fn, n_chains, num_iter, waterline,
                                 output_val, beta, gamma, rng, cfg)
    return plan, cost


def elasm_explorer(fn: Function, waterline: int, output_val: int = 0,
                   config=None, parallel=20, num_iter=1000, beta=50.0,
                   gamma=50.0, seed=None, workers=None):
    cfg = config or current_config()
    rng = np.random.default_rng(seed)
    smu = ScaleManagementUnit(fn)
    smu.attach()

    if workers is None:
        import os
        workers = min(os.cpu_count() or 1, parallel)
    if workers > 1 and parallel > 1:
        import os
        import tempfile
        import multiprocessing as mp
        from ..ir.serialize import save_function
        with tempfile.NamedTemporaryFile(
                suffix=".eir.json", delete=False) as tf:
            fn_path = tf.name
        save_function(fn, fn_path)
        base = [parallel // workers] * workers
        for i in range(parallel % workers):
            base[i] += 1
        seeds = rng.integers(0, 2 ** 31, size=workers)
        jobs = [(fn_path, b, num_iter, waterline, output_val, beta, gamma,
                 int(s), cfg) for b, s in zip(base, seeds) if b > 0]
        ctx = mp.get_context("spawn")   # no forked TPU-client state
        with ctx.Pool(len(jobs)) as pool:
            results = pool.map(_elasm_worker, jobs)
        os.unlink(fn_path)
        opt_plan, opt_cost = min(results, key=lambda r: r[1])
    else:
        opt_plan, opt_cost = _explore_chains(
            fn, parallel, num_iter, waterline, output_val, beta, gamma,
            rng, cfg)

    # apply the winning plan to the real function
    fn.attrs["sm_plan_edge"] = list(opt_plan[0])
    fn.attrs["sm_plan_scale"] = list(opt_plan[1])
    fn.attrs["sm_plan_level"] = list(opt_plan[2])
    fn.attrs["no_mutation"] = True
    scale_management_scheduler(fn, smu, rng, cfg)
    snr_rescaling(fn, waterline, output_val, smu=smu, config=cfg)
    upscale_bubbling(fn)
    canonicalize(fn)
    return fn
