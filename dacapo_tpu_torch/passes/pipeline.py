"""Compile pipelines, hecate-opt's (copy of dacapo_tpu/passes/pipeline.py).

Pass orders mirror tools/optimizer.cpp: eva :236-279, snr :281-325,
pars :437-480 (walk -> EarlyModswitch -> CSE -> canonicalize -> lower ->
buffer reuse -> emit). --elasm and --dacapo are registered in
passes/elasm.py and passes/dacapo.py.
"""

import os

from ..ir.config import current_config
from ..ir.earth import Function
from .scale import waterline_rescaling, proactive_rescaling, snr_rescaling
from .hoist import early_modswitch
from .rewrite import cse, canonicalize
from ..vm.lower import lower


def run_scale_pipeline(fn: Function, pipeline: str, waterline: int,
                       output_val: int = 0, config=None, check_smu=False,
                       **opts):
    cfg = config or current_config()
    if check_smu:
        # --enable-check-smu (optimizer.cpp:246-254): embed SMU ids on the
        # unmanaged IR (SMUEmbedding), verify them after the walk. The full
        # definition-uniqueness verify (ScaleManagementUnit.cpp:372-507)
        # only applies pre-management.
        from .smu import ScaleManagementUnit
        smu0 = ScaleManagementUnit(fn)
        assert smu0.verify_definitions(), \
            "SMU analysis invalid: definition/consumeness violation"
        smu0.attach()
    if pipeline == "eva":
        waterline_rescaling(fn, waterline, output_val, config=cfg)
    elif pipeline == "pars":
        proactive_rescaling(fn, waterline, output_val, config=cfg)
    elif pipeline == "snr":
        snr_rescaling(fn, waterline, output_val, config=cfg)
    elif pipeline == "elasm":
        from .elasm import elasm_explorer
        elasm_explorer(fn, waterline, output_val, config=cfg, **opts)
    elif pipeline == "dacapo":
        from .dacapo import dacapo_plan
        dacapo_plan(fn, waterline, output_val, config=cfg, **opts)
    else:
        raise ValueError(f"unknown pipeline {pipeline}")
    early_modswitch(fn)
    cse(fn)
    canonicalize(fn)
    if check_smu:
        # SMUChecker: every SMU shares one (scale, level) (SMUChecker.cpp:44-96).
        from .smu import ScaleManagementUnit
        smu = ScaleManagementUnit(fn)
        assert smu.verify(), "SMU check failed: group with inconsistent (scale, level)"
        smu.detach()
    return fn


def compile_function(fn: Function, pipeline: str, waterline: int,
                     output_val: int = 0, config=None, out_prefix=None, **opts):
    """Full pipeline -> HEVMProgram (optionally writing <prefix>._hecate_<name>.hevm)."""
    cfg = config or current_config()
    run_scale_pipeline(fn, pipeline, waterline, output_val, config=cfg, **opts)
    fn.verify(cfg)
    prog = lower(fn, config=cfg)
    if out_prefix:
        os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
        prog.save(f"{out_prefix}._hecate_{fn.name}.hevm")
    return prog
