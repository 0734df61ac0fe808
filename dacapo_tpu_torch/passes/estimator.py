"""Latency/error estimators, autodiff (copy of dacapo_tpu/passes/estimator.py).

Ports lib/Dialect/Earth/Analysis/AutoDifferentiation.cpp:12-99,
Transforms/LatencyEstimator.cpp:26-38 and ErrorEstimator.cpp:30-63, with the
HEProfInterface lookup semantics (HEParameterInterface.td:107-223): tables
indexed by remaining levels (cipherLevel = init_level - earth level), _single
vs _double keyed on whether both operands are cipher, and rotate cost scaled
by its NAF term count (EarthOps.td:195-209) — or by 1 under the TPU cost
model, which executes one keyswitch per arbitrary offset.
"""

import math

from ..ir.config import current_config
from ..ir.earth import Function


def naf_count(x: int, n_half: int) -> int:
    """Number of nonzero NAF digits of x mod n_half (hecate::naf)."""
    x %= n_half
    cnt = 0
    while x:
        if x & 1:
            z = 2 - (x % 4)
            x -= z
            if z % n_half:
                cnt += 1
        x >>= 1
    return cnt


def op_num(op, cfg, rotation_cost_model="single"):
    if op.opcode == "rotate" and rotation_cost_model == "naf":
        return max(1, naf_count(op.attrs["offset"], cfg.polynomial_degree // 2))
    return 1


def cipher_level(fn, op, cfg):
    init = fn.attrs.get("init_level", cfg.level_upper)
    return init - op.ty.level


class AutoDifferentiation:
    """Forward value estimation + reverse-mode gradients (per-op rules from
    EarthOps.td estimateValue/differentiate)."""

    def __init__(self, fn: Function):
        self.fn = fn
        self.value_est = {}
        self.value_diff = {}
        self.operand_diff = {}   # (op id, operand idx) -> grad
        self._build()

    def _est_rule(self, op, est):
        if op.opcode == "constant":
            return op.attrs.get("rms_var", 1.0)
        if op.opcode == "add":
            return 1.0
        if op.opcode == "mul":
            return est[0] * est[1]
        return est[0]

    def _diff_rule(self, op, grad, est):
        if op.opcode == "constant":
            return []
        if op.opcode == "add":
            return [grad, grad]
        if op.opcode == "mul":
            return [grad * est[1], grad * est[0]]
        return [grad]

    def _build(self):
        fn = self.fn
        for a in fn.args:
            self.value_est[a] = 0.0
        uses = {}
        for op in fn.ops:
            for i, v in enumerate(op.operands):
                uses.setdefault(v, []).append((op, i))
        for op in fn.ops:
            est = [self.value_est.setdefault(v, 1.0) for v in op.operands]
            self.value_est[op.result] = self._est_rule(op, est)
        ret_uses = {}
        for v in fn.returns:
            ret_uses[v] = ret_uses.get(v, 0) + 1
        for op in reversed(fn.ops):
            # the func.return operand counts as a use with default grad 1.0
            grad = float(ret_uses.get(op.result, 0))
            for (uop, i) in uses.get(op.result, []):
                grad += self.operand_diff.setdefault((id(uop), i), 1.0)
            self.value_diff[op.result] = grad
            est = [self.value_est.get(v, 1.0) for v in op.operands]
            for i, g in enumerate(self._diff_rule(op, grad, est)):
                self.operand_diff[(id(op), i)] = g

    def back_diff(self, op):
        return self.value_diff.get(op.result, 1.0)


def _is_single(op):
    if op.opcode in ("add", "mul"):
        return not all(v.ty.is_cipher for v in op.operands)
    return True


def latency_estimator(fn: Function, config=None, rotation_cost_model="single"):
    """Sets fn.attrs['est_latency'] (LatencyEstimator.cpp:26-38).
    modswitch cost sums per dropped level (EarthOps.td:284-292)."""
    cfg = config or current_config()
    total = 0.0
    for op in fn.ops:
        lv = cipher_level(fn, op, cfg)
        single = _is_single(op)
        if op.opcode == "modswitch":
            lat = 0.0
            for i in range(op.attrs["downFactor"]):
                lat += cfg.latency_of("modswitch", True, lv - i)
        else:
            lat = cfg.latency_of(op.opcode, single, lv)
        total += lat * op_num(op, cfg, rotation_cost_model)
    fn.attrs["est_latency"] = total
    return total


def error_estimator(fn: Function, config=None, rotation_cost_model="single"):
    """Sets fn.attrs['est_error'] (ErrorEstimator.cpp:30-63):
    sqrt(Σ noise(op, level) * num * backdiff^2 / 2^scale)."""
    cfg = config or current_config()
    diff = AutoDifferentiation(fn)
    err_sq = 0.0
    for op in fn.ops:
        lv = cipher_level(fn, op, cfg)
        noise = cfg.noise_of(op.opcode, _is_single(op), lv)
        if noise == 0:
            continue
        d = diff.back_diff(op)
        err_sq += (
            noise * op_num(op, cfg, rotation_cost_model) * d * d
            / math.pow(2.0, op.ty.scale)
        )
    fn.attrs["est_error"] = math.sqrt(err_sq)
    return fn.attrs["est_error"]
