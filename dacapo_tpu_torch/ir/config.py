"""Compiler-wide CKKS parameter/profile configuration (copy of dacapo_tpu/ir/config.py).

Mirrors EarthDialect::setCKKSParameters (lib/Dialect/Earth/IR/
EarthDialect.cpp:130-180): rescaling factor, level bounds, and per-op
latency/noise tables loaded from a JSON profile. Profiles for the TPU backend
live in dacapo_tpu/profiles/ and are (re)generated by tools/profile_ops.py on
real hardware.
"""

import json
import os
from dataclasses import dataclass, field

_OPNAMES = (
    "constant", "rotate", "negate", "bootstrap", "rescale", "modswitch",
    "upscale", "apply_schedule", "add", "mul",
)


@dataclass
class CompilerConfig:
    rescaling_factor: int = 30
    polynomial_degree: int = 1 << 15
    level_lower: int = 1
    level_upper: int = 13
    bootstrap_level_lower: int = 2
    bootstrap_level_upper: int = 13
    runtime: str = "TPU-HEVM"
    latency: dict = field(default_factory=dict)   # name_{single,double} -> [per level]
    noise: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            d = json.load(f)
        cfg = cls(
            rescaling_factor=d["rescalingFactor"],
            polynomial_degree=d["polynomialDegree"],
            level_lower=d["levelLowerBound"],
            level_upper=d["levelUpperBound"],
            bootstrap_level_lower=d["bootstrapLevelLowerBound"],
            bootstrap_level_upper=d["bootstrapLevelUpperBound"],
            runtime=d.get("runtime", "TPU-HEVM"),
        )
        cfg._load_tables(d.get("latencyTable", {}), d.get("noiseTable", {}))
        return cfg

    def _load_tables(self, lat, noi):
        # pad like the reference: leading 0 for level 0, extend last entry
        for name in _OPNAMES:
            for suffix in ("_single", "_double"):
                key = f"earth.{name}{suffix}"
                for src, dst in ((lat, self.latency), (noi, self.noise)):
                    tab = [0] + list(src.get(key, []))
                    if len(tab) < self.level_upper + 1:
                        tab += [tab[-1]] * (self.level_upper + 1 - len(tab))
                    dst[key] = tab[: self.level_upper + 1]

    def latency_of(self, opname: str, single: bool, level: int) -> float:
        key = f"earth.{opname}{'_single' if single else '_double'}"
        lv = max(0, min(level, self.level_upper))
        return self.latency.get(key, [0] * (self.level_upper + 1))[lv]

    def noise_of(self, opname: str, single: bool, level: int) -> float:
        key = f"earth.{opname}{'_single' if single else '_double'}"
        lv = max(0, min(level, self.level_upper))
        return self.noise.get(key, [0] * (self.level_upper + 1))[lv]


_current = CompilerConfig()


def current_config() -> CompilerConfig:
    return _current


def set_config(cfg: CompilerConfig) -> CompilerConfig:
    global _current
    _current = cfg
    return cfg


def load_profile(name_or_path: str) -> CompilerConfig:
    if os.path.exists(name_or_path):
        path = name_or_path
    else:
        path = os.path.join(
            os.path.dirname(__file__), "..", "profiles", f"{name_or_path}.json"
        )
    return set_config(CompilerConfig.from_json(path))
