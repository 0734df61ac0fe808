"""The port's op profiler (dacapo_tpu_torch/runtime/profiler.py) on the CPU:
`isotonic` equals the JAX package's; profile_backend at test_n10 (one
iteration) writes a table in the schema of the committed compiler profile,
which ir/config.load_profile reads back, with positive nondecreasing
latency rows and the committed noise table; the committed profiles are
never written; the CLI's `profile` subcommand writes the same schema."""

import hashlib
import json
import os

import numpy as np
import pytest

from dacapo_tpu.runtime.profiler import isotonic as ref_isotonic
from dacapo_tpu_torch import cli
from dacapo_tpu_torch.ir.config import load_profile
from dacapo_tpu_torch.runtime import profiler

COMMITTED = os.path.join(profiler.PROFILES_DIR, "profiled_TPU_test_n10.json")


def _digests():
    out = {}
    for f in sorted(os.listdir(profiler.PROFILES_DIR)):
        with open(os.path.join(profiler.PROFILES_DIR, f), "rb") as h:
            out[f] = hashlib.sha256(h.read()).hexdigest()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_isotonic_equals_jax_package(seed):
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.normal(1.0, 3.0, 5 + 4 * seed)) * 10 ** rng.uniform(0, 5)
    got = profiler.isotonic(v)
    assert got == ref_isotonic(v)
    assert all(a <= b for a, b in zip(got, got[1:]))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    before = _digests()
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("prof"))
    try:
        path = profiler.profile_backend("test_n10", iters=1, device="cpu")
    finally:
        os.chdir(cwd)
    return path, before


def test_written_table_loads(written):
    path, _ = written
    assert os.path.basename(path) == "profiled_CPU_test_n10.json"
    with open(path) as f:
        doc = json.load(f)
    with open(COMMITTED) as f:
        ref = json.load(f)
    assert set(doc) == set(ref)
    assert set(doc["latencyTable"]) == set(ref["latencyTable"])
    for k in ("rescalingFactor", "polynomialDegree", "levelUpperBound",
              "bootstrapLevelUpperBound"):
        assert doc[k] == ref[k], k
    assert doc["noiseTable"] == ref["noiseTable"]
    assert doc["runtime"] == "torch-HEVM CPU"
    for k, row in doc["latencyTable"].items():
        assert len(row) == doc["levelUpperBound"], k
        assert all(v > 0 for v in row) and row == sorted(row), (k, row)
    cfg = load_profile(path)
    assert cfg.runtime == "torch-HEVM CPU" and cfg.level_upper == doc["levelUpperBound"]
    assert cfg.latency_of("mul", False, 3) == doc["latencyTable"]["earth.mul_double"][2]


def test_committed_profiles_untouched(written, tmp_path):
    _, before = written
    assert _digests() == before
    with pytest.raises(ValueError, match="committed compiler profiles"):
        profiler.profile_backend("test_n10", out_path=COMMITTED, iters=1, device="cpu")
    with pytest.raises(ValueError, match="no native bootstrap"):
        profiler.profile_backend("test_n10", out_path=str(tmp_path / "p.json"), iters=1,
                                 device="cpu", bootstrap=True)
    assert _digests() == before


def test_cli_profile_writes_the_table(tmp_path, capsys):
    out = str(tmp_path / "p.json")
    cli.main(["profile", "test_n10", "-o", out, "--iters", "1", "--device", "cpu"])
    assert capsys.readouterr().out.strip() == out
    cfg = load_profile(out)
    assert cfg.polynomial_degree == 1 << 10 and cfg.latency_of("rotate", True, 2) > 0
