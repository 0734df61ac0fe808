"""The native path's artifacts and the compiler profiles (C.1 of the port):
the JAX compiler regenerates dacapo_tpu_torch/artifacts/deep_dacapo40_tpu_n15b
byte for byte (scripts/make_native_artifact.py, about 2 s), the port's reader
parses the program as the JAX package's does, and the port's load_profile
gives the JAX package's CompilerConfig for every crypto profile."""

import dataclasses
import hashlib
import importlib.util
import json
import os

import pytest

from dacapo_tpu.ir import config as ref_config
from dacapo_tpu_torch.ir import config as port_config
from dacapo_tpu.crypto.params import COMPILER_PROFILES as REF_COMPILER_PROFILES
from dacapo_tpu.ir.config import load_profile as ref_load_profile
from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram
from dacapo_tpu_torch.crypto.params import COMPILER_PROFILES, PROFILES
from dacapo_tpu_torch.ir.config import load_profile
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP

ROOT = os.path.join(os.path.dirname(__file__), "..")
ART = os.path.join(ROOT, "dacapo_tpu_torch", "artifacts", "deep_dacapo40_tpu_n15b")


@pytest.fixture(autouse=True, scope="module")
def _restore_compiler_configs():
    """load_profile sets each package's global compiler config: put back
    what the tests found."""
    saved = ref_config.current_config(), port_config.current_config()
    yield
    ref_config.set_config(saved[0])
    port_config.set_config(saved[1])


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_native_artifact", os.path.join(ROOT, "scripts", "make_native_artifact.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("deep")
    mod.compile_deep(str(out))
    return out, mod


@pytest.mark.parametrize("name", ["Deep.hevm", "Deep.cst"])
def test_deep_artifact_regenerates_byte_identical(regenerated, name):
    out, _ = regenerated
    assert _bytes(str(out / name)) == _bytes(os.path.join(ART, name))


def test_deep_artifact_expected(regenerated):
    _, mod = regenerated
    with open(os.path.join(ART, "expected.json")) as f:
        expected = json.load(f)
    path = os.path.join(ART, "Deep.hevm")
    got, want = HEVMProgram.load(path), RefProgram._load_py(path)
    assert [(o.opcode, o.dst, o.lhs, o.rhs) for o in got.ops] == \
        [(o.opcode, o.dst, o.lhs, o.rhs) for o in want.ops]
    assert got.validate() == -1
    boots = [o.rhs for o in got.ops if o.opcode == OP_BOOTSTRAP]
    assert boots == expected["bootstrap_target_levels"] == [14, 14]
    assert len(got.ops) == expected["instructions"]
    assert (expected["depth"], expected["input_seed"], tuple(expected["input_range"])) == \
        (mod.DEPTH, mod.X_SEED, mod.X_RANGE)
    for name in ("cst", "hevm"):
        assert hashlib.sha256(_bytes(os.path.join(ART, f"Deep.{name}"))).hexdigest() == \
            expected[f"{name}_sha256"]


def test_compiler_profiles_copied():
    assert COMPILER_PROFILES == REF_COMPILER_PROFILES
    assert set(COMPILER_PROFILES) <= set(PROFILES)
    assert sorted(os.listdir(os.path.join(ROOT, "dacapo_tpu_torch", "profiles"))) == \
        sorted(os.listdir(os.path.join(ROOT, "dacapo_tpu", "profiles")))


@pytest.mark.parametrize("profile", sorted(REF_COMPILER_PROFILES))
def test_load_profile_equals_jax(profile):
    got = load_profile(COMPILER_PROFILES[profile])
    want = ref_load_profile(REF_COMPILER_PROFILES[profile])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
