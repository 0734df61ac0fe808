"""The port's committed artifacts (dacapo_tpu_torch/artifacts/) and their
provenance: the JAX compiler regenerates the MLP's byte for byte, the port's
readers parse the MLP and ResNet programs as the JAX package's do, and
(slow) the JAX executor reproduces the committed digest of the MLP's output
ciphertext. The ResNet program takes ~15 minutes to compile:
scripts/make_resnet_artifact.py regenerates it."""

import hashlib
import json
import os

import numpy as np
import pytest

from dacapo_tpu.ir.serialize import read_cst as ref_read_cst
from dacapo_tpu.vm.hevm import HEVMProgram as RefProgram
from dacapo_tpu_torch.ir.serialize import read_cst, write_cst
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP, OP_ENCODE

ART = os.path.join(os.path.dirname(__file__), "..", "dacapo_tpu_torch",
                   "artifacts", "mlp_pars40_tpu_n15")
RESNET_ART = os.path.join(os.path.dirname(ART), "resnet_dacapo40_tpu_n15")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    from examples.benchmarks.MLP import trace
    from examples.common import compile_traced
    tmp = tmp_path_factory.mktemp("art")
    trace(dirs=str(tmp / "traced"))
    hv = compile_traced("MLP", "pars", 40, "tpu_n15", traced_dir=str(tmp / "traced"),
                        out_dir=str(tmp / "optimized"))
    return hv, str(tmp / "traced" / "_hecate_MLP.cst")


@pytest.mark.parametrize("which", ["hevm", "cst"])
def test_artifact_regenerates_byte_identical(regenerated, which):
    path = regenerated[0] if which == "hevm" else regenerated[1]
    assert _bytes(path) == _bytes(os.path.join(ART, f"MLP.{which}"))


def test_port_reader_parses_same_program():
    path = os.path.join(ART, "MLP.hevm")
    got, want = HEVMProgram.load(path), RefProgram._load_py(path)
    for k in ("arg_scale", "arg_level", "res_scale", "res_level", "res_dst",
              "init_level", "num_ctxt", "num_ptxt"):
        assert getattr(got, k) == getattr(want, k), k
    assert [(o.opcode, o.dst, o.lhs, o.rhs) for o in got.ops] == \
        [(o.opcode, o.dst, o.lhs, o.rhs) for o in want.ops]
    assert got.validate() == -1


def test_port_reader_parses_resnet_program(tmp_path):
    """The committed ResNet-20 dacapo-40 program: the port's reader against
    the JAX reader, its writer round trip, and the counts of expected.json."""
    path = os.path.join(RESNET_ART, "ResNet.hevm")
    got, want = HEVMProgram.load(path), RefProgram._load_py(path)
    for k in ("arg_scale", "arg_level", "res_scale", "res_level", "res_dst",
              "init_level", "num_ctxt", "num_ptxt"):
        assert getattr(got, k) == getattr(want, k), k
    assert [(o.opcode, o.dst, o.lhs, o.rhs) for o in got.ops] == \
        [(o.opcode, o.dst, o.lhs, o.rhs) for o in want.ops]
    assert got.validate() == -1
    with open(os.path.join(RESNET_ART, "expected.json")) as f:
        expected = json.load(f)
    assert hashlib.sha256(_bytes(path)).hexdigest() == expected["hevm_sha256"]
    assert len(got.ops) == expected["instructions"]
    assert sum(o.opcode == OP_ENCODE for o in got.ops) == expected["encodes"]
    assert sum(o.opcode == OP_BOOTSTRAP for o in got.ops) == expected["bootstraps"] == 19
    assert len({o for o in got.rotation_offsets() if o != 0}) == \
        expected["rotation_offsets"] == 202
    got.save(str(tmp_path / "x.hevm"))
    assert _bytes(str(tmp_path / "x.hevm")) == _bytes(path)


def test_port_cst_roundtrip(tmp_path):
    path = os.path.join(ART, "MLP.cst")
    got, want = read_cst(path), ref_read_cst(path)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    write_cst(got, str(tmp_path / "x.cst"))
    assert _bytes(str(tmp_path / "x.cst")) == _bytes(path)


def test_port_hevm_writer_roundtrip(tmp_path):
    path = os.path.join(ART, "MLP.hevm")
    HEVMProgram.load(path).save(str(tmp_path / "x.hevm"))
    assert _bytes(str(tmp_path / "x.hevm")) == _bytes(path)


@pytest.mark.slow
def test_jax_reference_digest(tmp_path):
    """Rerun the JAX executor at tpu_n15 on the CPU (keygen of 102 rotation
    keys at N=2^15: minutes, several GB) and check the committed digest."""
    from dacapo_tpu.runtime.runner import HEVM as RefHEVM
    from dacapo_tpu_torch.models.mlp import gen_weights, mlp_plain, make_input
    with open(os.path.join(ART, "expected.json")) as f:
        expected = json.load(f)
    vm = RefHEVM("tpu_n15", keyset_dir=str(tmp_path / "keys"), jit=False)
    vm.load(os.path.join(ART, "MLP.cst"), os.path.join(ART, "MLP.hevm"))
    x = make_input(0)
    vm.setInput(0, x)
    vm.run()
    digest = hashlib.sha256()
    for ct in vm.executor._last_outputs[0]:
        digest.update(np.ascontiguousarray(np.asarray(ct), dtype="<u4").tobytes())
    assert digest.hexdigest() == expected["output_ct_sha256"]
    rms = float(np.sqrt(np.mean((vm.getOutput()[0][:10] - mlp_plain(x, gen_weights())) ** 2)))
    assert rms == pytest.approx(expected["jax_rms"], rel=1e-9)
