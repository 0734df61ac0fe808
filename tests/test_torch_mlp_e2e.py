"""The whole slice on the CPU: MLP compiled by the JAX package's compiler
(pars, waterline 25, test_n11), run by the JAX executor (per-op path) and by
the port's HEVM through load/setInput/run/getOutput. Same seed, so the output
ciphertexts are bit-equal."""

import numpy as np
import pytest
import torch

import dacapo_tpu as hc
from dacapo_tpu.crypto.params import COMPILER_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.ir import trace as trace_mod
from dacapo_tpu.ir.config import load_profile
from dacapo_tpu.ir.serialize import write_cst
from dacapo_tpu.models.mlp import mlp_forward, gen_weights
from dacapo_tpu.passes.pipeline import compile_function
from dacapo_tpu.passes.rewrite import cse, canonicalize, elide_constants, privatize_constants
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch import HEVM
from dacapo_tpu_torch.models.mlp import mlp_plain, make_input

PROFILE = "test_n11"


def compile_mlp(tmp):
    """The MLP traced and compiled by the JAX package (pars, waterline 25,
    test_n11), written to tmp/MLP.hevm and tmp/MLP.cst. Returns
    (prog, payloads, weights, hevm_path, cst_path)."""
    load_profile(COMPILER_PROFILES[PROFILE])
    weights = gen_weights()
    trace_mod._module.reset()
    fn = hc.func("c")(lambda image: mlp_forward(image, weights)).eval()
    fn.name = "MLP"
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    privatize_constants(fn)
    canonicalize(fn)
    prog = compile_function(fn, "pars", 25)
    hevm_path, cst_path = str(tmp / "MLP.hevm"), str(tmp / "MLP.cst")
    prog._save_py(hevm_path)
    write_cst(payloads, cst_path)
    return prog, payloads, weights, hevm_path, cst_path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlp")
    prog, payloads, weights, hevm_path, cst_path = compile_mlp(tmp)

    x = make_input(0)
    s = RefScheme(PROFILE)
    s.generate_keys()
    ex = RefExecutor(s, prog, payloads)
    ex.preprocess()
    ref_out = ex.run([x], jit=False)
    ref_cts = [np.asarray(c) for c in ex._last_outputs[0]]

    vm = HEVM(PROFILE, keyset_dir=str(tmp / "keys"), device="cpu")
    vm.load(cst_path, hevm_path)
    vm.setInput(0, x)
    vm.run()
    port_cts = [c.numpy().view(np.uint32) for c in vm.executor._last_outputs[0]]
    return dict(x=x, weights=weights, ref_out=ref_out, ref_cts=ref_cts,
                port_out=vm.getOutput(), port_cts=port_cts, vm=vm)


def test_output_ciphertexts_bit_equal(runs):
    assert len(runs["port_cts"]) == len(runs["ref_cts"]) == 1
    for got, want in zip(runs["port_cts"], runs["ref_cts"]):
        np.testing.assert_array_equal(got, want)


def test_decrypted_outputs_equal(runs):
    np.testing.assert_array_equal(runs["port_out"], runs["ref_out"])


def test_rms_against_plain_model(runs):
    want = mlp_plain(runs["x"], runs["weights"])
    rms = float(np.sqrt(np.mean((runs["port_out"][0][:10] - want) ** 2)))
    assert rms < 5e-3, rms


def test_second_request_and_transport(runs):
    from dacapo_tpu.runtime.runner import deserialize_ct as ref_deserialize
    vm = runs["vm"]
    x = make_input(1)
    vm.setInput(0, x)
    vm.run()
    want = mlp_plain(x, runs["weights"])
    assert float(np.sqrt(np.mean((vm.getOutput()[0][:10] - want) ** 2))) < 5e-3
    from dacapo_tpu_torch.runtime.runner import deserialize_ct
    blob = vm.getOutputCtxt(0)
    want = vm.executor._last_outputs[0][0]
    data, nl, scale = ref_deserialize(blob)
    np.testing.assert_array_equal(np.asarray(data), want.numpy().view(np.uint32))
    assert (nl, scale) == tuple(vm.executor._last_outputs[1][0])
    got, nl2, scale2 = deserialize_ct(blob, "cpu")
    assert torch.equal(got, want) and (nl2, scale2) == (nl, scale)


def test_load_seconds(runs):
    parts = runs["vm"].load_seconds
    assert list(parts) == ["read", "galois_keygen", "preencode", "keyset_write"]
    assert all(v >= 0 for v in parts.values())
