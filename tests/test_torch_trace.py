"""The port's tracer (ir/, passes/rewrite.py, poly/, models/) against the JAX
package's: the same programs traced by both write byte-identical .cst files
and .eir.json files that differ only in the source directory of each op's
recorded location (dacapo_tpu_torch/ for dacapo_tpu/; the line numbers are
equal). The SiLU series is the one fit both use (the port's committed
coefficients). The port's MPCB ResNet forward also runs on plain numpy
vectors against the torch model."""

import os

import numpy as np
import pytest
import torch

import dacapo_tpu
import dacapo_tpu_torch
from dacapo_tpu.ir import trace as ref_trace
from dacapo_tpu.models import cnn_he as ref_cnn, mlp as ref_mlp, resnet as ref_resnet
from dacapo_tpu.poly import activations as ref_act, hefunc as ref_he, mpcb as ref_mpcb
from dacapo_tpu_torch.ir import trace as port_trace
from dacapo_tpu_torch.ir.serialize import load_function
from dacapo_tpu_torch.models import cnn_he, mlp, resnet
from dacapo_tpu_torch.poly import activations, hefunc

PORT_DIR = os.path.dirname(os.path.abspath(dacapo_tpu_torch.__file__)) + os.sep
REF_DIR = os.path.dirname(os.path.abspath(dacapo_tpu.__file__)) + os.sep
MLP_CST = os.path.join(PORT_DIR, "artifacts", "mlp_pars40_tpu_n15", "MLP.cst")


@pytest.fixture(autouse=True)
def same_silu_fit(monkeypatch):
    """Both tracers use the port's committed SiLU coefficients: chebfit's
    lstsq rounds differently on other LAPACK builds, so the JAX package's
    fit on another machine may differ in the last bit (test below)."""
    coef = activations._silu_coef(32.0, 127)
    monkeypatch.setitem(ref_act._silu_polys, (16, 32.0, 127),
                        ref_mpcb.gen_poly_from_cheb(coef, 16))


def test_silu_cache_is_the_fit():
    coef = activations._silu_coef(32.0, 127)
    np.testing.assert_allclose(coef, activations.silu_fit(32.0, 127), rtol=0, atol=1e-14)
    assert not coef[::2].any() and np.abs(coef).max() > 0.1


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _trace(trace_mod, name, body, out):
    trace_mod._module.reset()
    body.__name__ = name
    trace_mod.func("c")(body)
    trace_mod.save(out, out)
    return _read(os.path.join(out, f"{name}.eir.json")), \
        _read(os.path.join(out, f"_hecate_{name}.cst"))


def _assert_same_trace(tmp_path, name, ref_body, port_body):
    ref_eir, ref_cst = _trace(ref_trace, name, ref_body, str(tmp_path / "jax"))
    port_eir, port_cst = _trace(port_trace, name, port_body, str(tmp_path / "port"))
    assert port_cst == ref_cst
    assert PORT_DIR.encode() in port_eir
    assert port_eir.replace(PORT_DIR.encode(), REF_DIR.encode()) == ref_eir
    fn = load_function(str(tmp_path / "port" / f"{name}.eir.json"))
    assert fn.name == name and len(fn.args) == 1
    return port_cst


def test_mlp_trace_identical(tmp_path):
    w = mlp.gen_weights()
    cst = _assert_same_trace(tmp_path, "MLP", lambda x: ref_mlp.mlp_forward(x, w),
                             lambda x: mlp.mlp_forward(x, w))
    assert cst == _read(MLP_CST)          # the committed artifact's constants


def _poly_body(he, act):
    """SiLU (degree-127 BSGS), composite-sign ReLU (with its bootstrap) and a
    polynomial max, over one package's poly/ modules."""
    return lambda x: act.maxx(he.HE_ReLU(he.HE_SiLU(x)), x * 0.3)


def test_polynomial_activation_trace_identical(tmp_path):
    _assert_same_trace(tmp_path, "Act", _poly_body(ref_he, ref_act),
                       _poly_body(hefunc, activations))


def test_resnet_trace_identical(tmp_path):
    """Randomized ResNet-20 at nt=2^10 on 8x8 inputs: the full graph (19
    bootstraps), with multi-ciphertext packing in place of the 32x32 one."""
    model = ref_resnet.randomize(ref_resnet.resnet20(), seed=3).double()
    kw = dict(nt=2 ** 10, bb=16, h0=8, w0=8)
    _assert_same_trace(tmp_path, "ResNet",
                       lambda x: ref_cnn.resnet_he_forward(x, model, **kw),
                       lambda x: cnn_he.resnet_he_forward(x, model, **kw))
    cnn_he.trace_resnet(str(tmp_path / "entry"), model, **kw)
    assert _read(str(tmp_path / "entry" / "_hecate_ResNet.cst")) == \
        _read(str(tmp_path / "jax" / "_hecate_ResNet.cst"))
    fn = load_function(str(tmp_path / "entry" / "ResNet.eir.json"))
    assert sum(op.opcode == "bootstrap" for op in fn.ops) == 19


def test_resnet_numpy_forward_matches_torch():
    """The port's MPCB ResNet-20 on plain vectors (use_bootstrap=False; SiLU
    by the HE path's polynomial) against the torch model, as
    tests/test_mpcb_cnn.py does for the JAX package's."""
    nt, bb = 2 ** 14, 32
    model = resnet.randomize(resnet.resnet20(), seed=5).double()
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(6))
    packed = cnn_he.resnet_pack_input(x.numpy(), model, nt=nt, bb=bb)
    out = cnn_he.resnet_he_forward(packed, model, nt=nt, bb=bb, use_bootstrap=False)
    got = cnn_he.resnet_postprocess(out, out_dim=10, bb=bb)
    with torch.no_grad():
        want = model(x).numpy().ravel()
    assert np.max(np.abs(want)) > 1e-3          # non-degenerate logits
    rms = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rms < 5e-3 * max(1.0, np.max(np.abs(want))), (got, want)


def test_get_model_loads_the_checkpoint():
    ckpt = os.path.join(os.path.dirname(PORT_DIR.rstrip(os.sep)), "examples", "data",
                        "resnet20.silu.model")
    model = resnet.get_model(ckpt)
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(100))
    ref = ref_resnet.resnet20()
    sd = torch.load(ckpt, map_location="cpu")["state_dict"]
    ref.load_state_dict({k.removeprefix("module."): v for k, v in sd.items()})
    with torch.no_grad():
        assert torch.equal(model(x), ref.double().eval()(x))
    assert not model.training and next(model.parameters()).dtype == torch.double
