"""The port's model zoo (dacapo_tpu_torch/models/zoo.py) and the rest of its
cnn_he.py against the JAX package's: the same torch models (the same seeds)
through the four MPCB forwards of tests/test_zoo_numpy_forward.py and
lenet_he_full_forward on plain numpy vectors give equal outputs, within the
JAX tests' bars of the torch model; LeNet's trace (lenet_he_forward) writes
byte-identical .cst and .eir.json files (source directories mapped, as
tests/test_torch_trace.py holds ResNet's)."""

import numpy as np
import pytest
import torch

from dacapo_tpu.models import cnn_he as ref_cnn, zoo as ref_zoo
from dacapo_tpu_torch.models import cnn_he, zoo
from dacapo_tpu_torch.poly.mpcb import CascadeConv, makeClose
from test_torch_trace import _assert_same_trace, same_silu_fit  # noqa: F401

CASES = {
    "alexnet": ("alexnet_he_forward", "Conv2d_1"),
    "vgg16": ("vgg16_he_forward", "conv_1_1.Conv2d"),
    "squeezenet": ("squeezenet_he_forward", "conv_1.Conv2d"),
    "mobilenet": ("mobilenet_he_forward", "pre_layer.Conv2d"),
}


def rms(a, b):
    d = np.asarray(a, np.float64).ravel() - np.asarray(b, np.float64).ravel()
    return float(np.sqrt(np.mean(d * d)))


def _models(name, **kw):
    port = zoo.randomize(getattr(zoo, name)(), seed=5, **kw).double()
    ref = ref_zoo.randomize(getattr(ref_zoo, name)(), seed=5, **kw).double()
    sd, ref_sd = port.state_dict(), ref.state_dict()
    assert sd.keys() == ref_sd.keys()
    assert all(torch.equal(sd[k], ref_sd[k]) for k in sd)
    return port


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_forward_equals_jax_package(name):
    fwd, first_conv = CASES[name]
    nt, bb = 2 ** 14, 32
    model = _models(name)
    x = torch.randn(1, 3, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(6))
    first = model
    for part in first_conv.split("."):
        first = getattr(first, part)
    packed = cnn_he.cnn_pack_input(x.numpy(), first, nt=nt, bb=bb)
    np.testing.assert_array_equal(packed, ref_cnn.cnn_pack_input(x.numpy(), first, nt=nt, bb=bb))
    out = getattr(cnn_he, fwd)(packed, model, nt=nt, bb=bb, use_bootstrap=False)
    ref_out = getattr(ref_cnn, fwd)(packed, model, nt=nt, bb=bb, use_bootstrap=False)
    got = cnn_he.resnet_postprocess(out, out_dim=10, bb=bb)
    np.testing.assert_array_equal(got, ref_cnn.resnet_postprocess(ref_out, out_dim=10, bb=bb))
    with torch.no_grad():
        want = model(x).numpy().ravel()
    assert np.max(np.abs(want)) > 1e-3
    assert rms(got, want) < 5e-3 * max(1.0, np.max(np.abs(want))), (got, want)


def _lenet_input(model, nt):
    x = torch.randn(1, 1, 32, 32, dtype=torch.double,
                    generator=torch.Generator().manual_seed(6))
    shapes = {"nt": nt, "bb": 1, "ko": 1, "ho": 32, "wo": 32}
    return x, makeClose(CascadeConv(shapes, model.conv1))["MPP"](x.numpy())[0]


def test_lenet_full_forward_equals_jax_package():
    nt = 2 ** 12
    model = _models("lenet", calib_shape=(1, 32, 32))
    x, packed = _lenet_input(model, nt)
    got = cnn_he.lenet_he_full_forward(packed, model, nt=nt, bb=1)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(ref_cnn.lenet_he_full_forward(packed, model,
                                                                           nt=nt, bb=1)))
    with torch.no_grad():
        want = model(x).numpy().ravel()
    assert rms(np.asarray(got)[:10], want) < 1e-9


def test_lenet_trace_identical(tmp_path):
    model = _models("lenet", calib_shape=(1, 32, 32))
    kw = dict(nt=2 ** 12, bb=1)
    _assert_same_trace(tmp_path, "LeNet",
                       lambda x: list(ref_cnn.lenet_he_forward(x, model, **kw)[0]),
                       lambda x: list(cnn_he.lenet_he_forward(x, model, **kw)[0]))
