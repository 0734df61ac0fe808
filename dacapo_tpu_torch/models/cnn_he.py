"""HE forward pass of ResNet (MPCB packing) and its trace entry point.

The ResNet part of dacapo_tpu/models/cnn_he.py, copied with its line numbers
kept (traced ops record their source line): `resnet_he_forward` is the body
of the reference benchmark (examples/benchmarks/ResNet.py) over the tracer,
bootstrapping where the reference does. `nt` is the slot count (profile
polynomialDegree/2), so tests run the same graph at toy sizes. `trace_resnet`
writes the traced program and its constants.
"""

import numpy as np

from ..ir import trace as hc
from ..poly.mpcb import (
    CascadeConv, CascadeDS, CascadePool,
    makeClose,
)
from ..poly.hefunc import (
    HE_ConvBN, HE_DS, HE_Pool,
    HE_Linear, HE_SiLU,
    # the other networks of the JAX package's model zoo are not ported
)


def _wrap(ctxt):
    a = np.empty((1,), dtype=object)
    a[0] = ctxt
    return a


# ---------------------------------------------------------------- ResNet
def resnet_he_forward(ctxt, model, nt=2 ** 16, act=HE_SiLU, bb=32,
                      h0=32, w0=32, use_bootstrap=True):
    """ResNet20/32/... (reference examples/benchmarks/ResNet.py:39-136)."""
    bs = hc.bootstrap if use_bootstrap else (lambda x: x)
    out = _wrap(ctxt)
    shapes = {"nt": nt, "bb": bb, "ko": 1, "ho": h0, "wo": w0}
    conv1_shapes = CascadeConv(shapes, model.conv1)
    close = makeClose(conv1_shapes)
    out = HE_ConvBN(close, out, model.conv1, model.bn1)
    out = act(bs(out))
    block_in = conv1_shapes

    for layer in (model.layer1, model.layer2, model.layer3):
        first = layer[0]
        stride = first.conv1.stride[0]
        if stride != 1:
            ds_shapes = CascadeDS(block_in)
            dsout = HE_DS(makeClose(ds_shapes), out)
        else:
            dsout = out
        for i, blk in enumerate(layer):
            if i != 0:
                dsout = out
            c1 = CascadeConv(block_in, blk.conv1)
            out = HE_ConvBN(makeClose(c1), out, blk.conv1, blk.bn1)
            out = act(bs(out))
            c2 = CascadeConv(c1, blk.conv2)
            out = HE_ConvBN(makeClose(c2), out, blk.conv2, blk.bn2)
            out = out + dsout
            out = act(bs(out))
            block_in = c2

    pool_shapes = CascadePool(block_in)
    close = makeClose(pool_shapes)
    out = HE_Pool(close, out)
    out = HE_Linear(close, out, model.linear, scale=float(bb), nt=nt)
    return out[0]


def resnet_pack_input(x, model, nt=2 ** 16, bb=32, h0=32, w0=32):
    """MultParPack of the input image (reference tests/ResNet.py:47-67)."""
    shapes = {"nt": nt, "bb": bb, "ko": 1, "ho": h0, "wo": w0}
    conv1_shapes = CascadeConv(shapes, model.conv1)
    close = makeClose(conv1_shapes)
    return close["MPP"](x)[0]


def resnet_postprocess(res, out_dim=10, bb=32):
    return np.asarray(res).ravel()[:out_dim] * bb



def trace_resnet(out_dir, model, nt=2 ** 14, bb=32, h0=32, w0=32, cst_dir=None):
    """Trace ResNet over `model` and write <out_dir>/ResNet.eir.json and
    <cst_dir or out_dir>/_hecate_ResNet.cst, as examples/benchmarks/
    ResNet.py:trace does through examples/common.py:trace_and_save (the
    trace-time cleanup pipeline runs in trace.save). Returns the .eir.json
    path."""
    hc._module.reset()

    def ResNet(x):
        return resnet_he_forward(x, model, nt=nt, bb=bb, h0=h0, w0=w0)

    hc.func("c")(ResNet)
    return hc.save(out_dir, cst_dir or out_dir)
