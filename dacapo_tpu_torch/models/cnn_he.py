"""HE forward-pass builders for the CNN model zoo (MPCB packing).

A copy of dacapo_tpu/models/cnn_he.py, its line numbers kept (traced ops
record their source line): each `*_he_forward(ctxt, model, nt)` is the body
of the reference benchmark (examples/benchmarks/<Name>.py) over the port's
tracer, bootstrapping where the reference does; `nt` is the slot count, so
tests run the same graph at toy sizes. `trace_resnet`, after the copied
part, writes ResNet's traced program and its constants.
"""

import numpy as np

from ..ir import trace as hc
from ..poly.mpcb import (
    CascadeConv, CascadeDS, CascadePool, CascadeMax, CascadeConcat,
    makeClose, InferShapes,
)
from ..poly.hefunc import (
    HE_ConvBN, HE_Conv, HE_DS, HE_Pool, HE_Avg, HE_Max, HE_MaxPad,
    HE_Linear, HE_ReshapeLinear, HE_DwConv, HE_Concat, HE_SiLU, HE_ReLU,
    HE_BN, HE_MPBN,
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


def cnn_pack_input(x, first_conv, nt=2 ** 16, bb=32, h0=32, w0=32):
    """MultParPack of an input image given the model's first conv (generic
    version of resnet_pack_input for the wider zoo; reference
    tests/{AlexNet,VGG16,...}.py input packing)."""
    shapes = {"nt": nt, "bb": bb, "ko": 1, "ho": h0, "wo": w0}
    close = makeClose(CascadeConv(shapes, first_conv))
    return close["MPP"](x)[0]


# ---------------------------------------------------------------- LeNet
def lenet_he_forward(ctxt, model, nt=2 ** 14, bb=32):
    """LeNet-5-class CNN with square activations (reference
    python/poly/poly/models/Lenet.py CNNClassifier; padded convs + avgpools
    folded into the MPCB shapes)."""
    out = _wrap(ctxt)
    shapes = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}
    c1 = CascadeConv(shapes, model.conv1)
    close1 = makeClose(c1)
    out = HE_ConvBN(close1, out, model.conv1, model.bn1)
    out = out * out
    p1 = CascadeMax(c1, model.pool1)
    out = HE_Avg(makeClose(p1), out)

    c2 = CascadeConv(p1, model.conv2)
    close2 = makeClose(c2)
    out = HE_ConvBN(close2, out, model.conv2, model.bn2)
    out = out * out
    p2 = CascadeMax(c2, model.pool2)
    out = HE_Avg(makeClose(p2), out)
    return out, p2


# ---------------------------------------------------------------- AlexNet
def alexnet_he_forward(ctxt, model, nt=2 ** 16, act=HE_SiLU, bb=32,
                       use_bootstrap=True):
    """AlexNet (reference examples/benchmarks/AlexNet.py): 5 ConvBN+SiLU
    stages with stride-2 mid pools, then 3 dense layers."""
    bs = hc.bootstrap if use_bootstrap else (lambda x: x)
    out = _wrap(ctxt)
    shapes = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}

    c1 = CascadeConv(shapes, model.Conv2d_1)
    out = HE_ConvBN(makeClose(c1), out, model.Conv2d_1, model.bn_1)
    out = act(bs(out))
    p1 = CascadeMax(c1, model.avgpool_1)
    out = HE_Avg(makeClose(p1), out)

    c2 = CascadeConv(p1, model.Conv2d_2)
    out = HE_ConvBN(makeClose(c2), out, model.Conv2d_2, model.bn_2)
    out = act(bs(out))
    p2 = CascadeMax(c2, model.avgpool_2)
    out = HE_Avg(makeClose(p2), out)

    c3 = CascadeConv(p2, model.Conv2d_3)
    out = HE_ConvBN(makeClose(c3), out, model.Conv2d_3, model.bn_3)
    out = act(bs(out))
    c4 = CascadeConv(c3, model.Conv2d_4)
    out = HE_ConvBN(makeClose(c4), out, model.Conv2d_4, model.bn_4)
    out = act(bs(out))
    c5 = CascadeConv(c4, model.Conv2d_5)
    out = HE_ConvBN(makeClose(c5), out, model.Conv2d_5, model.bn_5)
    out = act(bs(out))
    p3 = CascadeMax(c5, model.avgpool_3)
    out = HE_Avg(makeClose(p3), out)

    out = HE_ReshapeLinear(None, out, model.fc_1, scale=float(bb),
                           reshape=p3, nt=nt)
    out = act(bs(out))
    out = HE_Linear(None, out, model.fc_2, scale=float(bb), nt=nt)
    out = act(bs(out))
    out = HE_Linear(None, out, model.fc_3, scale=float(bb), nt=nt)
    return out[0]


# ------------------------------------------------------------------ VGG16
def vgg16_he_forward(ctxt, model, nt=2 ** 16, act=HE_SiLU, bb=32,
                     use_bootstrap=True):
    """VGG16 (reference examples/benchmarks/VGG16.py): 13 ConvBN+SiLU
    blocks, 5 avg pools, 3 dense layers with a 1D BN on fc_2."""
    bs = hc.bootstrap if use_bootstrap else (lambda x: x)
    out = _wrap(ctxt)
    block_in = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}

    convs = [
        [model.conv_1_1, model.conv_1_2],
        [model.conv_2_1, model.conv_2_2],
        [model.conv_3_1, model.conv_3_2, model.conv_3_3],
        [model.conv_4_1, model.conv_4_2, model.conv_4_3],
        [model.conv_5_1, model.conv_5_2, model.conv_5_3],
    ]
    pools = [model.avgpool_1, model.avgpool_2, model.avgpool_3,
             model.avgpool_4, model.avgpool_5]
    for blocks, pool in zip(convs, pools):
        for blk in blocks:
            cs = CascadeConv(block_in, blk.Conv2d)
            out = HE_ConvBN(makeClose(cs), out, blk.Conv2d, blk.bn)
            out = act(bs(out))
            block_in = cs
        ps = CascadeMax(block_in, pool)
        out = HE_Avg(makeClose(ps), out)
        out = bs(out)
        block_in = ps

    out = HE_Linear(None, out, model.fc_1, scale=float(bb), nt=nt)
    out = act(bs(out))
    out = HE_Linear(None, out, model.fc_2, scale=float(bb), nt=nt)
    out = HE_MPBN(out, model.bn_1, scale=float(bb), nt=nt)
    out = act(bs(out))
    out = HE_Linear(None, out, model.fc_3, scale=float(bb), nt=nt)
    return out[0]


# -------------------------------------------------------------- SqueezeNet
def squeezenet_he_forward(ctxt, model, nt=2 ** 16, act=HE_SiLU, bb=32,
                          use_bootstrap=True):
    """SqueezeNet (reference examples/benchmarks/SqueezeNet.py): Fire
    modules = squeeze ConvBN+SiLU then parallel 1x1/3x3 expands + Concat."""
    bs = hc.bootstrap if use_bootstrap else (lambda x: x)
    out = _wrap(ctxt)
    block_in = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}

    cs = CascadeConv(block_in, model.conv_1.Conv2d)
    out = HE_ConvBN(makeClose(cs), out, model.conv_1.Conv2d, model.conv_1.bn)
    out = act(bs(out))
    block_in = cs
    ps = CascadeMax(block_in, model.avgpool_1)
    out = HE_Avg(makeClose(ps), out)
    block_in = ps

    def fire(out, block_in, f):
        sq = CascadeConv(block_in, f.squeeze.Conv2d)
        out = HE_ConvBN(makeClose(sq), bs(out), f.squeeze.Conv2d, f.squeeze.bn)
        out = act(bs(out))
        e1 = CascadeConv(sq, f.expand1x1)
        out1 = HE_Conv(makeClose(e1), out, f.expand1x1)
        e3 = CascadeConv(sq, f.expand3x3)
        out2 = HE_Conv(makeClose(e3), out, f.expand3x3)
        cc = CascadeConcat(e1, e3)
        return HE_Concat(makeClose(cc), out1, out2), cc

    out, block_in = fire(out, block_in, model.fire_2)
    out, block_in = fire(out, block_in, model.fire_3)
    out, block_in = fire(out, block_in, model.fire_4)
    ps = CascadeMax(block_in, model.avgpool_4)
    out = HE_Avg(makeClose(ps), out)
    block_in = ps
    out, block_in = fire(out, block_in, model.fire_5)
    out, block_in = fire(out, block_in, model.fire_6)
    out, block_in = fire(out, block_in, model.fire_7)
    out, block_in = fire(out, block_in, model.fire_8)
    ps = CascadeMax(block_in, model.avgpool_8)
    out = HE_Avg(makeClose(ps), out)
    block_in = ps
    out, block_in = fire(out, block_in, model.fire_9)

    c10 = CascadeConv(block_in, model.conv_10.Conv2d)
    out = HE_ConvBN(makeClose(c10), bs(out), model.conv_10.Conv2d,
                    model.conv_10.bn)
    out = act(bs(out))
    pool = CascadePool(c10)
    out = HE_Pool(makeClose(pool), out)
    return out[0]


# --------------------------------------------------------------- MobileNet
def mobilenet_he_forward(ctxt, model, nt=2 ** 16, act=HE_SiLU, bb=32,
                         use_bootstrap=True):
    """MobileNetV1 (reference examples/benchmarks/MobileNet.py): depthwise
    ConvBN + SiLU then pointwise ConvBN + SiLU, 13 blocks."""
    bs = hc.bootstrap if use_bootstrap else (lambda x: x)
    out = _wrap(ctxt)
    block_in = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}

    cs = CascadeConv(block_in, model.pre_layer.Conv2d)
    out = HE_ConvBN(makeClose(cs), out, model.pre_layer.Conv2d,
                    model.pre_layer.bn)
    out = act(bs(out))
    block_in = cs

    for blk in model.layers:
        dw = CascadeConv(block_in, blk.dwConv2d)
        out = HE_DwConv(makeClose(dw), out, blk.dwConv2d, blk.bn)
        out = act(bs(out))
        pw = CascadeConv(dw, blk.pointwiseConv2d.Conv2d)
        out = HE_ConvBN(makeClose(pw), out, blk.pointwiseConv2d.Conv2d,
                        blk.pointwiseConv2d.bn)
        out = act(bs(out))
        block_in = pw

    pool = CascadePool(block_in)
    close = makeClose(pool)
    out = HE_Pool(close, out)
    out = HE_Linear(close, out, model.linear, scale=float(bb), nt=nt)
    return out[0]


# ------------------------------------------------------------------ LeNet
def lenet_he_full_forward(ctxt, model, nt=2 ** 14, bb=1):
    """LeNet-5 with square activations end-to-end (shapes per
    models/zoo.LeNet). bb=1 because the square activations change the value
    scale regime: with bb=1 the HE output equals the torch forward exactly
    (BN keeps intermediates bounded)."""
    out = _wrap(ctxt)
    block_in = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}
    c1 = CascadeConv(block_in, model.conv1)
    out = HE_ConvBN(makeClose(c1), out, model.conv1, model.bn1)
    out = out * out
    p1 = CascadeMax(c1, model.pool1)
    out = HE_Avg(makeClose(p1), out)

    c2 = CascadeConv(p1, model.conv2)
    out = HE_ConvBN(makeClose(c2), out, model.conv2, model.bn2)
    out = out * out
    p2 = CascadeMax(c2, model.pool2)
    out = HE_Avg(makeClose(p2), out)

    out = HE_ReshapeLinear(None, out, model.fc1, scale=float(bb),
                           reshape=p2, nt=nt)
    out = HE_MPBN(out, model.bn3, scale=float(bb), nt=nt)
    out = out * out
    out = HE_Linear(None, out, model.fc2, scale=float(bb), nt=nt)
    out = HE_MPBN(out, model.bn4, scale=float(bb), nt=nt)
    out = out * out
    out = HE_Linear(None, out, model.fc3, scale=float(bb), nt=nt)
    out = HE_MPBN(out, model.bn5, scale=float(bb), nt=nt)
    return out[0]


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


def squeezenet_prefix_he_forward(ctxt, model, fires=1, nt=2 ** 16, act=HE_SiLU, bb=32,
                                 use_bootstrap=True):
    """The first part of squeezenet_he_forward at full width: conv_1 (ConvBN
    + SiLU), avgpool_1 and the first `fires` Fire modules (fire_2, fire_3,
    fire_4), traced op for op as there. Returns every ciphertext of the
    last Fire module's concatenation, its channels packed as the shapes
    squeezenet_prefix_shapes gives (their OutPack). chip_smoke.py serves
    this prefix; scripts/torch_squeezenet_native.py the whole network."""
    bs = hc.bootstrap if use_bootstrap else (lambda x: x)
    out = _wrap(ctxt)
    block_in = {"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32}

    cs = CascadeConv(block_in, model.conv_1.Conv2d)
    out = HE_ConvBN(makeClose(cs), out, model.conv_1.Conv2d, model.conv_1.bn)
    out = act(bs(out))
    block_in = cs
    ps = CascadeMax(block_in, model.avgpool_1)
    out = HE_Avg(makeClose(ps), out)
    block_in = ps

    for f in (model.fire_2, model.fire_3, model.fire_4)[:fires]:
        sq = CascadeConv(block_in, f.squeeze.Conv2d)
        out = HE_ConvBN(makeClose(sq), bs(out), f.squeeze.Conv2d, f.squeeze.bn)
        out = act(bs(out))
        e1 = CascadeConv(sq, f.expand1x1)
        out1 = HE_Conv(makeClose(e1), out, f.expand1x1)
        e3 = CascadeConv(sq, f.expand3x3)
        out2 = HE_Conv(makeClose(e3), out, f.expand3x3)
        block_in = CascadeConcat(e1, e3)
        out = HE_Concat(makeClose(block_in), out1, out2)
    return list(out)


def squeezenet_prefix_shapes(model, fires=1, nt=2 ** 16, bb=32):
    """The MPCB shapes of squeezenet_prefix_he_forward's output (the last
    Fire module's concatenation)."""
    block_in = CascadeMax(CascadeConv({"nt": nt, "bb": bb, "ko": 1, "ho": 32, "wo": 32},
                                      model.conv_1.Conv2d), model.avgpool_1)
    for f in (model.fire_2, model.fire_3, model.fire_4)[:fires]:
        sq = CascadeConv(block_in, f.squeeze.Conv2d)
        block_in = CascadeConcat(CascadeConv(sq, f.expand1x1), CascadeConv(sq, f.expand3x3))
    return block_in


def squeezenet_prefix_torch(x, model, fires=1):
    """The torch model's activations where squeezenet_prefix_he_forward
    stops: conv_1, avgpool_1, the first `fires` Fire modules."""
    out = model.avgpool_1(model.conv_1(x))
    for f in (model.fire_2, model.fire_3, model.fire_4)[:fires]:
        out = f(out)
    return out
