"""HE layer wrappers (copy of dacapo_tpu/poly/hefunc.py; reference python/poly/poly/Func.py)."""

import numpy as np

from . import mpcb as MPCB
from . import activations as Poly
from ..ir import trace as hc


def HE_BN(close, mpp, bn, scale=1.0):
    g, h = MPCB.abstractBN(bn)
    return close["BN"](mpp, g, h)


def HE_MPBN(mpp, bn, scale=1.0, nt=2 ** 16):
    g, h = MPCB.abstractBN(bn)
    return MPCB.BN(mpp, g, h / scale, nt)


def HE_Conv(close, mpp, conv):
    return close["MPC"](mpp, conv.weight, conv.bias)


def HE_ConvBN(close, mpp, conv, bn):
    return close["MPCB"](mpp, conv.weight, *MPCB.abstractBN(bn))


def _poly_maximum(a, b):
    out = Poly.maxx(a, b)
    return hc.bootstrap(out)


def HE_Max(close, mpp):
    MPCB.maximum = _poly_maximum
    return close["MP"](mpp)


def HE_MaxPad(close, mpp):
    MPCB.maximum = _poly_maximum
    return close["MPD"](mpp)


def HE_Avg(close, mpp):
    return close["MA"](mpp)


def HE_DS(close, mpp):
    return close["DS"](mpp)


def HE_Pool(close, mpp):
    return close["AP"](mpp)


def _bias_of(linear, scale):
    if linear.bias is None:
        import numpy as np
        return np.zeros(linear.weight.shape[0])
    return MPCB._np(linear.bias) / scale


def HE_Linear(close, mpp, linear, p=1.0, scale=1.0, nt=2 ** 16):
    return MPCB.Linear(mpp, MPCB._np(linear.weight) * p,
                       _bias_of(linear, scale), nt)


def HE_ReshapeLinear(close, mpp, linear, p=1.0, scale=1.0, reshape={}, nt=2 ** 16):
    w = MPCB.Reshape(linear.weight, reshape)
    return MPCB.Linear(mpp, w * p, _bias_of(linear, scale), nt)


def HE_DwConv(close, mpp, conv, bn):
    g, h = MPCB.abstractBN(bn)
    if conv.bias is not None:
        # conv bias passes through BN's linear fold: y = G*(x+b)+H
        h = h + g * MPCB._np(conv.bias)
    return close["DW"](mpp, conv.weight, g, h)


def HE_Concat(close, mpp_1, mpp_2):
    return close["CC"](mpp_1, mpp_2)


def HE_ReLU(x):
    def sgn(v):
        out = Poly.poly2(Poly.poly1(v))
        out = hc.bootstrap(out)
        return Poly.poly3(out)
    return (0.5 + sgn(x)) * x


def HE_SiLU(x):
    calc = Poly.GenPoly()
    return x * (calc(x) + 0.5)
