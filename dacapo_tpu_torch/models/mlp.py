"""MLP benchmark model: 784 -> 100 (square) -> 10 (copy of dacapo_tpu/models/mlp.py).

Mirrors examples/benchmarks/MLP.py + examples/tests/MLP.py of the reference
(rotation/diagonal packed matvec with log-tree slot reduction), with locally
generated weights instead of the reference's pretrained mlp.model checkpoint.
"""

import numpy as np

from ..ir import trace as hc


def gen_weights(seed=1234):
    rng = np.random.default_rng(seed)
    return {
        "W1": rng.normal(0, 0.05, (100, 784)),
        "b1": rng.normal(0, 0.05, 100),
        "W2": rng.normal(0, 0.1, (10, 100)),
        "b2": rng.normal(0, 0.1, 10),
    }


def _layer1_masks(w1):
    """Rotation-diagonal repack of W1 onto an 800-slot layout
    (examples/benchmarks/MLP.py:17-30 indexing)."""
    masks = np.zeros((100, 800))
    for n in range(100):
        for c in range(8):
            for k in range(100):
                idx = c * 100 + k
                if idx < 784:
                    if idx + n >= 784:
                        masks[n][800 - n + (idx + n) % 784] = \
                            w1[100 - n + (idx + n) % 784][(idx + n) % 784]
                    else:
                        masks[n][idx] = w1[k][(idx + n) % 784]
    return masks


def _layer2_masks(w2):
    masks = np.zeros((10, 100))
    for n in range(10):
        for c in range(10):
            for k in range(10):
                idx = c * 10 + k
                if idx < 100:
                    masks[n][idx] = w2[k][(idx + n) % 100]
    return masks


def mlp_forward(image, weights):
    """Traced encrypted forward pass (the @hc.func body)."""
    w = weights
    m1 = _layer1_masks(w["W1"])
    h = None
    for n in range(100):
        term = image.rotate(n) * hc.Plain(m1[n])
        h = term if h is None else h + term
    span = 800
    for _ in range(3):                      # 800 -> 100 slot fold
        span //= 2
        h = h + h.rotate(span)
    h = h + hc.Plain(list(w["b1"]))
    h = h * h                               # square activation

    m2 = _layer2_masks(w["W2"])
    out = None
    for n in range(10):
        term = h.rotate(n) * hc.Plain(m2[n])
        out = term if out is None else out + term
    out = out + out.rotate(50)
    acc = None
    for i in range(5):
        t = out.rotate(i * 10)
        acc = t if acc is None else acc + t
    return acc + hc.Plain(list(w["b2"]))


def mlp_plain(x, weights):
    """Numpy golden model (examples/tests/MLP.py process())."""
    w = weights
    h = w["W1"] @ x[:784] + w["b1"]
    h = h * h
    return w["W2"] @ h + w["b2"]


def make_input(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.0, 1.0, 784), np.zeros(16)])
