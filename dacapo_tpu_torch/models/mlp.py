"""MLP benchmark model, numpy parts: 784 -> 100 (square activation) -> 10.

Copy of the weight generator, golden model and input maker of
dacapo_tpu/models/mlp.py (the traced forward pass stays with the compiler).
"""

import numpy as np


def gen_weights(seed=1234):
    rng = np.random.default_rng(seed)
    return {
        "W1": rng.normal(0, 0.05, (100, 784)),
        "b1": rng.normal(0, 0.05, 100),
        "W2": rng.normal(0, 0.1, (10, 100)),
        "b2": rng.normal(0, 0.1, 10),
    }


def mlp_plain(x, weights):
    """Numpy golden model (reference examples/tests/MLP.py process())."""
    w = weights
    h = w["W1"] @ x[:784] + w["b1"]
    h = h * h
    return w["W2"] @ h + w["b2"]


def make_input(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.0, 1.0, 784), np.zeros(16)])
