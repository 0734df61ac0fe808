"""The deep circuit that exercises bootstrap placement (PyTorch port).

The circuit of tests/test_dacapo.py and scripts/make_native_artifact.py:
y = y * x; y = y + rot(y, 1 + i); y = y * 0.9, `depth` times, over every
slot. Each step burns a level, so the `dacapo` pipeline must place
bootstraps. `trace_deep` writes it as the program "Deep" with the port's
tracer; `deep_golden` is its plaintext model.
"""

import numpy as np

from ..ir import trace as hc
from ..runtime.harness import trace_and_save


def deep_body(n_slots, depth):
    mask = np.full(n_slots, 0.9)

    def body(x):
        y = x
        for i in range(depth):
            y = y * x                      # burn a level each time
            y = y + y.rotate(1 + i)        # SMU-crossing edges
            y = y * hc.Plain(mask)
        return y

    return body


def deep_golden(x, depth):
    y = x.copy()
    for i in range(depth):
        y = y * x
        y = y + np.roll(y, -(1 + i))
        y = y * 0.9
    return y


def trace_deep(dirs, n_slots, depth, cst_dirs=None):
    """Write <dirs>/Deep.eir.json and <cst_dirs or dirs>/_hecate_Deep.cst.
    Returns the .eir.json path."""
    return trace_and_save("Deep", "c", deep_body(n_slots, depth), dirs, cst_dirs)
