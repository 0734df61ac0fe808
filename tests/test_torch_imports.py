"""The port stands alone: importing every module of dacapo_tpu_torch (the
planner, the compile harness, the CLI, the profiler, the model zoo and the
benchmark programs among them), chip_smoke.py and
scripts/torch_ntt_ab.py loads no JAX, nothing of
dacapo_tpu and nothing of examples, and its entry points refuse to run on a
card that is not there."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import dacapo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dacapo_tpu_torch.__path__, "dacapo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
spec = importlib.util.spec_from_file_location("torch_ntt_ab", "scripts/torch_ntt_ab.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "dacapo_tpu", "examples")
             or m.startswith(("jax.", "jaxlib", "dacapo_tpu.", "examples.")))
print(json.dumps([names, bad]))
"""

# the planner and the trace/compile harness, which must stand alone too
PLANNER = ["dacapo_tpu_torch.passes." + m for m in
           ("smu", "scale", "hoist", "estimator", "elasm", "dacapo", "pipeline")] + [
    "dacapo_tpu_torch.vm.lower", "dacapo_tpu_torch.vm.simulate",
    "dacapo_tpu_torch.runtime.harness", "dacapo_tpu_torch.models.deep"]
# the client/server slice: CLI, profiler, basic list, zoo, benchmark programs
SERVING = ["dacapo_tpu_torch.cli", "dacapo_tpu_torch.runtime.profiler",
           "dacapo_tpu_torch.models.kernels", "dacapo_tpu_torch.models.zoo"] + [
    f"dacapo_tpu_torch.examples.{kind}.{name}"
    for kind in ("benchmarks", "tests")
    for name in ("SobelFilter", "HarrisCornerDetection", "LinearRegression",
                 "PolynomialRegression", "Multivariate", "MLP", "ResNet", "AlexNet",
                 "VGG16", "SqueezeNet", "MobileNet")]


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_and_no_reference_package():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    names, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) >= 77
    assert set(PLANNER + SERVING) <= set(names), set(PLANNER + SERVING) - set(names)
    assert bad == [], bad


def test_hevm_default_device_raises_without_cuda():
    proc = _run("import torch\n"
                "assert not torch.cuda.is_available()\n"
                "from dacapo_tpu_torch import HEVM\n"
                "try:\n    HEVM('test_n10', keyset_dir='/nonexistent')\n"
                "except RuntimeError as e:\n    print('raised', e)\n")
    if "AssertionError" in proc.stderr:
        pytest.skip("a card is present: the default device is valid here")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised") and "device='cpu'" in proc.stdout
