#!/usr/bin/env python3
"""Regenerate dacapo_tpu_torch/artifacts/basic_pars40/expected.json with the
JAX package (on the CPU, a few seconds):

    JAX_PLATFORMS=cpu python3 scripts/make_basic_artifact.py

The five non-MLP rows of the basic benchmark list (docs/BENCH_SWEEP.md):
SobelFilter, HarrisCornerDetection, LinearRegression and Multivariate on
tpu_n14, PolynomialRegression on tpu_n15, each traced by
examples/benchmarks/<Name>.py:trace at the nt of examples/tests/<Name>.py:run
(4096) and compiled by examples/common.py:compile_traced with `pars` at
waterline 40. expected.json records, per row, the SHA-256 of the .hevm and
the .cst, the digest of the .eir.json without source locations
(ir/serialize.py:function_digest) and the program's counts. chip_smoke.py's
basic phase compiles the same rows with the port and holds its files to
these digests; tests/test_torch_kernels_compile.py does it on the CPU.
"""

import hashlib
import importlib
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
ART = os.path.join(REPO, "dacapo_tpu_torch", "artifacts", "basic_pars40")
PIPELINE, WATERLINE, NT = "pars", 40, 4096
ROWS = (("SobelFilter", "tpu_n14"), ("HarrisCornerDetection", "tpu_n14"),
        ("LinearRegression", "tpu_n14"), ("PolynomialRegression", "tpu_n15"),
        ("Multivariate", "tpu_n14"))


def sha256_file(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def eir_digest(path):
    """ir/serialize.py:function_digest (both packages' .eir.json agree on it)."""
    with open(path) as f:
        doc = json.load(f)
    for op in doc["ops"]:
        op["loc"] = None
    return hashlib.sha256(json.dumps(doc).encode()).hexdigest()


def compile_row(name, profile, work):
    """Trace and compile one row with the JAX package in `work`; returns its
    expected.json entry."""
    from examples.common import compile_traced
    from dacapo_tpu.vm.hevm import HEVMProgram
    traced = os.path.join(work, "traced")
    importlib.import_module(f"examples.benchmarks.{name}").trace(dirs=traced, nt=NT)
    hevm = compile_traced(name, PIPELINE, WATERLINE, profile, traced,
                          os.path.join(work, "optimized"))
    prog = HEVMProgram.load(hevm)
    return dict(profile=profile, pipeline=PIPELINE, waterline=WATERLINE, nt=NT,
                args=prog.arg_length, results=prog.res_length,
                instructions=len(prog.ops), rotation_offsets=len(prog.rotation_offsets()),
                hevm_sha256=sha256_file(hevm),
                cst_sha256=sha256_file(os.path.join(traced, f"_hecate_{name}.cst")),
                eir_json_sha256_without_loc=eir_digest(
                    os.path.join(traced, f"{name}.eir.json")))


def main(out_dir=ART):
    sys.path.insert(0, REPO)
    rows = {}
    with tempfile.TemporaryDirectory() as work:
        for name, profile in ROWS:
            rows[name] = compile_row(name, profile, work)
    doc = {"program": "examples/benchmarks/<Name>.py:trace(nt=4096) compiled by "
                      "examples/common.py:compile_traced (pars, waterline 40) with the "
                      "JAX package; scripts/make_basic_artifact.py",
           "rows": rows}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "expected.json"), "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


if __name__ == "__main__":
    print(json.dumps(main(*sys.argv[1:]), indent=1))
