"""The port's command line (dacapo_tpu_torch/cli.py) and the runner's profile
selection, on the CPU: `keygen --device cpu` writes a keyset that a full
HEVM reuses and a server HEVM accepts (the JAX package's keygen writes a
fingerprint the runner rejects: ROADMAP C.4, not copied); `trace` and `opt`
of SobelFilter give the .hevm whose digest
dacapo_tpu_torch/artifacts/basic_pars40/expected.json holds; `test` runs a
basic row end to end (SobelFilter at tpu_n14); setLibnHW/current_profile select the
profile HEVM(profile=None) takes. HOME points into the test's directory, so
the default keyset directory (~/.hevm/torch/<profile>) stays there."""

import hashlib
import json
import os

import pytest

from dacapo_tpu_torch import cli
from dacapo_tpu_torch.runtime import runner
from dacapo_tpu_torch.runtime.runner import HEVM

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "dacapo_tpu_torch", "artifacts", "basic_pars40", "expected.json")


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_keygen_keyset_is_the_runners(home, capsys):
    cli.main(["keygen", "test_n10", "--device", "cpu"])
    d = capsys.readouterr().out.strip().splitlines()[-1]
    assert d == os.path.join(str(home / "home"), ".hevm", "torch", "test_n10")
    with open(os.path.join(d, "params.json")) as f:
        fp = json.load(f)["primes"]
    assert fp.startswith("orbit-v1:")
    before = _files(d)
    full = HEVM("test_n10", device="cpu")                  # the default directory
    assert runner.keyset_fingerprint(full.scheme) == fp
    assert _files(d) == before                             # reused, not regenerated
    server = HEVM("test_n10", device="cpu", mode="server")
    assert server.scheme.keys.s_ntt is None and server.scheme.keys.rlk is not None
    other = str(home / "other")
    cli.main(["keygen", "test_n10", "--dir", other, "--device", "cpu"])
    assert sorted(_files(other)) == sorted(before)


def test_trace_and_opt_give_the_committed_program(home, capsys):
    with open(ART) as f:
        row = json.load(f)["rows"]["SobelFilter"]
    cli.main(["trace", "SobelFilter", "--nt", str(row["nt"]), "--dir", "traced"])
    eir = capsys.readouterr().out.strip().splitlines()[-1]
    assert eir == os.path.join("traced", "SobelFilter.eir.json")
    with open(os.path.join("traced", "_hecate_SobelFilter.cst"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == row["cst_sha256"]
    cli.main(["opt", eir, "-o", "optimized/pars/SobelFilter.40", "--pipeline", "pars",
              "--waterline", "40", "--ckks-config", "profiled_TPU_n14"])
    assert "compiled SobelFilter" in capsys.readouterr().out
    with open("optimized/pars/SobelFilter.40._hecate_SobelFilter.hevm", "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == row["hevm_sha256"]
    assert os.path.exists("optimized/pars/SobelFilter.40.eir.json")


def test_test_runs_a_basic_row(home, capsys):
    cli.main(["test", "SobelFilter", "pars", "40", "tpu_n14", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Profile: tpu_n14 (torch-HEVM cpu, full)" in out
    rms = float(out.split("RMS: ")[1].split()[0])
    assert rms < 2e-5, out
    with open(ART) as f:
        row = json.load(f)["rows"]["SobelFilter"]
    with open("optimized/pars/SobelFilter.40._hecate_SobelFilter.hevm", "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == row["hevm_sha256"]
    assert os.path.exists(os.path.join(str(home / "home"), ".hevm", "torch", "tpu_n14",
                                       "params.json"))


def test_main_entry_points_prepend_their_command(home, capsys):
    cli.main_trace(["LinearRegression", "--nt", "512", "--dir", "t"])
    assert capsys.readouterr().out.strip().endswith(
        os.path.join("t", "LinearRegression.eir.json"))
    cli.main_opt([os.path.join("t", "LinearRegression.eir.json"), "-o", "o/L.40",
                  "--pipeline", "pars", "--ckks-config", "profiled_TPU_test_n11c"])
    assert os.path.exists("o/L.40._hecate_LinearRegression.hevm")


@pytest.mark.parametrize("argv, want", [
    (["prog", "test_n10"], "test_n10"),
    (["prog", "x", "tpu_n14"], "tpu_n14"),
    (["prog", "SEAL", "CPU"], "tpu_n15"),
    (["prog", "HEAAN", "GPU"], "tpu_n16"),
])
def test_setlibnhw_selects_the_profile(argv, want, monkeypatch, tmp_path):
    monkeypatch.setattr(runner, "_selected_profile", "tpu_n15b")
    assert runner.setLibnHW(argv) == want
    assert runner.current_profile() == want
    if want == "test_n10":
        vm = HEVM(keyset_dir=str(tmp_path / "k"), device="cpu")
        assert vm.profile == "test_n10" and vm.scheme.ctx.n == 1 << 10
