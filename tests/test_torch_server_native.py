"""A server HEVM of the port (no secret key) serves a program with a native
bootstrap, on the CPU: the deep circuit of tests/test_torch_executor_native.py
(compiled by the JAX package for test_boot with 40 Q primes, the bootstrap
configuration of tests/test_bootstrap.py), after a full VM has run it once on
the client's blob, which makes and persists the bootstrap's rotation keys
and conjugation key. The server loads that keyset without the secret, runs
the same blob, makes no key, and ships an output blob equal byte for byte to
the full VM's; the client decrypts it to the plaintext model."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dacapo_tpu_torch.crypto import params
from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig, NativeBootstrapper
from dacapo_tpu_torch.runtime import runner
from dacapo_tpu_torch.runtime.runner import HEVM
from test_torch_executor_native import CFG, DEPTH, PROFILE, WIDER, _script, compile_test_boot

RMS_BAR = 1e-3      # tests/test_torch_executor_native.py's


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server_native")
    _, _, hv, cst = compile_test_boot(tmp)
    kd = str(tmp / "keys")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(params.PROFILES, PROFILE,
                   dataclasses.replace(params.PROFILES[PROFILE], **WIDER))
        mp.setattr(runner, "BootstrapConfig",
                   lambda radix: BootstrapConfig(radix=radix, **CFG))
        mp.setenv("DACAPO_TPU_BOOT", "native")
        full = HEVM(PROFILE, keyset_dir=kd, device="cpu")
        full.load(cst, hv)
        client = HEVM(PROFILE, keyset_dir=kd, device="cpu", mode="client")
        client.loadClient(hv)
        x = np.random.default_rng(0).uniform(0.5, 0.55, client.scheme.ctx.config.n_slots)
        client.setInput(0, x)
        blob = client.getCtxt(0)
        full.setCtxt(0, blob)
        full.run()                       # makes and persists the bootstrap's keys
        full_out = full.getOutputCtxt(0)
        files = sorted(os.listdir(os.path.join(kd, "galois"))) + sorted(os.listdir(kd))
        server = HEVM(PROFILE, keyset_dir=kd, device="cpu", mode="server")
        n_keys = len(server.scheme.keys.galois)
        server.load(cst, hv)
        server.setCtxt(0, blob)
        assert server.run() is None
        out = dict(server=server, full=full, client=client, x=x, n_keys=n_keys,
                   files=files, kd=kd, full_out=full_out,
                   server_out=server.getOutputCtxt(0))
    torch.set_num_threads(n)
    return out


def test_server_has_no_secret_and_makes_no_key(served):
    server = served["server"]
    assert server.scheme.keys.s_ntt is None
    assert isinstance(server.executor.bootstrapper, NativeBootstrapper)
    assert server.executor.bootstrapper.calls == 1
    assert server.scheme.keys.conj is not None
    assert len(server.scheme.keys.galois) == served["n_keys"]
    kd = served["kd"]
    assert sorted(os.listdir(os.path.join(kd, "galois"))) + sorted(os.listdir(kd)) \
        == served["files"]


def test_server_output_equals_full_vm(served):
    assert served["server_out"] == served["full_out"]


def test_client_decrypts_the_plaintext_model(served):
    got = served["client"].decrypt_result(served["server_out"])
    want = _script().deep_golden(served["x"], DEPTH)
    rms = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rms < RMS_BAR, rms
