"""The port's client/server split (dacapo_tpu_torch/runtime/runner.py, modes
"full", "client", "server"; crypto/keys.py keyset parts and modes) against
the JAX package's, on the CPU at test_n10.

The first three tests mirror tests/test_client_server.py. Then, on one
keyset that a full VM made for the program: the port's server output blob
equals the JAX server's byte for byte for the same client blob; a JAX
client's blob is served by the port and decrypted by the JAX client, and the
reverse; load_keyset's modes read the same arrays as the JAX package's;
extend_galois refuses to make keys without the secret; and a server HEVM
refuses, at load and before any executor exists, an oracle program and a
program whose keys the keyset lacks."""

import dataclasses
import json
import os

import numpy as np
import pytest

from dacapo_tpu.crypto import keys as ref_keys
from dacapo_tpu.runtime.runner import HEVM as RefHEVM
from dacapo_tpu.runtime.runner import serialize_ct as ref_serialize_ct
from dacapo_tpu_torch.crypto import keys, params
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.ir import trace as hc
from dacapo_tpu_torch.runtime import runner
from dacapo_tpu_torch.runtime.harness import compile_traced, trace_and_save
from dacapo_tpu_torch.runtime.runner import HEVM, deserialize_ct, serialize_ct
from dacapo_tpu_torch.vm.hevm import HEVMProgram
from test_torch_executor_native import WIDER, compile_test_boot

PROFILE = "test_n10"
RMS_BAR = 5e-3          # tests/test_client_server.py's


def U(t):
    return to_host(t)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The program of tests/test_client_server.py, traced and compiled by
    the port (pars, waterline 25)."""
    d = str(tmp_path_factory.mktemp("cs"))
    rng = np.random.default_rng(11)
    n = 512  # test_n10 slots
    w = rng.normal(0, 0.5, n)

    def body(x):
        t = x * hc.Plain(w)
        t = t + x.rotate(3)
        return t * t

    trace_and_save("CSBench", "c", body, dirs=d)
    hv = compile_traced("CSBench", "pars", 25, PROFILE, traced_dir=d, out_dir=d)
    x = rng.uniform(-1, 1, n)
    want = (x * w + np.roll(x, -3)) ** 2
    return os.path.join(d, "_hecate_CSBench.cst"), hv, x, want


@pytest.fixture(scope="module")
def keydir(artifacts, tmp_path_factory):
    """A keyset made by the port's full VM, with the program's galois key."""
    d = str(tmp_path_factory.mktemp("keys"))
    cst, hv, _, _ = artifacts
    HEVM(PROFILE, keyset_dir=d, device="cpu").load(cst, hv)
    return d


def rms(got, want):
    return float(np.sqrt(np.mean((np.asarray(got)[: len(want)] - want) ** 2)))


def test_client_server_roundtrip(artifacts, tmp_path):
    cst, hv, x, want = artifacts
    kd = str(tmp_path / "keys")

    # 1. trusted keygen: full keyset incl. galois keys for the program
    full = HEVM(profile=PROFILE, keyset_dir=kd, device="cpu", mode="full")
    full.load(cst, hv)

    # 2. client: secret+public only: encrypt input, serialize
    client = HEVM(profile=PROFILE, keyset_dir=kd, device="cpu", mode="client")
    client.loadClient(hv)
    assert client.scheme.keys.rlk is None and len(client.scheme.keys.galois) == 0
    client.setInput(0, x)
    blob = client.getCtxt(0)
    assert isinstance(blob, bytes)

    # 3. server: eval keys only: receive, run, ship result back
    server = HEVM(profile=PROFILE, keyset_dir=kd, device="cpu", mode="server")
    assert server.scheme.keys.s_ntt is None        # no secret key
    server.load(cst, hv)
    server.setCtxt(0, blob)
    assert server.run() is None                    # server cannot decrypt
    assert server.getResIdx(0) == server.prog.res_dst[0]
    res_blob = server.getOutputCtxt(0)
    assert server.getCtxt(0) == blob               # argument 0 as received

    # 4. client decrypts the transported result
    assert rms(client.decrypt_result(res_blob), want) < RMS_BAR
    with pytest.raises(RuntimeError, match="no secret key"):
        server.decrypt_result(res_blob)


def test_ct_serialization_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2**31, size=(2, 4, 256)).astype(np.uint32)
    blob = serialize_ct(data, 4, 12345.5)
    d2, nl, sc = deserialize_ct(blob, "cpu")
    assert nl == 4 and sc == 12345.5
    np.testing.assert_array_equal(U(d2), data)
    assert blob == ref_serialize_ct(data, 4, 12345.5)   # the JAX package's bytes


def test_server_requires_keyset(tmp_path):
    with pytest.raises(RuntimeError, match="pregenerated keyset"):
        HEVM(profile=PROFILE, keyset_dir=str(tmp_path / "nokeys"), device="cpu",
             mode="server")


def _client_blob(cls, kd, hv, x, **kw):
    client = cls(profile=PROFILE, keyset_dir=kd, mode="client", **kw)
    client.loadClient(hv)
    client.setInput(0, x)
    return client, client.getCtxt(0)


def _serve(cls, kd, cst, hv, blob, **kw):
    server = cls(profile=PROFILE, keyset_dir=kd, mode="server", **kw)
    assert server.scheme.keys.s_ntt is None
    server.load(cst, hv)
    server.setCtxt(0, blob)
    assert server.run() is None
    return server.getOutputCtxt(0)


def test_server_blob_equals_jax_server(artifacts, keydir):
    cst, hv, x, want = artifacts
    client, blob = _client_blob(HEVM, keydir, hv, x, device="cpu")
    port_out = _serve(HEVM, keydir, cst, hv, blob, device="cpu")
    jax_out = _serve(RefHEVM, keydir, cst, hv, blob)
    assert port_out == jax_out
    assert rms(client.decrypt_result(port_out), want) < RMS_BAR


def test_blobs_cross_packages(artifacts, keydir):
    cst, hv, x, want = artifacts
    # a JAX client's blob, served by the port, decrypted by the JAX client
    ref_client, ref_blob = _client_blob(RefHEVM, keydir, hv, x)
    out = _serve(HEVM, keydir, cst, hv, ref_blob, device="cpu")
    got = np.asarray(ref_client.decrypt_result(out))
    assert rms(got, want) < RMS_BAR
    # and the reverse: the port's client through the JAX server
    port_client, port_blob = _client_blob(HEVM, keydir, hv, x, device="cpu")
    out2 = _serve(RefHEVM, keydir, cst, hv, port_blob)
    got2 = port_client.decrypt_result(out2)
    assert rms(got2, want) < RMS_BAR
    # the two clients decrypt either blob to the same values
    np.testing.assert_array_equal(port_client.decrypt_result(out), got)
    np.testing.assert_array_equal(got2, np.asarray(ref_client.decrypt_result(out2)))


@pytest.mark.parametrize("mode", ["full", "client", "server"])
def test_load_keyset_modes(keydir, mode):
    ks = keys.load_keyset(keydir, "cpu", mode=mode)
    ref = ref_keys.load_keyset(keydir, mode=mode)
    for name in ("s_ntt", "pk", "rlk", "conj"):
        got, want = getattr(ks, name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(U(got), np.asarray(want))
    assert (ks.s_ntt is None) == (mode == "server")
    assert (ks.rlk is None) == (mode == "client")
    assert set(ks.galois.keys()) == set(ref.galois.keys())
    assert (len(ks.galois) == 0) == (mode == "client")
    for st in ks.galois.keys():
        np.testing.assert_array_equal(U(ks.galois[st]), np.asarray(ref.galois.peek(st)))
    with pytest.raises(ValueError, match="mode"):
        keys.load_keyset(keydir, "cpu", mode="root")


def test_save_keyset_parts(keydir, tmp_path):
    ks = keys.load_keyset(keydir, "cpu")
    keys.save_keyset(ks, str(tmp_path / "client"), parts=("secret", "public"))
    keys.save_keyset(ks, str(tmp_path / "server"), parts=("public", "eval"))
    assert sorted(os.listdir(tmp_path / "client")) == ["pk.npy", "s_ntt.npy"]
    assert sorted(os.listdir(tmp_path / "server")) == ["galois", "pk.npy", "rlk.npy"]
    assert os.listdir(tmp_path / "server" / "galois") == os.listdir(
        os.path.join(keydir, "galois"))
    srv = keys.load_keyset(str(tmp_path / "server"), "cpu", mode="server")
    np.testing.assert_array_equal(U(srv.rlk), U(ks.rlk))


def test_extend_galois_refuses_without_secret(keydir):
    full = HEVM(PROFILE, keyset_dir=keydir, device="cpu")
    server_keys = keys.load_keyset(keydir, "cpu", mode="server")
    have = sorted(server_keys.galois.keys())
    kg = full.scheme.keygen
    kg.extend_galois(server_keys, have + [0, full.scheme.ctx.n // 2])  # nothing missing
    assert sorted(server_keys.galois.keys()) == have
    with pytest.raises(RuntimeError, match="no secret key.*rotation steps \\[5\\]"):
        kg.extend_galois(server_keys, have + [5])
    assert 5 not in server_keys.galois
    kg.extend_galois(full.scheme.keys, [5])                # the full keyset makes it
    assert 5 in full.scheme.keys.galois


def _refused(kd, profile, cst, hv, match):
    server = HEVM(profile, keyset_dir=kd, device="cpu", mode="server")
    n_keys = len(server.scheme.keys.galois)
    with pytest.raises(RuntimeError, match=match):
        server.load(cst, hv)
    assert server.executor is None and len(server.scheme.keys.galois) == n_keys
    return server


def test_server_refuses_missing_keys(artifacts, tmp_path):
    cst, hv, _, _ = artifacts
    kd = str(tmp_path / "keys")
    HEVM(PROFILE, keyset_dir=kd, device="cpu")          # keygen, no program loaded
    _refused(kd, PROFILE, cst, hv, "lacks the galois keys of rotation steps \\[3\\]")
    assert os.listdir(os.path.join(kd, "galois")) == []


@pytest.fixture(scope="module")
def boot_program(tmp_path_factory):
    """A bootstrapped program at test_boot: the deep circuit of
    tests/test_torch_executor_native.py (compiled by the JAX package)."""
    _, _, hv, cst = compile_test_boot(tmp_path_factory.mktemp("boot"))
    return cst, hv


def test_server_refuses_oracle_program(boot_program, tmp_path):
    cst, hv = boot_program
    kd = str(tmp_path / "keys")
    full = HEVM("test_boot", keyset_dir=kd, device="cpu")
    full.scheme.ensure_galois(HEVMProgram.load(hv).rotation_offsets())
    keys.save_keyset(full.scheme.keys, kd, skip_existing=True)
    _refused(kd, "test_boot", cst, hv, "oracle")


def test_server_refuses_native_without_its_keys(boot_program, tmp_path, monkeypatch):
    """DACAPO_TPU_BOOT=native: the conjugation key is checked first, then the
    bootstrap's rotation keys, each refused without making a key (test_boot
    with the 40 Q primes the program's bootstrap reaches: past the reach the
    load refuses the program first, tests/test_torch_native_n16.py)."""
    cst, hv = boot_program
    monkeypatch.setitem(params.PROFILES, "test_boot",
                        dataclasses.replace(params.PROFILES["test_boot"], **WIDER))
    monkeypatch.setenv("DACAPO_TPU_BOOT", "native")
    kd = str(tmp_path / "keys")
    full = HEVM("test_boot", keyset_dir=kd, device="cpu")
    full.scheme.ensure_galois(HEVMProgram.load(hv).rotation_offsets())
    keys.save_keyset(full.scheme.keys, kd, skip_existing=True)
    _refused(kd, "test_boot", cst, hv, "conjugation key")
    full.scheme.keygen.ensure_conj(full.scheme.keys)
    keys.save_keyset(full.scheme.keys, kd, skip_existing=True)
    server = _refused(kd, "test_boot", cst, hv, "lacks the galois keys")
    assert server.scheme._native_bs is not None       # built, then refused


def test_modes_refuse_the_others_calls(artifacts, keydir):
    cst, hv, _, _ = artifacts
    client = HEVM(PROFILE, keyset_dir=keydir, device="cpu", mode="client")
    with pytest.raises(RuntimeError, match="loadClient"):
        client.load(cst, hv)
    client.loadClient(hv)
    with pytest.raises(RuntimeError, match="evaluates nothing"):
        client.run()
    server = HEVM(PROFILE, keyset_dir=keydir, device="cpu", mode="server")
    with pytest.raises(RuntimeError, match="client's loader"):
        server.loadClient(hv)
    server.load(cst, hv)
    with pytest.raises(RuntimeError, match="neither set"):
        server.run()
    with pytest.raises(ValueError, match="mode"):
        HEVM(PROFILE, keyset_dir=keydir, device="cpu", mode="root")
    with open(os.path.join(keydir, "params.json")) as f:
        assert json.load(f)["primes"].startswith("orbit-v1:")
    assert runner.keyset_fingerprint(server.scheme) == json.load(
        open(os.path.join(keydir, "params.json")))["primes"]


def test_set_debug_traces_as_the_jax_package(artifacts, keydir, capfd):
    """setDebug: each request goes per-op and prints one line per op, the
    same lines as the JAX package's VM prints on the same blob; the outputs
    equal a request without the trace."""
    cst, hv, x, _ = artifacts
    _, blob = _client_blob(HEVM, keydir, hv, x, device="cpu")
    vms = []
    for cls, kw in ((HEVM, dict(device="cpu")), (RefHEVM, {})):
        vm = cls(profile=PROFILE, keyset_dir=keydir, **kw)
        vm.setDebug(True)
        vm.load(cst, hv)
        vm.setCtxt(0, blob)
        capfd.readouterr()
        vm.run()
        lines = [ln for ln in capfd.readouterr().err.splitlines() if ln.startswith("[hevm] ")
                 and "log2(scale)" in ln]
        vms.append((vm, lines, vm.getOutputCtxt(0)))
    (port, lines, out), (_, ref_lines, ref_out) = vms
    assert lines and lines == ref_lines and out == ref_out
    assert port.executor.debug
    port.setDebug(False)
    port.run()
    assert port.getOutputCtxt(0) == out
