"""A bootstrapped `dacapo` program through both executors on the CPU: the deep
circuit of tests/test_dacapo.py, traced and compiled by the JAX package
(dacapo, waterline 25, test_n10), run by the JAX executor (per-op path,
host-RNG oracle) and by the port's (host_rng=True), on keysets made with the
same seed. The output ciphertexts are bit-equal."""

import numpy as np
import pytest

import dacapo_tpu as hc
from dacapo_tpu.crypto.params import COMPILER_PROFILES
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu.ir import trace as trace_mod
from dacapo_tpu.ir.config import load_profile
from dacapo_tpu.passes.pipeline import compile_function
from dacapo_tpu.passes.rewrite import cse, canonicalize, elide_constants, privatize_constants
from dacapo_tpu.vm.executor import HEVMExecutor as RefExecutor
from dacapo_tpu_torch.crypto.scheme import Scheme
from dacapo_tpu_torch.vm.executor import HEVMExecutor
from dacapo_tpu_torch.vm.hevm import HEVMProgram, OP_BOOTSTRAP

PROFILE = "test_n10"
DEPTH = 5           # still deep enough for the planner to place a bootstrap


def _deep_body(n_slots, depth=DEPTH):
    """Same circuit as tests/test_dacapo.py:_deep_body."""
    mask = np.full(n_slots, 0.9)

    def body(x):
        y = x
        for i in range(depth):
            y = y * x                      # burn a level each time
            y = y + y.rotate(1 + i)        # SMU-crossing edges
            y = y * hc.Plain(mask)
        return y

    return body


def _golden(x, depth=DEPTH):
    y = x.copy()
    for i in range(depth):
        y = y * x
        y = y + np.roll(y, -(1 + i))
        y = y * 0.9
    return y


def compile_deep(tmp, n):
    """The deep circuit over n slots traced and compiled by the JAX package
    (dacapo, waterline 25, test_n10), written to tmp/deep.hevm. Returns
    (prog, payloads, path)."""
    load_profile(COMPILER_PROFILES[PROFILE])
    trace_mod._module.reset()
    fn = hc.func("c")(_deep_body(n)).eval()
    cse(fn)
    canonicalize(fn)
    payloads = elide_constants(fn)
    privatize_constants(fn)
    canonicalize(fn)
    prog = compile_function(fn, "dacapo", 25)
    path = str(tmp / "deep.hevm")
    prog._save_py(path)
    return prog, payloads, path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("DACAPO_TPU_ORACLE_JIT", "0")
    try:
        ref = RefScheme(PROFILE)
        ref.generate_keys()
        n = ref.ctx.config.n_slots
        prog, payloads, path = compile_deep(tmp_path_factory.mktemp("boot"), n)

        x = np.random.default_rng(0).uniform(0.4, 0.9, n)
        ex = RefExecutor(ref, prog, payloads)
        ex.preprocess()
        ref_out = ex.run([x], jit=False)
        ref_cts = [np.asarray(c) for c in ex._last_outputs[0]]
    finally:
        mp.undo()

    port = Scheme(PROFILE, device="cpu")
    port.generate_keys()
    pex = HEVMExecutor(port, HEVMProgram.load(path), payloads, host_rng=True)
    pex.preprocess()
    port_out = pex.run([x])
    port_cts = [c.numpy().view(np.uint32) for c in pex._last_outputs[0]]
    assert pex.key_bytes == pex.n_keys * port.galois_key_bytes() > 0
    assert 0 < pex.n_plains <= ex.prog.num_ptxt and pex.plain_bytes > 0
    return dict(prog=pex.prog, x=x, ref_out=ref_out, ref_cts=ref_cts,
                port_out=port_out, port_cts=port_cts,
                meta=(pex._last_outputs[1], ex._last_outputs[1]))


def test_bootstraps_placed(runs):
    assert sum(op.opcode == OP_BOOTSTRAP for op in runs["prog"].ops) >= 1


def test_output_ciphertexts_bit_equal(runs):
    assert len(runs["port_cts"]) == len(runs["ref_cts"]) == 1
    for got, want in zip(runs["port_cts"], runs["ref_cts"]):
        np.testing.assert_array_equal(got, want)
    got_meta, want_meta = runs["meta"]
    assert [tuple(m) for m in got_meta] == [tuple(m) for m in want_meta]


def test_decrypted_output_and_rms(runs):
    np.testing.assert_array_equal(runs["port_out"], runs["ref_out"])
    want = _golden(runs["x"])
    rms = float(np.sqrt(np.mean((runs["port_out"][0] - want) ** 2)))
    assert rms < 5e-2, rms
