"""The native bootstrap on the card: the test_boot bootstrap of
tests/test_torch_bootstrap_native.py (same seed, config and calls) on the
card is bit-equal to the same calls with device="cpu", and its output
ciphertext's SHA-256 equals the digest committed from the JAX package
(dacapo_tpu_torch/artifacts/native_test_boot/expected.json). Imports no JAX:
    python -m pytest tests/test_torch_native_cuda.py -m cuda
Without a card every case skips (the NTT kernel has no CPU mode)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dacapo_tpu_torch.crypto.bootstrap_native import BootstrapConfig
from dacapo_tpu_torch.crypto.cuda import ntt_kernel
from dacapo_tpu_torch.crypto.params import to_host
from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext

EXPECTED = (Path(__file__).resolve().parents[1] / "dacapo_tpu_torch" / "artifacts"
            / "native_test_boot" / "expected.json")
SEED = 6
CFG = dict(K=16, r=3, degree=36, baby=8)


def run_test_boot(device):
    """(output ciphertext uint32 [2, 2, N], decrypted slots, input slots)."""
    s = Scheme("test_boot", seed=SEED, device=device)
    s.generate_keys()
    bs = s.enable_native_bootstrap(BootstrapConfig(**CFG))
    vals = np.random.default_rng(3).uniform(-1, 1, s.ctx.config.n_slots)
    ct = s.encrypt(vals, scale=2.0 ** 25, nl=2)
    data, (_, scale) = bs.bootstrap(ct.data, 2, ct.scale, 1)
    return to_host(data), s.decrypt(Ciphertext(data, scale)), vals


@pytest.fixture(scope="module")
def card_and_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NTT kernel has no CPU mode")
    for k in ntt_kernel.LAUNCHES:
        ntt_kernel.LAUNCHES[k] = 0
    card = run_test_boot("cuda")
    launches = dict(ntt_kernel.LAUNCHES)
    return card, run_test_boot("cpu"), launches


@pytest.mark.cuda
def test_test_boot_bootstrap_card_equals_cpu(card_and_cpu):
    (got, out, vals), (want, _, _), launches = card_and_cpu
    np.testing.assert_array_equal(got, want)
    assert min(launches.values()) > 0, launches
    assert float(np.sqrt(np.mean((out - vals) ** 2))) < 5e-4


@pytest.mark.cuda
def test_test_boot_digest_is_the_jax_packages(card_and_cpu):
    (got, _, _), _, _ = card_and_cpu
    expected = json.loads(EXPECTED.read_text())
    assert hashlib.sha256(got.astype("<u4").tobytes()).hexdigest() == \
        expected["output_ct_sha256"]
