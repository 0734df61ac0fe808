"""The port's plain NTT (dacapo_tpu_torch.crypto.ntt) against the JAX
package's portable NTT and its Pallas kernel in interpret mode, bit for bit
on test_n11 (rows repeated and out of order). The CUDA kernel is held
against the plain version in test_torch_ntt_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dacapo_tpu.crypto.ntt import ntt_fwd as ref_fwd, ntt_inv as ref_inv
from dacapo_tpu.crypto.pallas.ntt_kernel import PallasNTT
from dacapo_tpu.crypto.params import CKKSContext, PROFILES
from dacapo_tpu_torch.crypto.ntt import ntt_fwd, ntt_inv
from dacapo_tpu_torch.crypto.params import CKKSContext as TCtx, PROFILES as TPROFILES

ROWS = [0, 2, 1, 2]


@pytest.fixture(scope="module")
def ctx():
    return CKKSContext(PROFILES["test_n11"])


def _planes(ctx, rows, seed):
    rng = np.random.default_rng(seed)
    qv = np.array([ctx.primes[r] for r in rows], dtype=np.uint64)
    return (rng.integers(0, 1 << 62, (len(rows), ctx.n)) % qv[:, None]).astype(np.uint32)


def _port(ctx, x, rows, inverse):
    h = ctx.host_tables
    idx = np.asarray(rows)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    q = t(h["q"][idx][:, None])
    if inverse:
        out = ntt_inv(t(x), t(h["itw"][idx]), q, t(h["ninv"][idx][:, None]))
    else:
        out = ntt_fwd(t(x), t(h["tw"][idx]), q)
    assert out.dtype == torch.int32
    return out.numpy().view(np.uint32)


def _ref(ctx, x, rows, inverse):
    h = ctx.host_tables
    idx = np.asarray(rows)
    q = jnp.asarray(h["q"][idx][:, None])
    if inverse:
        return np.asarray(ref_inv(jnp.asarray(x), h["itw"][idx], h["itw_shoup"][idx], q,
                                  h["ninv"][idx][:, None], h["ninv_shoup"][idx][:, None]))
    return np.asarray(ref_fwd(jnp.asarray(x), h["tw"][idx], h["tw_shoup"][idx], q))


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_portable(ctx, inverse):
    x = _planes(ctx, ROWS, 7)
    np.testing.assert_array_equal(_port(ctx, x, ROWS, inverse), _ref(ctx, x, ROWS, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_pallas_interpret(ctx, inverse):
    x = _planes(ctx, ROWS, 8)
    want = np.asarray(PallasNTT(ctx, interpret=True)(jnp.asarray(x), ROWS, inverse=inverse))
    np.testing.assert_array_equal(_port(ctx, x, ROWS, inverse), want)


def test_plain_roundtrip(ctx):
    x = _planes(ctx, ROWS, 3)
    y = _port(ctx, x, ROWS, False)
    np.testing.assert_array_equal(_port(ctx, y, ROWS, True), x)


def test_tables_match_reference(ctx):
    tctx = TCtx(TPROFILES["test_n11"], device="cpu")
    for k, v in ctx.host_tables.items():
        np.testing.assert_array_equal(tctx.host_tables[k], v)
    np.testing.assert_array_equal(tctx.orbit_perm, ctx.orbit_perm)
