"""The hand-written CUDA NTT kernel against the plain PyTorch NTT, bit for
bit, on the card, at N = 2^8, 2^11, 2^15 and 2^16 and B = 1, 2, 37 (rows
repeated and out of order). Imports no JAX, so it runs where only the port
is installed:  python -m pytest tests/test_torch_ntt_cuda.py -m cuda
Without a card every case skips (a CUDA kernel has no CPU mode)."""

import pytest
import torch

from dacapo_tpu_torch.crypto import ntt
from dacapo_tpu_torch.crypto.params import CKKSContext, PROFILES

PROFILE_OF_N = {1 << 8: "test_n8", 1 << 11: "test_n11", 1 << 15: "tpu_n15",
                1 << 16: "tpu_n16"}
_CTX = {}


def _ctx(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NTT kernel has no CPU mode")
    if n not in _CTX:
        _CTX[n] = CKKSContext(PROFILES[PROFILE_OF_N[n]], device="cuda")
    return _CTX[n]


def _rows(ctx, b):
    """b rows: every prime index reversed, then repeated, cut to b."""
    p = len(ctx.primes)
    order = list(range(p - 1, -1, -1)) + [(3 * i + 1) % p for i in range(b)]
    return torch.tensor(order[:b], dtype=torch.int32, device="cuda")


def _planes(ctx, rows):
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = ctx.dev["q"][rows.long()].long()[:, None]
    return (torch.randint(0, 1 << 62, (len(rows), ctx.n), generator=gen,
                          device="cuda") % q).to(torch.int32), q


def _plain(ctx, x, rows, q, inverse):
    idx = rows.long()
    if inverse:
        return ntt.ntt_inv(x, ctx.dev["itw"][idx], q, ctx.dev["ninv"][idx][:, None])
    return ntt.ntt_fwd(x, ctx.dev["tw"][idx], q)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("b", [1, 2, 37])
@pytest.mark.parametrize("n", sorted(PROFILE_OF_N))
def test_kernel_matches_plain(n, b, inverse):
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import ntt_cuda
    ctx = _ctx(n)
    rows = _rows(ctx, b)
    x, q = _planes(ctx, rows)
    got = ntt_cuda(x, rows, ctx.dev, inverse)
    want = _plain(ctx, x, rows, q, inverse)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(PROFILE_OF_N))
def test_kernel_roundtrip(n):
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import ntt_cuda
    ctx = _ctx(n)
    rows = _rows(ctx, 37)
    x, _ = _planes(ctx, rows)
    back = ntt_cuda(ntt_cuda(x, rows, ctx.dev, False), rows, ctx.dev, True)
    torch.cuda.synchronize()
    assert torch.equal(back, x)


@pytest.mark.cuda
def test_kernel_rejects_bad_input():
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import ntt_cuda
    ctx = _ctx(1 << 11)
    rows = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    x, _ = _planes(ctx, rows)
    with pytest.raises(ValueError):
        ntt_cuda(x.cpu(), rows, ctx.dev)
    with pytest.raises(ValueError):
        ntt_cuda(x.long(), rows, ctx.dev)
    with pytest.raises(ValueError):
        ntt_cuda(x[:, ::2], rows, ctx.dev)


@pytest.mark.cuda
@pytest.mark.parametrize("logn", [7, 17])
def test_kernel_rejects_n_out_of_range(logn):
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import ntt_cuda
    ctx = _ctx(1 << 11)
    rows = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    x = torch.zeros((2, 1 << logn), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        ntt_cuda(x, rows, ctx.dev)
