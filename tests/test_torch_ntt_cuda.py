"""The hand-written CUDA NTT kernel against the plain PyTorch NTT, bit for
bit, on the card. Imports no JAX, so it runs where only the port is
installed:  python -m pytest tests/test_torch_ntt_cuda.py -m cuda
Without a card every case skips (a CUDA kernel has no CPU mode)."""

import pytest
import torch

from dacapo_tpu_torch.crypto import ntt
from dacapo_tpu_torch.crypto.params import CKKSContext, PROFILES


@pytest.fixture(scope="module")
def ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NTT kernel has no CPU mode")
    return CKKSContext(PROFILES["test_n11"], device="cuda")


def _planes(ctx, rows):
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = ctx.dev["q"][rows.long()].long()[:, None]
    return (torch.randint(0, 1 << 62, (len(rows), ctx.n), generator=gen,
                          device="cuda") % q).to(torch.int32), q


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain(ctx, inverse):
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import ntt_cuda
    rows = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device="cuda")
    x, q = _planes(ctx, rows)
    idx = rows.long()
    got = ntt_cuda(x, rows, ctx.dev, inverse)
    if inverse:
        want = ntt.ntt_inv(x, ctx.dev["itw"][idx], q, ctx.dev["ninv"][idx][:, None])
    else:
        want = ntt.ntt_fwd(x, ctx.dev["tw"][idx], q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_rejects_bad_input(ctx):
    from dacapo_tpu_torch.crypto.cuda.ntt_kernel import ntt_cuda
    rows = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    x, _ = _planes(ctx, rows)
    with pytest.raises(ValueError):
        ntt_cuda(x.cpu(), rows, ctx.dev)
    with pytest.raises(ValueError):
        ntt_cuda(x.long(), rows, ctx.dev)
    with pytest.raises(ValueError):
        ntt_cuda(x[:, ::2], rows, ctx.dev)
