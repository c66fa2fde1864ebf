"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

This file imports no jax, so it also runs on a machine that has only
PyTorch; there, skip tests/conftest.py (it sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Each kernel is held against its plain PyTorch version on the same bf16
tensors.  Bound: 2e-2 of the reference's largest magnitude (the two round
p, o and the output to bf16 after f32 sums taken in different orders).
"""

import pytest
import torch

from apla_tpu_torch.ops import fused_apla_attn as tfa

REL_TOL = 2e-2


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided at run time, never at collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _qkv_w(device, b, n, c, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, n, 3 * c), generator=gen).to(device, torch.bfloat16)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(device,
                                                            torch.bfloat16)
    return qkv, w


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,seg,c", [
    (8, 257, 0, 768),     # ViT-B/14 at 224
    (2, 1370, 0, 768),    # ViT-B/14 at 518
    (8, 200, 50, 768),    # packed segments
    (2, 100, 64, 768),    # last segment cut by N
    (3, 17, 0, 768),      # N below one tile
    (1, 1, 0, 768),
    (2, 257, 0, 192),     # ViT-Ti: 3 heads, odd
    (4, 65, 13, 384),     # ViT-S
    (2, 300, 0, 1024),    # ViT-L
])
def test_fused_apla_attn_matches_plain(cuda_device, b, n, seg, c):
    qkv, w = _qkv_w(cuda_device, b, n, c, seed=n + seg + c)
    heads = c // 64
    before = tfa.fused_apla_attn_fwd.launches
    out = tfa.fused_apla_attn_fwd(qkv, w, heads, 0.125, seg)
    torch.cuda.synchronize()
    assert tfa.fused_apla_attn_fwd.launches == before + 1
    ref = tfa.fused_apla_attn_fwd_reference(qkv, w, heads, 0.125, seg)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL * ref.float().abs().max().item()


@pytest.mark.cuda
def test_fused_apla_attn_raises_instead_of_falling_back(cuda_device):
    qkv, w = _qkv_w(cuda_device, 2, 17, 768, seed=0)
    before = tfa.fused_apla_attn_fwd.launches
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.fused_apla_attn_fwd(qkv.float(), w.float(), 12, 0.125)
    with pytest.raises(ValueError, match="head dim 64"):
        tfa.fused_apla_attn_fwd(qkv, w, 6, 0.125)
    assert tfa.fused_apla_attn_fwd.launches == before
