"""Memory-efficient attention entry point.

Counterpart of `apla_tpu/ops/flash_attention.py`.  Only the plain softmax
path (`_jnp_mha`) is ported, as `plain_mha`, for CPU tensors; it is also the
plain attention of `ops.attention.qkv_and_attend`.  On the TPU `flash_mha`
runs the repo's `pallas_mha` kernel (ROADMAP B5) or JAX's library flash
kernel; the Hopper kernel for it is not written yet, so a CUDA tensor raises
rather than silently taking a plain path.
"""

from __future__ import annotations

import torch


def plain_mha(q, k, v, scale, segment_len: int = 0, logits_f32: bool = True):
    """q, k, v [B, H, N, Dh] -> [B, H, N, Dh]: logits in f32 (or rounded to
    q.dtype first when `logits_f32` is off, as the JAX path does), f32
    softmax cast to q.dtype, then attn @ v in q.dtype.

    `segment_len` > 0: block-diagonal attention (tokens attend only inside
    their own segment of that length)."""
    if logits_f32:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    else:
        logits = (torch.matmul(q, k.transpose(-1, -2)) * scale).float()
    if segment_len:
        n = q.shape[2]
        seg = torch.arange(n, device=q.device) // segment_len
        logits = logits.masked_fill(seg[:, None] != seg[None, :], -1e9)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def flash_mha(q, k, v, scale: float = 1.0, segment_len: int = 0):
    """q, k, v [B, N, H, Dh] -> [B, N, H, Dh]."""
    if q.device.type != "cpu":
        raise NotImplementedError(
            "use_flash on a CUDA tensor needs the pallas_mha Hopper kernel, "
            "not yet ported (ROADMAP B5); run with use_flash=False")
    out = plain_mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    scale, segment_len=segment_len)
    return out.transpose(1, 2)
