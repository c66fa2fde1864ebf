"""Memory-efficient attention entry point.

Counterpart of `apla_tpu/ops/flash_attention.py`.  `flash_mha` runs
`ops.mha` for every N: on a CUDA tensor the hand-written kernels
(`csrc/mha_{fwd,bwd}.cu`, the port of `pallas_mha.py`), which tile the keys,
so the port needs no counterpart of the TPU's library flash kernel for
N > 512; on a CPU tensor their plain versions.  `plain_mha` is the plain
softmax attention of `ops.attention.qkv_and_attend` for `use_flash=False`
(`_jnp_mha` in the JAX package).
"""

from __future__ import annotations

import torch

from .mha import mha


def plain_mha(q, k, v, scale, segment_len: int = 0, logits_f32: bool = True,
              attn_dropout=None):
    """q, k, v [B, H, N, Dh] -> [B, H, N, Dh]: logits in f32 (or rounded to
    q.dtype first when `logits_f32` is off, as the JAX path does), f32
    softmax cast to q.dtype, `attn_dropout` (if given) on the weights, then
    attn @ v in q.dtype.

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
    if attn_dropout is not None:
        attn = attn_dropout(attn)
    return torch.matmul(attn, v)


def flash_mha(q, k, v, scale: float = 1.0, segment_len: int = 0):
    """q, k, v [B, N, H, Dh] -> [B, N, H, Dh], differentiable in all three.

    They are packed into one `[B, N, 3C]` tensor for the kernels;
    `ops.attention.qkv_and_attend` hands `ops.mha.mha` the qkv matmul's
    output directly and skips that copy."""
    B, N, H, Dh = q.shape
    qkv = torch.stack((q, k, v), dim=2).reshape(B, N, 3 * H * Dh)
    return mha(qkv, H, scale, segment_len).reshape(B, N, H, Dh)
