"""Multi-head self-attention ops, inference only.

Counterpart of `apla_tpu/ops/attention.py`.  The QKV projection is always
frozen under APLA.  No dropout yet: the port's forward is deterministic.

`apla_attention(..., use_fused=True)` runs attention and the partial
projection through `fused_apla_attention`.  On a CUDA tensor that is the
hand-written kernel, which raises (bad dtype, head dim, shared memory)
rather than falling back: the JAX package's warn-and-fall-back ladder exists
for Mosaic's VMEM limits and has no counterpart on the card.
"""

from __future__ import annotations

import torch

from .apla_proj import apla_proj
from .flash_attention import flash_mha, plain_mha
from .fused_apla_attn import fused_apla_attention
from .quant import maybe_quantized_dot


def qkv_and_attend(x, qkv_kernel, qkv_bias, num_heads, scale=None,
                   use_flash=False, logits_f32=True, segment_len=0):
    """QKV projection + scaled dot-product attention.  Returns [B, N, C].

    `segment_len` > 0: block-diagonal attention (tokens attend only inside
    their own segment of that length)."""
    B, N, C = x.shape
    head_dim = C // num_heads
    if scale is None:
        scale = head_dim ** -0.5
    qkv = maybe_quantized_dot(x, qkv_kernel, qkv_bias)
    qkv = qkv.reshape(B, N, 3, num_heads, head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, N, H, Dh]

    if use_flash:
        out = flash_mha(q, k, v, scale=scale, segment_len=segment_len)
        return out.reshape(B, N, C)

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # [B, H, N, Dh]
    out = plain_mha(q, k, v, scale, segment_len=segment_len,
                    logits_f32=logits_f32)
    return out.transpose(1, 2).reshape(B, N, C)


def multi_head_attention(x, params, num_heads, scale=None, use_flash=False,
                         logits_f32=True, segment_len=0):
    """Standard attention block: QKV, attend, dense output projection.

    `params`: an `Attention` module (or dict) with `qkv.kernel`, `qkv.bias`
    (may be None), `proj.kernel`, `proj.bias`."""
    out = qkv_and_attend(x, params.qkv.kernel, params.qkv.bias, num_heads,
                         scale=scale, use_flash=use_flash,
                         logits_f32=logits_f32, segment_len=segment_len)
    proj = params.proj
    return torch.matmul(out, proj.kernel.to(x.dtype)) + proj.bias.to(x.dtype)


def apla_attention(x, attn, num_heads, scale=None, use_flash=False,
                   logits_f32=True, use_fused=False, segment_len=0):
    """APLA attention: frozen QKV + attention, partial-trainable projection.

    `attn`: an `Attention` module carrying the frozen `qkv`, `proj` and
    `inds`, and the trainable `proj_wt` [d, k] / `proj_bt` [k].
    `use_fused`: attention + the partial projection as one kernel (the
    attention output never reaches device memory).  The forward applies no
    attention dropout on any path, so a config's `attn_drop_rate` does not
    turn the fused path off."""
    if use_fused:
        C = x.shape[-1]
        head_dim = C // num_heads
        qkv = maybe_quantized_dot(x, attn.qkv.kernel, attn.qkv.bias)
        return fused_apla_attention(
            qkv, attn.proj_wt, attn.proj_bt, attn.proj.kernel, attn.proj.bias,
            attn.inds, num_heads,
            float(scale if scale is not None else head_dim ** -0.5),
            int(segment_len))
    out = qkv_and_attend(x, attn.qkv.kernel, attn.qkv.bias, num_heads,
                         scale=scale, use_flash=use_flash,
                         logits_f32=logits_f32, segment_len=segment_len)
    return apla_proj(out, attn.proj_wt, attn.proj_bt, attn.proj.kernel,
                     attn.proj.bias, attn.inds)
