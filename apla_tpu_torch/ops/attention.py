"""Multi-head self-attention ops.

Counterpart of `apla_tpu/ops/attention.py`.  The QKV projection is always
frozen under APLA.  Dropout follows the JAX package: attention dropout on the
softmaxed weights and projection dropout on the block output, both only when
`deterministic` is False, drawn from an explicit `torch.Generator` (the JAX
package splits a PRNG key; the two streams differ, the distributions match).

`apla_attention(..., use_fused=True)` runs attention and the partial
projection through `fused_apla_attention`.  On a CUDA tensor that is the
hand-written kernel, which raises (bad dtype, head dim, shared memory)
rather than falling back: the JAX package's warn-and-fall-back ladder exists
for Mosaic's VMEM limits and has no counterpart on the card.  The kernel
applies no dropout to p, in JAX or here, so training with `attn_drop > 0`
on the fused path raises; inference ignores `attn_drop`.

`use_flash` (the recipes' `is_memory_efficient`) sends the attention of
`qkv_and_attend` through `ops.mha`, the hand-written memory-efficient
attention kernels on a CUDA tensor, unless `attn_drop` > 0 (the JAX package
then takes the plain path too).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import rand_rows
from .apla_proj import apla_proj
from .flash_attention import plain_mha
from .fused_apla_attn import fused_apla_attention
from .mha import mha
from .quant import maybe_quantized_dot


def dropout(x, rate: float, generator, deterministic: bool):
    """Elementwise dropout: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate) (`apla_tpu/ops/attention.py:_dropout`)."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = rand_rows(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def check_fused_dropout(attn_drop: float, deterministic: bool) -> None:
    """Training with `attn_drop` > 0 on the fused APLA path raises: the
    kernel applies no dropout to the attention weights."""
    if attn_drop > 0.0 and not deterministic:
        raise ValueError(
            f"attn_drop_rate={attn_drop} while training on the fused APLA "
            "path: the kernel applies no dropout to the attention "
            "weights (neither does the TPU kernel); set attn_drop_rate 0 "
            "or use_fused_apla false")


def attend(qkv, num_heads, scale, attn_drop=0.0, attn_dropout=None,
           use_flash=False, logits_f32=True, segment_len=0):
    """Scaled dot-product attention of the packed qkv [B, N, 3 H Dh] over
    its `num_heads` heads -> [B, N, H Dh]: the memory-efficient kernels
    when `use_flash` and no attention dropout, else `plain_mha` with
    `attn_dropout(a)` on the softmaxed weights.

    `segment_len` > 0: block-diagonal attention (tokens attend only inside
    their own segment of that length)."""
    if use_flash and attn_drop == 0.0:
        # the packed [B, N, 3C] qkv as the kernels take it (flash_mha's
        # function without its packing copy); dqkv comes back packed
        return mha(qkv, num_heads, scale, segment_len)
    B, N, C3 = qkv.shape
    head_dim = C3 // (3 * num_heads)
    qkv = qkv.reshape(B, N, 3, num_heads, head_dim)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B,H,N,Dh]
    out = plain_mha(q, k, v, scale, segment_len=segment_len,
                    logits_f32=logits_f32, attn_dropout=attn_dropout)
    return out.transpose(1, 2).reshape(B, N, num_heads * head_dim)


def qkv_and_attend(x, qkv_kernel, qkv_bias, num_heads, scale=None,
                   attn_drop=0.0, generator=None, deterministic=True,
                   use_flash=False, logits_f32=True, segment_len=0):
    """QKV projection + scaled dot-product attention (`attend`).  Returns
    [B, N, C]."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    qkv = maybe_quantized_dot(x, qkv_kernel, qkv_bias)
    return attend(qkv, num_heads, scale, attn_drop,
                  lambda a: dropout(a, attn_drop, generator, deterministic),
                  use_flash, logits_f32, segment_len)


def multi_head_attention(x, params, num_heads, scale=None, attn_drop=0.0,
                         proj_drop=0.0, generator=None, deterministic=True,
                         use_flash=False, logits_f32=True, segment_len=0):
    """Standard attention block: QKV, attend, dense output projection.

    `params`: an `Attention` module (or dict) with `qkv.kernel`, `qkv.bias`
    (may be None), `proj.kernel`, `proj.bias`."""
    out = qkv_and_attend(x, params.qkv.kernel, params.qkv.bias, num_heads,
                         scale=scale, attn_drop=attn_drop,
                         generator=generator, deterministic=deterministic,
                         use_flash=use_flash, logits_f32=logits_f32,
                         segment_len=segment_len)
    proj = params.proj
    out = torch.matmul(out, proj.kernel.to(x.dtype)) + proj.bias.to(x.dtype)
    return dropout(out, proj_drop, generator, deterministic)


def apla_attention(x, attn, num_heads, scale=None, attn_drop=0.0,
                   proj_drop=0.0, generator=None, deterministic=True,
                   use_flash=False, logits_f32=True, use_fused=False,
                   segment_len=0):
    """APLA attention: frozen QKV + attention, partial-trainable projection.

    `attn`: an `Attention` module carrying the frozen `qkv`, `proj` and
    `inds`, and the trainable `proj_wt` [d, k] / `proj_bt` [k]; without
    them (the segmenter's APLA "full", `models.seg.build_seg_apla`) the
    projection itself trains, as the columns `inds` = 0..d-1.
    `use_fused`: attention + the partial projection as one kernel (the
    attention output never reaches device memory)."""
    w_t, b_t = ((attn.proj_wt, attn.proj_bt) if attn.proj_wt is not None
                else (attn.proj.kernel, attn.proj.bias))
    if use_fused:
        check_fused_dropout(attn_drop, deterministic)
        C = x.shape[-1]
        head_dim = C // num_heads
        qkv = maybe_quantized_dot(x, attn.qkv.kernel, attn.qkv.bias)
        out = fused_apla_attention(
            qkv, w_t, b_t, attn.proj.kernel, attn.proj.bias, attn.inds,
            num_heads,
            float(scale if scale is not None else head_dim ** -0.5),
            int(segment_len))
        return dropout(out, proj_drop, generator, deterministic)
    out = qkv_and_attend(x, attn.qkv.kernel, attn.qkv.bias, num_heads,
                         scale=scale, attn_drop=attn_drop,
                         generator=generator, deterministic=deterministic,
                         use_flash=use_flash, logits_f32=logits_f32,
                         segment_len=segment_len)
    out = apla_proj(out, w_t, b_t, attn.proj.kernel, attn.proj.bias,
                    attn.inds)
    return dropout(out, proj_drop, generator, deterministic)
