"""Swin Transformer backbone with APLA partitioning (the detection side-car).

Counterpart of `apla_tpu/models/swin.py`: windowed attention with shifted
windows, relative position bias, patch merging, 4 stages (Swin-T defaults:
embed 96, depths 2/2/6/2, heads 3/6/12/24, window 7), returning the
multi-scale feature pyramid a detection head consumes.  Under APLA only each
block's `attn.proj` trains (the reference's `apla_swin_transformer.py:25-39`).

The parameters live in `nn.Module`s named after the JAX tree
(`stages.{s}.blocks.{i}.attn.qkv.kernel`, `...attn.rel_bias`, `norms.{s}`,
...); kernels keep the JAX layout (`[d_in, d_out]`, the patch embedding HWIO)
and images are NHWC.  Parameters are float32 and every op casts them to
`cfg.compute_dtype`, as the JAX forward does; LayerNorm statistics are f32.

With `use_fused_apla` every block sends its windows through
`ops.fused_swin_attn.fused_swin_attention` (the hand-written window kernels
on a CUDA tensor, their plain version on a CPU one), and nothing else: the
JAX package's admission checks and fall-backs are specific to the TPU's
compiler and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dropout
from ..ops.fused_swin_attn import fused_swin_attention
from ..ops.quant import maybe_quantized_dot
from ..parallel.mesh import gathered
from .vit import Dense, Norm, _param, layer_norm, trunc_normal


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    norm_eps: float = 1e-5
    # LayerNorm after the patch-embed projection (official Swin and HF
    # SwinModel have it)
    patch_norm: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    # window attention + the (fully trainable) APLA projection through the
    # fused window kernel
    use_fused_apla: bool = False


class SwinAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)
        self.rel_bias = _param((2 * window - 1) ** 2, num_heads)


class SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window, hidden, qkv_bias):
        super().__init__()
        self.norm1 = Norm(dim)
        self.attn = SwinAttention(dim, num_heads, window, qkv_bias)
        self.norm2 = Norm(dim)
        self.mlp = SwinMlp(dim, hidden)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)
        self.norm = Norm(4 * dim)


class SwinStage(nn.Module):
    def __init__(self, dim, depth, num_heads, cfg: SwinConfig, merge: bool):
        super().__init__()
        hidden = int(dim * cfg.mlp_ratio)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, cfg.window_size, hidden, cfg.qkv_bias)
            for _ in range(depth))
        self.downsample = PatchMerging(dim) if merge else None


class SwinPatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        p = cfg.patch_size
        self.kernel = _param(p, p, cfg.in_chans, cfg.embed_dim)   # HWIO
        self.bias = _param(cfg.embed_dim)


class Swin(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = SwinPatchEmbed(cfg)
        self.patch_norm = Norm(d) if cfg.patch_norm else None
        n = len(cfg.depths)
        self.stages = nn.ModuleList(
            SwinStage(d * 2 ** s, depth, cfg.num_heads[s], cfg, s < n - 1)
            for s, depth in enumerate(cfg.depths))
        # per-stage output norm (the detection feature pyramid)
        self.norms = nn.ModuleList(Norm(d * 2 ** s) for s in range(n))


@torch.no_grad()
def init_swin_params(cfg: SwinConfig, generator: torch.Generator,
                     device=None) -> Swin:
    """The JAX package's init rule: truncated-normal (std 0.02) kernels and
    relative-position bias tables, zero biases, unit norms.  The draws
    differ from JAX's; the tests carry JAX's weights across instead."""
    model = Swin(cfg)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("kernel", "rel_bias"):
            p.copy_(trunc_normal(tuple(p.shape), generator))
    return model.to(device) if device is not None else model


def build_apla_swin(model: Swin) -> Swin:
    """Each block's `attn.proj` trainable, everything else frozen (reference
    apla_swin_transformer.py:25-39).  In place; returns the model."""
    for name, p in model.named_parameters():
        p.requires_grad_(".attn.proj." in f".{name}")
    return model


@functools.cache
def _rel_pos_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))  # [2, w, w]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]       # [2, n, n]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def _window_partition(x, window):
    """[B, H, W, C] -> [B * nW, window^2, C], the image outermost."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def _window_reverse(wins, window, B, H, W):
    C = wins.shape[-1]
    x = wins.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.cache
def _shift_mask(H, W, window, shift) -> np.ndarray:
    """Additive attention mask [nW, n, n] for shifted windows: tokens from
    different original regions must not attend (classic Swin mask)."""
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for h in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w in (slice(0, -window), slice(-window, -shift),
                  slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = img.reshape(1, H // window, window, W // window, window, 1)
    wins = wins.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -1e9, 0.0).astype(np.float32)


# The two caches below are filled outside inference mode even when the first
# call comes from a served or evaluated forward: autograd refuses to save an
# inference tensor for a later training step's backward.
@functools.cache
def _device_shift_mask(H, W, window, shift, device):
    """`_shift_mask` on `device`, made once per (H, W, window, shift)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_shift_mask(H, W, window, shift)).to(device)


@functools.cache
def _device_rel_index(window, device):
    with torch.inference_mode(False):
        return torch.from_numpy(_rel_pos_index(window).reshape(-1)).to(
            device)


def _gathered_rel_bias(attn: SwinAttention, window, n, num_heads):
    """Relative-position bias table gathered to [H, n, n] f32: the one place
    the indexing convention lives (the plain and fused paths share it)."""
    idx = _device_rel_index(window, attn.rel_bias.device)
    bias = attn.rel_bias[idx].reshape(n, n, num_heads)
    return bias.permute(2, 0, 1).float().contiguous()


def _swin_attention(qkv, bias, mask, num_heads, cfg: SwinConfig, generator,
                    deterministic):
    """Plain window attention: qkv [nW*B, n, 3C] -> [nW*B, n, C]."""
    nWB, n, C3 = qkv.shape
    C = C3 // 3
    head_dim = C // num_heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(nWB, n, 3, num_heads, head_dim).permute(
        2, 0, 3, 1, 4)                                  # [nWB, H, n, hd]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * head_dim ** -0.5
    logits = logits + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        logits = logits.reshape(-1, nW, num_heads, n, n) + mask[None, :, None]
        logits = logits.reshape(nWB, num_heads, n, n)
    attn = torch.softmax(logits, dim=-1).to(dt)
    attn = dropout(attn, cfg.attn_drop_rate, generator, deterministic)
    return torch.matmul(attn, v).transpose(1, 2).reshape(nWB, n, C)


def _swin_block(x, H, W, blk: SwinBlock, num_heads, window, shift,
                cfg: SwinConfig, generator=None, deterministic=True):
    """x: [B, H*W, C]."""
    B, _, C = x.shape
    dt = x.dtype
    shortcut = x
    x = layer_norm(x, blk.norm1.scale, blk.norm1.bias, cfg.norm_eps)
    x = x.reshape(B, H, W, C)
    mask = None
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _device_shift_mask(H, W, window, shift, x.device)
    wins = _window_partition(x, window)
    n = wins.shape[1]
    attn = blk.attn
    qkv = maybe_quantized_dot(wins, attn.qkv.kernel, attn.qkv.bias)
    bias = _gathered_rel_bias(attn, window, n, num_heads)
    if cfg.use_fused_apla:
        if cfg.attn_drop_rate > 0.0 and not deterministic:
            raise ValueError("the fused window kernel has no attention "
                             "dropout: train with use_fused_apla=False")
        wins = fused_swin_attention(qkv, attn.proj.kernel, attn.proj.bias,
                                    bias, mask, num_heads,
                                    (C // num_heads) ** -0.5).to(dt)
    else:
        wins = _swin_attention(qkv, bias, mask, num_heads, cfg, generator,
                               deterministic)
        wins = torch.matmul(wins, attn.proj.kernel.to(dt)) \
            + attn.proj.bias.to(dt)
    x = _window_reverse(wins, window, B, H, W)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x.reshape(B, H * W, C)

    y = layer_norm(x, blk.norm2.scale, blk.norm2.bias, cfg.norm_eps)
    y = maybe_quantized_dot(y, blk.mlp.fc1.kernel, blk.mlp.fc1.bias)
    y = F.gelu(y, approximate="none")
    y = maybe_quantized_dot(y, blk.mlp.fc2.kernel, blk.mlp.fc2.bias)
    return x + y


def swin_features(model: Swin, x, cfg: SwinConfig, generator=None,
                  deterministic=True):
    """x: [B, H, W, C] -> list of per-stage feature maps [B, Hs, Ws, Cs]
    (the mmdet-style pyramid), in `cfg.compute_dtype`.  Under FSDP
    (`parallel.mesh.shard_params`) each block's and each patch merging's
    frozen tensors are gathered for its span, the stem's and the norms'
    for the whole forward."""
    with gathered(model, exclude=tuple(model.stages)):
        return _stages(model, x, cfg, generator, deterministic)


def _stages(model: Swin, x, cfg: SwinConfig, generator, deterministic):
    dt = cfg.compute_dtype
    pe = model.patch_embed
    x = F.conv2d(x.to(dt).permute(0, 3, 1, 2),
                 pe.kernel.to(dt).permute(3, 2, 0, 1), stride=cfg.patch_size)
    x = x.permute(0, 2, 3, 1) + pe.bias.to(dt)
    B, H, W, C = x.shape
    x = x.reshape(B, H * W, C)
    if model.patch_norm is not None:
        x = layer_norm(x, model.patch_norm.scale, model.patch_norm.bias,
                       cfg.norm_eps)

    outs = []
    for s, stage in enumerate(model.stages):
        win = min(cfg.window_size, H, W)
        for i, blk in enumerate(stage.blocks):
            # odd blocks shift by window//2 unless one window covers the map
            shift = win // 2 if (i % 2 == 1 and min(H, W) > win) else 0
            with gathered(blk):
                x = _swin_block(x, H, W, blk, cfg.num_heads[s], win, shift,
                                cfg, generator, deterministic)
        norm = model.norms[s]
        outs.append(layer_norm(x, norm.scale, norm.bias,
                               cfg.norm_eps).reshape(B, H, W, -1))
        if stage.downsample is not None:
            # patch merging: 2x2 neighbourhood concat -> norm -> linear
            xm = x.reshape(B, H, W, -1)
            xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2],
                            xm[:, 0::2, 1::2], xm[:, 1::2, 1::2]], dim=-1)
            H, W = H // 2, W // 2
            xm = xm.reshape(B, H * W, -1)
            dsp = stage.downsample
            with gathered(dsp):
                xm = layer_norm(xm, dsp.norm.scale, dsp.norm.bias,
                                cfg.norm_eps)
                x = torch.matmul(xm, dsp.reduction.kernel.to(dt))
    return outs
