"""Vision Transformer, inference path.

Counterpart of `apla_tpu/models/vit.py`.  The parameters live in
`nn.Module`s named after the JAX tree (`blocks.{i}.attn.qkv.kernel`, ...),
with the per-block parameters in an `nn.ModuleList` instead of a stacked
`[L, ...]` tree.  Kernels keep the JAX layout `[d_in, d_out]`; the patch
embedding kernel is HWIO `[P, P, 3, D]`; images are NHWC.  Parameters are
float32 and every op casts them to `cfg.compute_dtype`, as the JAX forward
does; LayerNorm statistics are taken in float32.

Deterministic only: dropout and drop-path rates are carried in the config
but the forward applies neither.  Not ported yet: `pack_segments`,
`pipeline`, `token_sharding`, remat, `vit_intermediate_layers`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import apla_attention, multi_head_attention
from ..ops.quant import maybe_quantized_dot


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    use_swiglu: bool = False
    has_layerscale: bool = False
    layerscale_init: float = 1e-5
    norm_eps: float = 1e-6
    num_register_tokens: int = 0
    compute_dtype: torch.dtype = torch.bfloat16
    use_flash: bool = False
    # attention + APLA projection through the hand-written fused kernel
    use_fused_apla: bool = False
    attn_segment_len: int = 0
    attn_logits_f32: bool = False
    gelu_tanh: bool = False

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.qk_scale if self.qk_scale is not None \
            else self.head_dim ** -0.5

    @property
    def mlp_hidden(self) -> int:
        h = int(self.embed_dim * self.mlp_ratio)
        if self.use_swiglu:
            h = (int(h * 2 / 3) + 7) // 8 * 8
        return h


def _builder(embed_dim, depth, num_heads, use_swiglu=False):
    def build(**kw):
        kw.setdefault("qkv_bias", True)
        kw.setdefault("use_swiglu", use_swiglu)
        return ViTConfig(embed_dim=embed_dim, depth=depth,
                         num_heads=num_heads, **kw)
    return build


VIT_BUILDERS = {
    "vit_tiny": _builder(192, 12, 3),
    "vit_small": _builder(384, 12, 6),
    "vit_base": _builder(768, 12, 12),
    "vit_large": _builder(1024, 24, 16),
    "vit_giant": _builder(1536, 40, 24, use_swiglu=True),
}


# --------------------------------------------------------------------------- #
# parameter containers
# --------------------------------------------------------------------------- #

def _param(*shape, fill=0.0):
    return nn.Parameter(torch.full(shape, float(fill)))


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = _param(d_in, d_out)
        self.bias = _param(d_out) if bias else None


class Norm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = _param(d, fill=1.0)
        self.bias = _param(d)


class LayerScale(nn.Module):
    def __init__(self, d: int, init: float):
        super().__init__()
        self.gamma = _param(d, fill=init)


class Attention(nn.Module):
    """Frozen qkv + projection; `add_apla` adds the trainable columns."""

    def __init__(self, d: int, qkv_bias: bool):
        super().__init__()
        self.qkv = Dense(d, 3 * d, bias=qkv_bias)
        self.proj = Dense(d, d)
        self.register_buffer("inds", None)
        self.register_parameter("proj_wt", None)
        self.register_parameter("proj_bt", None)

    def add_apla(self, inds: torch.Tensor) -> None:
        """Trainable copies of the projection's columns `inds` [k]."""
        inds = inds.to(device=self.proj.kernel.device, dtype=torch.int64)
        self.inds = inds
        self.proj_wt = nn.Parameter(
            self.proj.kernel.detach().index_select(1, inds).clone())
        self.proj_bt = nn.Parameter(
            self.proj.bias.detach().index_select(0, inds).clone())


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, swiglu: bool):
        super().__init__()
        if swiglu:
            self.w12 = Dense(d, 2 * hidden)
            self.w3 = Dense(hidden, d)
        else:
            self.fc1 = Dense(d, hidden)
            self.fc2 = Dense(hidden, d)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = Norm(d)
        self.attn = Attention(d, cfg.qkv_bias)
        self.norm2 = Norm(d)
        self.mlp = Mlp(d, cfg.mlp_hidden, cfg.use_swiglu)
        self.ls1 = LayerScale(d, cfg.layerscale_init) \
            if cfg.has_layerscale else None
        self.ls2 = LayerScale(d, cfg.layerscale_init) \
            if cfg.has_layerscale else None


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.kernel = _param(p, p, cfg.in_chans, cfg.embed_dim)   # HWIO
        self.bias = _param(cfg.embed_dim)


class ViT(nn.Module):
    """ViT parameters.  `num_pos_tokens` sizes `pos_embed` when it was
    trained on another grid than `cfg.img_size` (the dinov2 518 grid served
    at 224); the forward interpolates it to the input's grid."""

    def __init__(self, cfg: ViTConfig, num_pos_tokens: int | None = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = _param(1, 1, d)
        self.pos_embed = _param(1, num_pos_tokens or cfg.num_patches + 1, d)
        self.register_tokens = _param(1, cfg.num_register_tokens, d) \
            if cfg.num_register_tokens else None
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = Norm(d)


def trunc_normal(shape, generator: torch.Generator, std: float = 0.02):
    """Normal(0, std) truncated to [-2 std, 2 std] (inverse-CDF sampling,
    as `jax.random.truncated_normal`; the draws differ from JAX's)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
    return (z.clamp_(-2.0, 2.0) * std).float()


@torch.no_grad()
def init_vit_(vit: ViT, generator: torch.Generator) -> ViT:
    """The JAX package's init rule: truncated-normal (std 0.02) patch, cls,
    pos, register and dense kernels; zero biases; unit norms; LayerScale at
    `cfg.layerscale_init`.  In place on a CPU-resident `vit`."""
    for name, p in vit.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel" or name in ("cls_token", "pos_embed",
                                        "register_tokens"):
            p.copy_(trunc_normal(tuple(p.shape), generator))
    return vit


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #

def layer_norm(x, scale, bias, eps=1e-6):
    """LayerNorm computed in float32 regardless of compute dtype (biased
    variance, affine in f32), rounded back to x.dtype once at the end."""
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def _mlp(x, p: Mlp, cfg: ViTConfig):
    if cfg.use_swiglu:
        x12 = maybe_quantized_dot(x, p.w12.kernel, p.w12.bias)
        x1, x2 = x12.chunk(2, dim=-1)
        return maybe_quantized_dot(F.silu(x1) * x2, p.w3.kernel, p.w3.bias)
    h = maybe_quantized_dot(x, p.fc1.kernel, p.fc1.bias)
    h = F.gelu(h, approximate="tanh" if cfg.gelu_tanh else "none")
    return maybe_quantized_dot(h, p.fc2.kernel, p.fc2.bias)


def _block_forward(x, blk: Block, cfg: ViTConfig):
    """Pre-norm transformer block (APLA attention when the block has it)."""
    y = layer_norm(x, blk.norm1.scale, blk.norm1.bias, cfg.norm_eps)
    if blk.attn.inds is not None:
        y = apla_attention(
            y, blk.attn, cfg.num_heads, scale=cfg.scale,
            use_flash=cfg.use_flash, logits_f32=cfg.attn_logits_f32,
            use_fused=cfg.use_fused_apla, segment_len=cfg.attn_segment_len)
    else:
        y = multi_head_attention(
            y, blk.attn, cfg.num_heads, scale=cfg.scale,
            use_flash=cfg.use_flash, logits_f32=cfg.attn_logits_f32,
            segment_len=cfg.attn_segment_len)
    if blk.ls1 is not None:
        y = y * blk.ls1.gamma.to(y.dtype)
    x = x + y
    y = layer_norm(x, blk.norm2.scale, blk.norm2.bias, cfg.norm_eps)
    y = _mlp(y, blk.mlp, cfg)
    if blk.ls2 is not None:
        y = y * blk.ls2.gamma.to(y.dtype)
    return x + y


def _keys_cubic(x):
    """Keys cubic kernel, a = -0.5 (what `jax.image.resize` "bicubic"
    uses; torch's bicubic uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] float32 weights of `jax.image.resize(..., "bicubic",
    antialias=False)` along one axis: half-pixel sample positions, taps that
    fall outside the input dropped and the rest renormalised, samples
    outside [-0.5, n_in - 0.5] zeroed."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    w = _keys_cubic(x.abs())
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed, npatch: int, num_prefix: int = 1):
    """Bicubic pos-embed interpolation matching the JAX package's
    `jax.image.resize(..., "bicubic", antialias=False)`.

    `pos_embed` [1, N_orig + num_prefix, d] -> [1, npatch + num_prefix, d]."""
    n_orig = pos_embed.shape[1] - num_prefix
    if npatch == n_orig:
        return pos_embed
    prefix = pos_embed[:, :num_prefix]
    dim = pos_embed.shape[-1]
    gs_old, gs_new = int(math.sqrt(n_orig)), int(math.sqrt(npatch))
    grid = pos_embed[:, num_prefix:].reshape(gs_old, gs_old, dim).float()
    w = resize_weights(gs_old, gs_new).to(grid.device)       # [old, new]
    resized = torch.einsum("ai,abd,bj->ijd", w, grid, w)
    resized = resized.reshape(1, gs_new * gs_new, dim).to(pos_embed.dtype)
    return torch.cat([prefix, resized], dim=1)


def _prepare_tokens(vit: ViT, x, cfg: ViTConfig):
    """Patchify (NHWC in), prepend cls (+ register) tokens, add the
    (interpolated) pos embed."""
    dt = cfg.compute_dtype
    B = x.shape[0]
    x = x.to(dt).permute(0, 3, 1, 2)                          # NCHW
    kernel = vit.patch_embed.kernel.to(dt).permute(3, 2, 0, 1)  # OIHW
    x = F.conv2d(x, kernel, stride=cfg.patch_size)
    x = x.permute(0, 2, 3, 1) + vit.patch_embed.bias.to(dt)   # NHWC
    _, H, W, D = x.shape
    npatch = H * W
    x = x.reshape(B, npatch, D)
    cls = vit.cls_token.to(dt).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    pos = interpolate_pos_embed(vit.pos_embed, npatch, num_prefix=1)
    x = x + pos.to(dt)
    if cfg.num_register_tokens and vit.register_tokens is not None:
        reg = vit.register_tokens.to(dt).expand(B, cfg.num_register_tokens, D)
        x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    return x


def vit_features(vit: ViT, x, cfg: ViTConfig, return_all_tokens=False):
    """Run the ViT trunk on NHWC images [B, H, W, C].  Returns the
    final-norm cls token [B, d], or all tokens [B, N, d]."""
    x = _prepare_tokens(vit, x, cfg)
    for blk in vit.blocks:
        x = _block_forward(x, blk, cfg)
    x = layer_norm(x, vit.norm.scale, vit.norm.bias, cfg.norm_eps)
    return x if return_all_tokens else x[:, 0]
