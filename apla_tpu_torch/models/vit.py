"""Vision Transformer.

Counterpart of `apla_tpu/models/vit.py`.  The parameters live in
`nn.Module`s named after the JAX tree (`blocks.{i}.attn.qkv.kernel`, ...),
with the per-block parameters in an `nn.ModuleList` instead of a stacked
`[L, ...]` tree.  Kernels keep the JAX layout `[d_in, d_out]`; the patch
embedding kernel is HWIO `[P, P, 3, D]`; images are NHWC.  Parameters are
float32 and every op casts them to `cfg.compute_dtype`, as the JAX forward
does; LayerNorm statistics are taken in float32.

With `deterministic=False` and a `torch.Generator` the forward applies the
JAX package's token, attention, projection and MLP dropout (`drop_rate`,
`attn_drop_rate`) and drop-path at the per-block rates
`linspace(0, drop_path_rate, depth)`.  `masks` puts the iBOT mask token
(`mask_token`, a frozen parameter that only the DINOv2 model sets) in place
of masked patch embeddings; `pack_segments` runs the crops of each image as
one block-diagonal sequence.  Under FSDP (`parallel.mesh.shard_params`)
each block's frozen tensors are gathered for its forward and the trunk's
for the trunk; dropout and drop-path draw for the global batch
(`parallel.mesh.rand_rows`).  On a model axis (`ViT.placement`, set by
`shard_params`: JAX's `tp_sharding_tree` placement and `token_sharding`)
the blocks run tensor-parallel, and sequence-parallel between them
(`parallel.tensor`): token prep runs whole, the stream is split over the
model group, and the trunk's end gathers it back before the final norm.
With a pipeline (`ViT.pipeline`, set by `shard_params` with a
`parallel.pipeline.PipelineSpec`: JAX's `pipeline=`) the blocks run as
its stages (`parallel.pipeline.pipeline_blocks`); token prep and the final
norm stay outside it, on every stage.  Each block draws its dropout and
drop-path from a generator of its own (`parallel.mesh.block_seeds`), so a
pipeline stage draws what the one-rank trunk draws.  Not ported yet:
remat, `vit_intermediate_layers`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import apla_attention, dropout, multi_head_attention
from ..ops.quant import maybe_quantized_dot
from ..parallel import collectives, tensor as tp
from ..parallel.mesh import block_seeds, gathered, rand_rows, seeded
from ..parallel.pipeline import pipeline_blocks


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
    """`kernel` [d_in, d_out] (a parameter, or after W8A8 quantization an
    `ops.quant.QuantizedKernel` module in its place) and `bias` [d_out]."""

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
    at 224); the forward interpolates it to the input's grid.
    `placement`: the model axis it runs on (a `parallel.tensor.Placement`;
    None: whole on this rank); `pipeline`: the pipeline its trunk runs
    through (a `parallel.pipeline.PipelineSpec`; None: none)."""

    def __init__(self, cfg: ViTConfig, num_pos_tokens: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.placement = None
        self.pipeline = None
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = _param(1, 1, d)
        self.pos_embed = _param(1, num_pos_tokens or cfg.num_patches + 1, d)
        self.register_tokens = _param(1, cfg.num_register_tokens, d) \
            if cfg.num_register_tokens else None
        self.register_parameter("mask_token", None)   # iBOT, [1, 1, d]
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = Norm(d)


def fit_optional_leaves(vit: ViT, state: dict, keep_mask_token=False,
                        requires_grad=False) -> None:
    """Give `vit` exactly the optional leaves that `state` (names of the
    `ViT` module) holds: register and mask tokens, each block's LayerScale
    pair and qkv bias.  A leaf the state holds and `vit` lacks is added
    (zeros, `requires_grad` as given, on `vit`'s device); one it lacks goes,
    as the JAX forward reads what its tree holds (`keep_mask_token`: the
    mask token stays, as DINOv2 keeps its own over an import without
    one)."""
    device = vit.cls_token.device
    for leaf in ("mask_token", "register_tokens"):
        t = state.get(leaf)
        if t is None:
            if not (keep_mask_token and leaf == "mask_token"):
                setattr(vit, leaf, None)
        elif getattr(vit, leaf) is None:
            setattr(vit, leaf, nn.Parameter(torch.zeros(
                t.shape, device=device), requires_grad=requires_grad))
    for i, blk in enumerate(vit.blocks):
        if f"blocks.{i}.ls1.gamma" not in state:
            blk.ls1 = blk.ls2 = None
        elif blk.ls1 is None:
            blk.ls1, blk.ls2 = (
                LayerScale(vit.cfg.embed_dim, 0.0).to(device).requires_grad_(
                    requires_grad) for _ in range(2))
        if f"blocks.{i}.attn.qkv.bias" not in state:
            blk.attn.qkv.bias = None


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


def _dense(x, layer):
    return maybe_quantized_dot(x, layer.kernel, layer.bias)


def _mlp(x, p: Mlp, cfg: ViTConfig, generator, deterministic, drop=None,
         up=_dense, down=_dense, drop_hidden=None):
    """`drop(h)`: the output's dropout, `drop_hidden(h)` the hidden
    activations' (default both `dropout` at `cfg.drop_rate`; a model rank
    slices the whole tensor's draw); `up(x, layer)` / `down(h, layer)`:
    the first and second products (a model rank's column- and
    row-parallel ones, `parallel.tensor.mlp`)."""
    if cfg.use_swiglu:
        x1, x2 = up(x, p.w12).chunk(2, dim=-1)
        return down(F.silu(x1) * x2, p.w3)
    drop = drop or (lambda h: dropout(h, cfg.drop_rate, generator,
                                      deterministic))
    h = up(x, p.fc1)
    h = F.gelu(h, approximate="tanh" if cfg.gelu_tanh else "none")
    h = (drop_hidden or drop)(h)
    return drop(down(h, p.fc2))


def drop_path(x, rate: float, generator, deterministic: bool,
              segment_len: int = 0, tokens: tuple | None = None):
    """Stochastic depth on a residual branch: each sample (each packed
    segment when `segment_len` > 0) is kept with probability 1 - rate and
    scaled by 1 / (1 - rate) (`apla_tpu/models/vit.py:_drop_path`).
    `tokens` (n, start): x holds tokens [start, start + x.shape[1]) of a
    stream of n (sequence parallelism)."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    if segment_len:
        n, start = tokens or (x.shape[1], 0)
        n_seg = n // segment_len
        mask = rand_rows((x.shape[0], n_seg), generator=generator,
                         device=x.device) < keep
        mask = mask.repeat_interleave(segment_len, dim=1)[
            :, start:start + x.shape[1], None]
    else:
        mask = rand_rows((x.shape[0],) + (1,) * (x.ndim - 1),
                         generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path_rates(cfg: ViTConfig) -> list[float]:
    """Per-block drop-path rates, rising linearly from 0 to
    `drop_path_rate` over the depth (`apla_tpu/models/vit.py:378`)."""
    return torch.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()


def _block_forward_placed(x, blk: Block, cfg: ViTConfig, dp_rate, generator,
                          deterministic, pl, n: int):
    """`_block_forward` on a model axis (`parallel.tensor`): x holds the
    whole stream (TP) or the rank's tokens of a stream of n (SP)."""
    tokens = (n, collectives.own_tokens(n)[0]) if pl.sequence_parallel \
        else None
    seg = cfg.attn_segment_len
    y = layer_norm(x, blk.norm1.scale, blk.norm1.bias, cfg.norm_eps)
    y = tp.attention(y, blk.attn, cfg, generator, deterministic, pl, n, seg)
    if blk.ls1 is not None:
        y = y * blk.ls1.gamma.to(y.dtype)
    x = x + drop_path(y, dp_rate, generator, deterministic, seg, tokens)
    y = layer_norm(x, blk.norm2.scale, blk.norm2.bias, cfg.norm_eps)
    y = tp.mlp(y, blk.mlp, cfg, generator, deterministic, pl, n)
    if blk.ls2 is not None:
        y = y * blk.ls2.gamma.to(y.dtype)
    return x + drop_path(y, dp_rate, generator, deterministic, seg, tokens)


def _block_forward(x, blk: Block, cfg: ViTConfig, dp_rate: float = 0.0,
                   generator=None, deterministic: bool = True):
    """Pre-norm transformer block (APLA attention when the block has it)."""
    y = layer_norm(x, blk.norm1.scale, blk.norm1.bias, cfg.norm_eps)
    attn_kw = dict(scale=cfg.scale, attn_drop=cfg.attn_drop_rate,
                   proj_drop=cfg.drop_rate, generator=generator,
                   deterministic=deterministic, use_flash=cfg.use_flash,
                   logits_f32=cfg.attn_logits_f32,
                   segment_len=cfg.attn_segment_len)
    if blk.attn.inds is not None:
        y = apla_attention(y, blk.attn, cfg.num_heads,
                           use_fused=cfg.use_fused_apla, **attn_kw)
    else:
        y = multi_head_attention(y, blk.attn, cfg.num_heads, **attn_kw)
    if blk.ls1 is not None:
        y = y * blk.ls1.gamma.to(y.dtype)
    x = x + drop_path(y, dp_rate, generator, deterministic,
                      cfg.attn_segment_len)
    y = layer_norm(x, blk.norm2.scale, blk.norm2.bias, cfg.norm_eps)
    y = _mlp(y, blk.mlp, cfg, generator, deterministic)
    if blk.ls2 is not None:
        y = y * blk.ls2.gamma.to(y.dtype)
    return x + drop_path(y, dp_rate, generator, deterministic,
                         cfg.attn_segment_len)


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


def _prepare_tokens(vit: ViT, x, cfg: ViTConfig, generator=None,
                    deterministic: bool = True, masks=None):
    """Patchify (NHWC in), put the mask token at `masks` ([B, npatch]
    bool), prepend cls (+ register) tokens, add the (interpolated) pos
    embed, token dropout."""
    dt = cfg.compute_dtype
    B = x.shape[0]
    x = x.to(dt).permute(0, 3, 1, 2)                          # NCHW
    kernel = vit.patch_embed.kernel.to(dt).permute(3, 2, 0, 1)  # OIHW
    x = F.conv2d(x, kernel, stride=cfg.patch_size)
    x = x.permute(0, 2, 3, 1) + vit.patch_embed.bias.to(dt)   # NHWC
    _, H, W, D = x.shape
    npatch = H * W
    x = x.reshape(B, npatch, D)
    if masks is not None:
        token = vit.mask_token if vit.mask_token is not None \
            else torch.zeros((1, 1, D))
        x = torch.where(masks[..., None], token.to(device=x.device, dtype=dt),
                        x)
    cls = vit.cls_token.to(dt).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    pos = interpolate_pos_embed(vit.pos_embed, npatch, num_prefix=1)
    x = x + pos.to(dt)
    if cfg.num_register_tokens and vit.register_tokens is not None:
        reg = vit.register_tokens.to(dt).expand(B, cfg.num_register_tokens, D)
        x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    return dropout(x, cfg.drop_rate, generator, deterministic)


def vit_features(vit: ViT, x, cfg: ViTConfig, return_all_tokens=False,
                 deterministic: bool = True, generator=None, masks=None,
                 pack_segments: int = 0, return_layers: bool = False):
    """Run the ViT trunk on NHWC images [B, H, W, C].  Returns the
    final-norm cls token [B, d], or all tokens [B, N, d].  `return_layers`:
    (all final-norm tokens [B, N, d], every block's output before the final
    norm as a list of `depth` [B, N, d]), the JAX scan's `ys`.

    `deterministic=False` with a `torch.Generator` (on the images' device)
    draws dropout and drop-path masks from it.  `masks` [B, npatch] bool:
    the iBOT mask token replaces those patch embeddings.  `pack_segments`
    = s > 1: `x` holds s crops stacked crop-major ([s*B, h, w, C]); after
    token prep the s crops of each image run as one [B, s*T] sequence with
    block-diagonal attention, and come back as [s*B, ...]."""
    # FSDP: the trunk's own tensors whole for the trunk, each block's for
    # its block (`parallel.mesh.gathered`; a no-op when unsharded)
    with gathered(vit, exclude=(vit.blocks,)):
        return _trunk(vit, x, cfg, return_all_tokens, deterministic,
                      generator, masks, pack_segments, return_layers)


def _trunk(vit, x, cfg, return_all_tokens, deterministic, generator, masks,
           pack_segments, return_layers):
    x = _prepare_tokens(vit, x, cfg, generator, deterministic, masks)
    if pack_segments > 1:
        if return_layers:
            raise ValueError("return_layers is not supported with packing")
        sB, T, D = x.shape
        if sB % pack_segments:
            raise ValueError(f"{sB} crops do not split into {pack_segments} "
                             "segments per image")
        x = x.reshape(pack_segments, sB // pack_segments, T, D) \
            .transpose(0, 1).reshape(sB // pack_segments, pack_segments * T, D)
        cfg = dataclasses.replace(cfg, attn_segment_len=T)
    pl, n = vit.placement, x.shape[1]
    sp = pl is not None and pl.sequence_parallel
    draws = not deterministic and generator is not None and (
        cfg.drop_rate > 0 or cfg.attn_drop_rate > 0 or cfg.drop_path_rate > 0)
    seeds = block_seeds(generator, len(vit.blocks)) if draws \
        else [None] * len(vit.blocks)
    rates = drop_path_rates(cfg)
    dev = generator.device if draws else None
    spec = vit.pipeline
    if spec is not None and spec.n_stages > 1:
        if return_layers:
            raise ValueError("return_layers is not supported with the "
                             "pipeline")
        if pack_segments > 1:
            raise ValueError("crop packing + pipeline unsupported (the "
                             "packed block-diagonal sequence conflicts "
                             "with the pipeline's batch split)")
        if pl is not None:
            raise ValueError("sequence parallel + pipeline unsupported")

        def run_block(h, i, m):
            return _block_forward(h, vit.blocks[i], cfg, rates[i],
                                  seeded(seeds[i], dev), deterministic)

        stage = spec.stage_blocks(len(vit.blocks))
        params = [p for i in stage for p in vit.blocks[i].parameters()
                  if p.requires_grad]
        trainable = any(p.requires_grad for p in vit.blocks.parameters())
        with contextlib.ExitStack() as stack:
            for i in stage:          # FSDP: the stage's blocks whole
                stack.enter_context(gathered(vit.blocks[i]))
            x = pipeline_blocks(x, spec, len(vit.blocks), run_block, params,
                                deterministic, trainable)
        return _trunk_end(vit, x, cfg, return_all_tokens, pack_segments)
    if sp:
        x = collectives.split_tokens(x)
    layers = []
    for i, blk in enumerate(vit.blocks):
        gen = seeded(seeds[i], dev) if draws else generator
        with gathered(blk):
            if pl is None:
                x = _block_forward(x, blk, cfg, rates[i], gen,
                                   deterministic)
            else:
                x = _block_forward_placed(x, blk, cfg, rates[i], gen,
                                          deterministic, pl, n)
        if return_layers:
            layers.append(collectives.gather_trunk(x, n) if sp else x)
    if sp:
        x = collectives.gather_trunk(x, n)
    if return_layers:
        x = layer_norm(x, vit.norm.scale, vit.norm.bias, cfg.norm_eps)
        return x, layers
    return _trunk_end(vit, x, cfg, return_all_tokens, pack_segments)


def _trunk_end(vit, x, cfg, return_all_tokens, pack_segments):
    """The final norm, the crops unpacked, the cls token or every token."""
    x = layer_norm(x, vit.norm.scale, vit.norm.bias, cfg.norm_eps)
    if pack_segments > 1:
        Bb, _, D = x.shape
        x = x.reshape(Bb, pack_segments, -1, D).transpose(0, 1) \
            .reshape(Bb * pack_segments, -1, D)
    return x if return_all_tokens else x[:, 0]
