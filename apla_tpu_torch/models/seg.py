"""Semantic segmentation with an APLA-adapted ViT backbone (SETR-PUP).

Counterpart of `apla_tpu/models/seg.py`: the reference pairs an APLA-frozen
ViT with a SETR-PUP decoder (`apla_setr_vit-l_pup_8xb2-160k_ade20k-512x512`):
stages of conv3x3 + ReLU + bilinear x2 upsampling and a 1x1 classifier, and
optionally auxiliary decoders (2 stages) on intermediate trunk layers, their
losses joining at weight 0.4.  Convolutions keep the JAX layouts at the API
(NHWC maps, HWIO kernels) and run as `F.conv2d` on channels-last views.

The recipe's `partial_size: "full"` (every block's whole attention output
projection trainable) keeps JAX's split: each block's `proj.kernel` /
`proj.bias` train in place, held once.  Each block also gets `attn.inds` =
0..C-1 as a non-persistent buffer (`build_seg_apla`; never in a
checkpoint), so the block takes `apla_attention` with the projection as
its rank-C trainable columns: it computes what JAX's "full" block computes
(the attention, then x @ W + b), and with `use_fused_apla` it runs through
the fused APLA attention kernels at k = C, the role of the TPU's long
q-strip kernels at ViT-L/16 @ 512.

`jax.image.resize(..., "bilinear")` is `F.interpolate(..., "bilinear",
align_corners=False)` when upsampling: JAX renormalises the weights of
taps that fall outside the input, which picks the edge pixel, as torch's
clamp does (tests hold the two together at x2, x4 and other factors); a
reduction takes torch's antialiased filter, JAX's default.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..apla.core import AplaConfig, build_apla
from ..parallel.collectives import loss_normaliser, pmean, reduce_gradients
from ..train.optim import Optimizer, global_norm
from .detection import Conv, _conv
from .vit import ViT, ViTConfig, init_vit_, trunc_normal, vit_features


class PUPHead(nn.Module):
    """SETR-PUP decoder: `n_stages` conv3x3 (each followed by ReLU and a x2
    bilinear upsample), then a 1x1 classifier.  Names follow the JAX tree:
    `convs.{i}.kernel` [3, 3, c_in, c_out], `cls.kernel` [1, 1, c, K]."""

    def __init__(self, embed_dim: int, n_classes: int, channels: int = 256,
                 n_stages: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv(3, embed_dim if i == 0 else channels, channels)
            for i in range(n_stages))
        self.cls = Conv(1, channels, n_classes)


class Segmenter(nn.Module):
    """`backbone` (the APLA ViT), `head` (PUP), `aux_heads` (2-stage PUP
    decoders on the layers at `aux_indices`)."""

    def __init__(self, vit_cfg: ViTConfig, n_classes: int,
                 channels: int = 256, n_aux_heads: int = 0,
                 aux_channels: int = 256):
        super().__init__()
        if n_aux_heads > len(AUX_FRACTIONS):
            raise ValueError(f"at most {len(AUX_FRACTIONS)} aux heads")
        self.backbone = ViT(vit_cfg)
        self.head = PUPHead(vit_cfg.embed_dim, n_classes, channels)
        self.aux_heads = nn.ModuleList(
            PUPHead(vit_cfg.embed_dim, n_classes, aux_channels, n_stages=2)
            for _ in range(n_aux_heads))


# The reference SETR's 3 auxiliary heads sit at fractional trunk depths
# (mmseg out_indices (9, 14, 19, 23) for ViT-L/24: floor(f * depth) for
# f in 0.4 / 0.6 / 0.8, plus the final layer)
AUX_FRACTIONS = (0.4, 0.6, 0.8)


def aux_indices(depth: int, n_aux: int):
    return [min(depth - 1, int(f * depth)) for f in AUX_FRACTIONS[:n_aux]]


@torch.no_grad()
def init_pup_head(head: PUPHead, generator) -> PUPHead:
    """The JAX init: truncated-normal (std 0.02) kernels, zero biases."""
    for conv in list(head.convs) + [head.cls]:
        conv.kernel.copy_(trunc_normal(tuple(conv.kernel.shape), generator,
                                       std=0.02))
        conv.bias.zero_()
    return head


def build_seg_apla(vit: ViT, apla_cfg: AplaConfig) -> ViT:
    """The APLA split of the segmenter's ViT (`build_apla`); under
    `partial_size: "full"` each block also gets `attn.inds` = 0..C-1, not
    stored (module docstring)."""
    build_apla(vit, apla_cfg)
    if apla_cfg.partial_size == "full":
        for blk in vit.blocks:
            blk.attn.register_buffer(
                "inds", torch.arange(vit.cfg.embed_dim,
                                     device=blk.attn.proj.kernel.device),
                persistent=False)
    return vit


@torch.no_grad()
def init_segmenter(vit_cfg: ViTConfig, n_classes: int,
                   apla_cfg: AplaConfig | None = None, channels: int = 256,
                   n_aux_heads: int = 0, aux_channels: int = 256,
                   generator: torch.Generator | None = None,
                   device=None) -> Segmenter:
    """A `Segmenter` with the JAX init rule (random weights from
    `generator`) and the APLA split; `apla_cfg=None` is the reference
    recipe's `partial_size: "full"`."""
    generator = generator or torch.Generator().manual_seed(0)
    model = Segmenter(vit_cfg, n_classes, channels, n_aux_heads,
                      aux_channels)
    init_vit_(model.backbone, generator)
    build_seg_apla(model.backbone, apla_cfg or AplaConfig(partial_size="full"))
    init_pup_head(model.head, generator)
    for head in model.aux_heads:
        init_pup_head(head, generator)
    return model.to(device) if device is not None else model


def _token_grid(tokens, vit_cfg: ViTConfig):
    """[B, 1 + registers + g*g, D] tokens -> [B, g, g, D] patch grid."""
    patches = tokens[:, 1 + vit_cfg.num_register_tokens:]
    B, N, D = patches.shape
    g = int(round(N ** 0.5))
    return patches.reshape(B, g, g, D)


def resize_bilinear(x, out_hw):
    """NHWC `x` -> [B, *out_hw, C] in x.dtype, as `jax.image.resize(x,
    ..., "bilinear")` (half-pixel centres; antialiased when reducing)."""
    out_hw = tuple(int(v) for v in out_hw)
    down = out_hw[0] < x.shape[1] or out_hw[1] < x.shape[2]
    # the antialiased filter in float32 (torch has no bf16 one on the CPU)
    y = F.interpolate(x.permute(0, 3, 1, 2).float() if down
                      else x.permute(0, 3, 1, 2), size=out_hw,
                      mode="bilinear", align_corners=False, antialias=down)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def pup_head_forward(feat, head: PUPHead, out_hw):
    """feat [B, h, w, D] patch-feature grid -> logits [B, H, W, n_classes]
    float32: each stage conv3x3 + ReLU + x2 bilinear upsample in feat's
    dtype, the 1x1 classifier, then a float32 resize to `out_hw` where the
    stages did not reach it."""
    x = feat
    for conv in head.convs:
        x = F.relu(_conv(x, conv))
        x = resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]))
    x = _conv(x, head.cls)
    if tuple(x.shape[1:3]) != tuple(out_hw):
        x = resize_bilinear(x.float(), out_hw)
    return x.float()


def segmenter_forward(model: Segmenter, images, vit_cfg: ViTConfig,
                      generator=None, deterministic: bool = True):
    """images [B, H, W, 3] -> per-pixel logits [B, H, W, n_classes]."""
    tokens = vit_features(model.backbone, images, vit_cfg,
                          return_all_tokens=True, generator=generator,
                          deterministic=deterministic)
    return pup_head_forward(_token_grid(tokens, vit_cfg), model.head,
                            images.shape[1:3])


def segmenter_forward_train(model: Segmenter, images, vit_cfg: ViTConfig,
                            generator=None, deterministic: bool = True):
    """Main and auxiliary logits from one trunk pass (the aux heads read
    the blocks' outputs at `aux_indices`): (main [B, H, W, K], [aux_i])."""
    if not len(model.aux_heads):
        return segmenter_forward(model, images, vit_cfg, generator,
                                 deterministic), []
    tokens, layers = vit_features(model.backbone, images, vit_cfg,
                                  generator=generator,
                                  deterministic=deterministic,
                                  return_layers=True)
    out_hw = images.shape[1:3]
    main = pup_head_forward(_token_grid(tokens, vit_cfg), model.head, out_hw)
    aux = [pup_head_forward(_token_grid(layers[idx], vit_cfg), head, out_hw)
           for head, idx in zip(model.aux_heads,
                                aux_indices(vit_cfg.depth,
                                            len(model.aux_heads)))]
    return main, aux


def slide_stride(crop: int, stride=None) -> int:
    """Default 2/3-crop stride (the reference's 341/512); a given stride
    must lie in (0, crop] (a larger one would leave pixels uncovered)."""
    stride = int(stride) if stride else max(1, (2 * crop) // 3)
    if not 0 < stride <= crop:
        raise ValueError(f"slide stride must be in (0, crop={crop}], "
                         f"got {stride}")
    return stride


def slide_starts(full: int, crop: int, stride: int):
    """Window offsets covering [0, full): stride steps, the last window
    flushed to the edge."""
    ss = list(range(0, full - crop + 1, stride))
    if ss[-1] != full - crop:
        ss.append(full - crop)
    return ss


def segmenter_slide_forward(model: Segmenter, images, vit_cfg: ViTConfig,
                            stride: int | None = None):
    """Sliding-window inference (the reference recipe's test_cfg
    mode='slide', crop 512, stride 341): the backbone runs at its training
    crop (`vit_cfg.img_size`) over a larger image, window logits summed and
    averaged where windows overlap.  images [B, H, W, 3], H, W >= crop."""
    crop = int(vit_cfg.img_size)
    B, H, W, _ = images.shape
    if H < crop or W < crop:
        raise ValueError(f"eval image {H}x{W} smaller than crop {crop}")
    stride = slide_stride(crop, stride)
    out = cnt = None
    for y in slide_starts(H, crop, stride):
        for x in slide_starts(W, crop, stride):
            logits = segmenter_forward(
                model, images[:, y:y + crop, x:x + crop], vit_cfg)
            if out is None:
                out = logits.new_zeros((B, H, W, logits.shape[-1]))
                cnt = logits.new_zeros((B, H, W, 1))
            out[:, y:y + crop, x:x + crop] += logits
            cnt[:, y:y + crop, x:x + crop] += 1.0
    return out / cnt


def segmentation_loss(logits, labels, ignore_index: int = 255):
    """Per-pixel cross-entropy over the pixels whose label is not
    `ignore_index`, divided by max(their count, 1): a batch with every
    pixel ignored gives 0 (mean-reduced `F.cross_entropy` gives NaN).
    With more than one rank the count is the global batch's
    (`parallel.collectives.loss_normaliser`)."""
    labels = labels.reshape(-1).long()
    n_valid = loss_normaliser((labels != ignore_index).sum())
    ce = F.cross_entropy(logits.float().reshape(labels.numel(), -1), labels,
                         ignore_index=ignore_index, reduction="sum")
    return ce / n_valid


def iou_counts(pred, labels, n_classes: int, ignore_index: int = 255):
    """Per-class (intersection, union) pixel counts of one batch, int64 on
    the host; summed over batches and divided once, they give the
    dataset-level mIoU.  The JAX package's per-class loop as bincounts
    (the same integers)."""
    pred = np.asarray(pred).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    valid = labels != ignore_index
    pred, labels = pred[valid].astype(np.int64), labels[valid].astype(
        np.int64)

    def count(v):
        return np.bincount(v[(v >= 0) & (v < n_classes)],
                           minlength=n_classes)[:n_classes]

    inter = count(labels[pred == labels])
    union = count(pred) + count(labels) - inter
    return inter.astype(np.int64), union.astype(np.int64)


def mean_iou_from_counts(inter, union):
    inter, union = np.asarray(inter), np.asarray(union)
    present = union > 0
    if not present.any():
        return 0.0
    return float(np.mean(inter[present] / union[present]))


def mean_iou(pred, labels, n_classes: int, ignore_index: int = 255):
    """mIoU over a batch (host-side numpy)."""
    return mean_iou_from_counts(
        *iou_counts(pred, labels, n_classes, ignore_index=ignore_index))


def seg_optimizer(model: Segmenter, lr: float, weight_decay: float,
                  head_lr_mult: float = 1.0) -> Optimizer:
    """optax.adamw(lr, weight_decay) over the trainable backbone tensors
    and optax.adamw(lr * head_lr_mult, weight_decay) over the head and the
    aux heads (the JAX loop's `optax.multi_transform`; one adamw when the
    multiplier is 1, the same update): no decay mask, no clip."""
    backbone = [p for p in model.backbone.parameters() if p.requires_grad]
    heads = [p for name, p in model.named_parameters()
             if p.requires_grad and not name.startswith("backbone.")]
    groups = [{"params": backbone, "lr": lr},
              {"params": heads, "lr": lr * head_lr_mult}]
    return Optimizer(torch.optim.AdamW(
        [{**g, "weight_decay": weight_decay, "decay": True}
         for g in groups if g["params"]],
        lr=lr, betas=(0.9, 0.999), eps=1e-8), None)


def make_seg_train_step(vit_cfg: ViTConfig, optimizer: Optimizer,
                        aux_weight: float = 0.4):
    """The segmentation train step: forward (main + aux heads), per-pixel
    CE with the aux losses at `aux_weight`, one optimizer update of the
    trainable tensors.  `step(model, batch)` takes {"image" [B, H, W, 3],
    "label" [B, H, W]} on the model's device and returns {"loss",
    "grad_norm"} (optax's global_norm of the gradients)."""

    def step(model: Segmenter, batch):
        labels = batch["label"]
        main, aux = segmenter_forward_train(model, batch["image"], vit_cfg)
        loss = segmentation_loss(main, labels)
        for a in aux:
            loss = loss + aux_weight * segmentation_loss(a, labels)
        optimizer.opt.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(optimizer.params)
        g_norm = global_norm([p.grad for p in optimizer.params])
        optimizer.step(g_norm)
        return {"loss": pmean(loss.detach()), "grad_norm": g_norm.detach()}

    return step
