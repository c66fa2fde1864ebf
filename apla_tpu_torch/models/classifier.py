"""Classifier = ViT backbone + linear head.

Counterpart of `apla_tpu/models/classifier.py`.  The JAX package returns
(trainable, frozen) trees; here one `Classifier` module holds both, with
`requires_grad` marking the trainable part (the head always, plus the APLA
slices, the whole backbone for a full fine-tune, or nothing more for a
linear probe).
"""

from __future__ import annotations

import torch
from torch import nn

from ..apla.core import AplaConfig, build_apla
from .vit import (Dense, ViT, ViTConfig, fit_optional_leaves, init_vit_,
                  trunc_normal, vit_features)


class Classifier(nn.Module):
    def __init__(self, cfg: ViTConfig, n_classes: int,
                 num_pos_tokens: int | None = None):
        super().__init__()
        self.backbone = ViT(cfg, num_pos_tokens=num_pos_tokens)
        self.fc = Dense(cfg.embed_dim, n_classes)


def init_classifier(vit_cfg: ViTConfig, n_classes: int,
                    apla_cfg: AplaConfig | None = None,
                    freeze_backbone: bool = False, *,
                    generator: torch.Generator, device: torch.device):
    """A seeded `Classifier` on `device`.

    - apla_cfg given  -> backbone split per APLA; head trainable.
    - freeze_backbone -> linear probe: backbone frozen, head trainable.
    - neither         -> full fine-tune: everything trainable.

    `generator` is a CPU `torch.Generator`: the weights are drawn on the
    host and then moved, so one seed gives the same model on any device."""
    model = Classifier(vit_cfg, n_classes)
    init_vit_(model.backbone, generator)
    with torch.no_grad():
        model.fc.kernel.copy_(trunc_normal((vit_cfg.embed_dim, n_classes),
                                           generator))
    if apla_cfg is not None:
        build_apla(model.backbone, apla_cfg)
    elif freeze_backbone:
        model.backbone.requires_grad_(False)
    return model.to(device)


def classifier_from_state(vit_cfg: ViTConfig, trainable: dict, frozen: dict,
                          device: torch.device) -> Classifier:
    """Rebuild a `Classifier` from its state split as (trainable, frozen)
    name -> tensor maps (`utils.pretrained.params_from_jax` or a serving
    artifact).  Shapes come from the state: head width, pos-embed tokens,
    APLA rank, int8 kernels; so does the presence of the leaves an imported
    backbone may hold or lack (mask and register tokens, LayerScale, qkv
    biases)."""
    from ..ops.quant import quantize_like_state
    state = {**frozen, **trainable}
    model = Classifier(vit_cfg, int(state["fc.bias"].shape[0]),
                       num_pos_tokens=int(state["backbone.pos_embed"].shape[1]))
    fit_optional_leaves(model.backbone, {
        n[len("backbone."):]: t for n, t in state.items()
        if n.startswith("backbone.")})
    for i, blk in enumerate(model.backbone.blocks):
        inds = state.get(f"backbone.blocks.{i}.attn.inds")
        if inds is not None:
            blk.attn.add_apla(torch.zeros(inds.shape, dtype=torch.int64))
    quantize_like_state(model, state)
    model.load_state_dict(state, strict=True)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    return model.to(device)


def classifier_forward(model: Classifier, x, vit_cfg: ViTConfig,
                       return_embedding: bool = False,
                       deterministic: bool = True, generator=None):
    """[B, H, W, C] NHWC -> logits [B, n_classes] (and the embedding).  The
    head runs in the compute dtype.  `deterministic` / `generator`: see
    `vit_features`."""
    emb = vit_features(model.backbone, x, vit_cfg,
                       deterministic=deterministic, generator=generator)
    fc = model.fc
    logits = torch.matmul(emb, fc.kernel.to(emb.dtype)) + fc.bias.to(emb.dtype)
    if return_embedding:
        return logits, emb
    return logits
