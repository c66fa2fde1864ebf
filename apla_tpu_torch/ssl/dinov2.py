"""DINOv2 self-supervised adaptation (DINO cls loss + iBOT masked-patch loss
+ KoLeo), with APLA on student and teacher.

Counterpart of `apla_tpu/ssl/dinov2.py`: the DINOv2 cosine schedule tables,
the iBOT block masking and its fixed-size mask collate, the losses, the
train step (accumulation included) and the wrapper and trainer.

- The student is one `DINOv2Model` (backbone + DINO head [+ iBOT head]).
  The teacher is the EMA twin of the trainable tensors only: the frozen
  weights are shared, and the teacher's forward runs on the student's
  modules with the teacher's tensors swapped in (`weights_swapped`), so
  teacher memory scales with the APLA rank and the heads.
- `fused_proto_ce` ("ibot", true/"all" or false) sends the iBOT site (and
  with true/"all" the DINO sites) through `ops.proto_ce`: on a CUDA tensor
  its kernels, on a CPU tensor their plain version.  The JAX package's
  TPU-only gate `proto_ce_available()` has no counterpart: the mode says
  which sites take the kernel path.
- Masks: the collate is a picklable class whose numpy generator is keyed
  by (seed, epoch * batches_per_epoch + batch index), which is the JAX
  collate's call counter when batches are collated in order; the port's
  loader collates in worker processes, out of order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..data.device_augs import device_multicrop
from ..models.vit import VIT_BUILDERS, ViT, trunc_normal, \
    vit_features
from ..ops.proto_ce import proto_ce
from ..train.optim import build_optimizer, global_norm
from ..train.train_state import TrainState, weights_swapped
from ..utils.config import EDict
from .byol import BYOLTrainer, ema_update
from .dino import DINOWrapper, zero_grads_of
from .heads import (DINOHead, dino_head_bottleneck, dino_head_forward,
                    dino_head_last_w, init_dino_head)
from .multicrop import resolve_strategy_spec


# --------------------------------------------------------------------------- #
# schedules (reference dinov2_utils.py CosineScheduler, trainer.py
# build_schedulers)
# --------------------------------------------------------------------------- #

class CosineScheduler:
    def __init__(self, base_value, final_value, total_iters, warmup_iters=0,
                 start_warmup_value=0, freeze_iters=0):
        self.final_value = final_value
        self.total_iters = total_iters
        freeze = np.zeros((freeze_iters,))
        warmup = np.linspace(start_warmup_value, base_value, warmup_iters)
        n = max(total_iters - warmup_iters - freeze_iters, 0)
        it = np.arange(n)
        core = final_value + 0.5 * (base_value - final_value) * \
            (1 + np.cos(np.pi * it / max(len(it), 1)))
        self.schedule = np.concatenate((freeze, warmup, core))

    def __getitem__(self, it):
        if it >= self.total_iters:
            return self.final_value
        return float(self.schedule[it])


def build_schedulers(optim_params, training_params, teacher_params,
                     iters_per_epoch, total_iters):
    """lr, wd, EMA momentum, teacher temperature and last-layer lr tables."""
    warmup = int(optim_params.scheduler.params.LinearWarmup.warmup_epochs) \
        * iters_per_epoch
    base_lr = float(optim_params.optimizer.params.lr)
    eta_min = float(optim_params.scheduler.params.CosineAnnealingLR.eta_min)
    lr = CosineScheduler(start_warmup_value=0, base_value=base_lr,
                         final_value=eta_min, total_iters=total_iters,
                         warmup_iters=warmup)
    wd = CosineScheduler(
        base_value=float(optim_params.optimizer.params.weight_decay),
        final_value=1e-4, total_iters=total_iters)
    momentum = CosineScheduler(
        base_value=float(teacher_params.momentum_teacher),
        final_value=float(teacher_params.final_momentum_teacher),
        total_iters=total_iters)
    warm_iters = int(teacher_params.warmup_teacher_temp_epochs) \
        * iters_per_epoch
    teacher_temp = CosineScheduler(
        start_warmup_value=float(teacher_params.warmup_teacher_temp),
        base_value=float(teacher_params.teacher_temp),
        final_value=float(teacher_params.teacher_temp),
        total_iters=max(warm_iters, 1), warmup_iters=max(warm_iters, 1))
    last_layer_lr = CosineScheduler(start_warmup_value=0, base_value=base_lr,
                                    final_value=eta_min,
                                    total_iters=total_iters,
                                    warmup_iters=warmup)
    freeze_iters = int(training_params.get("freeze_last_layer_epochs", 1)) \
        * iters_per_epoch
    last_layer_lr.schedule[:freeze_iters] = 0
    return lr, wd, momentum, teacher_temp, last_layer_lr


# --------------------------------------------------------------------------- #
# iBOT masking (reference dinov2_utils.py:21-140)
# --------------------------------------------------------------------------- #

class MaskingGenerator:
    """Block-wise mask sampler."""

    def __init__(self, input_size, num_masking_patches=None,
                 min_num_patches=4, max_num_patches=None, min_aspect=0.3,
                 max_aspect=None):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask(self, mask, max_mask_patches, rng):
        delta = 0
        for _ in range(10):
            target_area = rng.uniform(
                min(self.min_num_patches, max_mask_patches), max_mask_patches)
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = rng.integers(0, self.height - h + 1)
                left = rng.integers(0, self.width - w + 1)
                region = mask[top:top + h, left:left + w]
                num_masked = region.sum()
                if 0 < h * w - num_masked <= max_mask_patches:
                    region[:] = True
                    delta += h * w - num_masked
                if delta > 0:
                    break
        return delta

    def __call__(self, num_masking_patches=0, rng=None):
        rng = rng or np.random.default_rng()
        mask = np.zeros((self.height, self.width), dtype=bool)
        count = 0
        while count < num_masking_patches:
            max_patches = min(num_masking_patches - count,
                              self.max_num_patches or num_masking_patches)
            delta = self._mask(mask, max_patches, rng)
            if delta == 0:
                break
            count += delta
        return mask


class IBotCollate:
    """Static-shape iBOT collate (`make_ibot_collate`): stacked crops (or,
    in `raw_mode`, the raw images) and fixed-size masked-patch buffers of
    `n_global * B * n_masked_max` rows, padding rows weighted 0.

    Picklable (it runs in the loader's worker processes).  The mask draws
    come from `np.random.default_rng((seed, epoch * batches_per_epoch +
    batch index))`, the JAX collate's (seed, call counter)."""

    def __init__(self, n_global_crops, n_local_crops, mask_ratio_tuple,
                 mask_probability, n_tokens, mask_generator,
                 n_masked_max=None, raw_mode=False, seed=0,
                 batches_per_epoch=1):
        self.n_global, self.n_local = n_global_crops, n_local_crops
        self.mask_ratio_tuple = tuple(mask_ratio_tuple)
        self.mask_probability = float(mask_probability)
        self.n_tokens = n_tokens
        self.mask_generator = mask_generator
        self.n_masked_max = n_masked_max if n_masked_max is not None \
            else int(math.ceil(n_tokens * mask_ratio_tuple[1]))
        self.raw_mode = raw_mode
        self.seed = seed
        self.batches_per_epoch = batches_per_epoch

    def __call__(self, samples_list, rng=None, batch_key=(0, 0)):
        del rng
        epoch, bi = batch_key
        rng = np.random.default_rng(
            (self.seed, epoch * self.batches_per_epoch + bi))
        B = len(samples_list)
        ng, nl, n_tokens = self.n_global, self.n_local, self.n_tokens
        out = {}
        if self.raw_mode:
            out["raw_images"] = np.stack([s["image"] for s in samples_list])
        else:
            out["collated_global_crops"] = np.stack(
                [s["image"][i] for i in range(ng)
                 for s in samples_list]).astype(np.float32)
            if nl:
                out["collated_local_crops"] = np.stack(
                    [s["image"][i] for i in range(ng, ng + nl)
                     for s in samples_list]).astype(np.float32)
        labels = np.asarray([s["label"] for s in samples_list])

        BG = ng * B
        n_samples_masked = int(BG * self.mask_probability)
        probs = np.linspace(*self.mask_ratio_tuple, n_samples_masked + 1)
        masks_list = []
        for i in range(n_samples_masked):
            n_mask = int(n_tokens * rng.uniform(probs[i], probs[i + 1]))
            masks_list.append(self.mask_generator(n_mask, rng=rng).flatten())
        for _ in range(n_samples_masked, BG):
            masks_list.append(np.zeros(n_tokens, dtype=bool))
        order = rng.permutation(BG)
        masks = np.stack([masks_list[i] for i in order])       # [BG, N]

        upper = BG * self.n_masked_max
        flat_idx = np.flatnonzero(masks.flatten())
        n_masked = len(flat_idx)
        mask_indices = np.zeros(upper, dtype=np.int32)
        mask_indices[:n_masked] = flat_idx[:upper]
        valid = np.zeros(upper, dtype=np.float32)
        valid[:min(n_masked, upper)] = 1.0
        row_counts = np.clip(masks.sum(-1), 1, None)
        weights_full = (1.0 / row_counts)[:, None] * np.ones_like(masks, float)
        masks_weight = np.zeros(upper, dtype=np.float32)
        masks_weight[:n_masked] = weights_full.flatten()[flat_idx][:upper]
        out.update({
            "collated_masks": masks,
            "mask_indices_list": mask_indices,
            "masks_weight": masks_weight,
            "mask_valid": valid,
            "n_masked_patches": np.asarray([min(n_masked, upper)], np.int32),
            "label": labels,
        })
        return out


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #

def softmax_center_teacher(t_out, center, teacher_temp):
    return torch.softmax((t_out - center) / teacher_temp, dim=-1)


def sinkhorn_knopp_teacher(t_out, teacher_temp, n_iterations=3,
                           sample_mask=None):
    """Sinkhorn-Knopp assignment; `sample_mask` [B] zeroes padded rows
    before normalisation."""
    Q = torch.exp(t_out.float() / teacher_temp).t()            # [K, B]
    if sample_mask is not None:
        Q = Q * sample_mask[None, :]
        B = torch.clamp(sample_mask.sum(), min=1.0)
    else:
        B = Q.shape[1]
    K = Q.shape[0]

    def safe_div(q, s):
        # guard exact zeros only (padded rows/cols)
        return q / torch.where(s == 0.0, torch.ones_like(s), s)

    Q = Q / Q.sum()
    for _ in range(n_iterations):
        Q = safe_div(Q, Q.sum(dim=1, keepdim=True)) / K
        Q = safe_div(Q, Q.sum(dim=0, keepdim=True)) / B
        if sample_mask is not None:
            Q = Q * sample_mask[None, :]
    return (Q * B).t()


def dinov2_dino_loss(student_out_list, teacher_softmaxed_list,
                     student_temp=0.1):
    """Sum of CE over all (student chunk, teacher chunk) pairs."""
    total = 0.0
    for s in student_out_list:
        lsm = torch.log_softmax(s.float() / student_temp, dim=-1)
        for t in teacher_softmaxed_list:
            total = total - torch.mean(torch.sum(t.detach() * lsm, dim=-1))
    return total


def ibot_patch_loss(student_masked, teacher_softmaxed_masked, masks_weight,
                    n_images, student_temp=0.1):
    """Masked-patch CE, weight-normalised per image; padding rows weigh
    0."""
    lsm = torch.log_softmax(student_masked.float() / student_temp, dim=-1)
    per_patch = torch.sum(teacher_softmaxed_masked.detach() * lsm, dim=-1)
    return -torch.sum(per_patch * masks_weight) / n_images


def koleo_loss(x, eps=1e-8):
    """Kozachenko-Leonenko regulariser."""
    x = x.float()
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    dots = torch.matmul(x, x.t())
    n = x.shape[0]
    dots = dots - 2.0 * torch.eye(n, device=x.device)
    nn_idx = torch.argmax(dots, dim=1)
    diff = x - x[nn_idx]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps * eps)
    return -torch.mean(torch.log(dist + eps))


# --------------------------------------------------------------------------- #
# model, state and train step
# --------------------------------------------------------------------------- #

class DINOv2Model(nn.Module):
    """The student: ViT backbone (APLA-split) + DINO head [+ iBOT head]."""

    def __init__(self, backbone: ViT, dino_head: DINOHead,
                 ibot_head: DINOHead | None = None):
        super().__init__()
        self.backbone = backbone
        self.dino_head = dino_head
        self.ibot_head = ibot_head


@dataclasses.dataclass
class DINOv2TrainState(TrainState):
    """`TrainState` plus the EMA teacher (name -> tensor, one per trainable
    parameter) and the two centers [1, K]."""
    teacher: dict
    dino_center: torch.Tensor
    ibot_center: torch.Tensor

    def aux(self) -> dict:
        """What a checkpoint keeps beside the trainable tensors."""
        out = {f"teacher.{n}": t for n, t in self.teacher.items()}
        out["dino_center"] = self.dino_center
        out["ibot_center"] = self.ibot_center
        return out

    @torch.no_grad()
    def load_aux(self, aux: dict) -> None:
        for n, t in self.teacher.items():
            t.copy_(aux[f"teacher.{n}"])
        self.dino_center.copy_(aux["dino_center"])
        self.ibot_center.copy_(aux["ibot_center"])


def _split_rows(x, sizes):
    return list(torch.split(x, list(sizes), dim=0))


def make_dinov2_train_step(vit_cfg, optimizer, cfg: EDict, n_global: int,
                           n_local: int, freeze_last_layer: bool,
                           device_crop_cfgs=None, accum_steps: int = 1,
                           pack_local_crops: bool = False):
    """Returns train_step(state, batch, lr, wd, momentum, teacher_temp,
    generator) -> (state, metrics) (`apla_tpu/ssl/dinov2.py:342-743`).

    `cfg`: the `model_params.dinov2` subtree.  `batch` holds device tensors:
    `raw_images` with `device_crop_cfgs` (all crops made on the device from
    `generator`), else `collated_global_crops` [+ `collated_local_crops`];
    and the collate's mask buffers.  The teacher runs on the full batch;
    with `accum_steps` > 1 the student runs over micro-batches with the
    iBOT indices rebased into each micro-batch's patch space, and the
    gradients are averaged before one update."""
    dino_w = float(cfg.dino.loss_weight)
    koleo_w = float(cfg.dino.koleo_loss_weight)
    ibot_w = float(cfg.ibot.loss_weight)
    separate_head = bool(cfg.ibot.get("separate_head", False))
    centering = cfg.get("centering", "centering")
    head_mm_bf16 = bool(cfg.get("head_matmul_bf16", False))
    fused_mode = cfg.get("fused_proto_ce", False)
    if fused_mode not in (False, None, True, "all", "ibot"):
        # a typo ("iBOT", quoted "true", ...) must not silently drop the
        # kernels back to dense math
        raise ValueError(
            f"fused_proto_ce: {fused_mode!r} — expected true/'all' (fuse "
            "every site) or 'ibot' (fuse only the iBOT patch loss)")
    fused_dino = fused_ibot = False
    if fused_mode and centering == "centering":
        fused_dino = fused_mode in (True, "all")
        fused_ibot = fused_mode in (True, "all", "ibot")
    do_dino, do_ibot, do_koleo = dino_w > 0, ibot_w > 0, koleo_w > 0
    center_momentum = 0.9
    student_temp = 0.1
    n_reg = vit_cfg.num_register_tokens

    def project(x, w):
        if head_mm_bf16:
            return torch.matmul(x.to(torch.bfloat16).float(),
                                w.to(torch.bfloat16).float())
        return torch.matmul(x, w)

    def teacher_targets(state, g_crops, mask_idx, mask_valid, teacher_temp):
        """Teacher outputs on the full batch (no grad): the DINO and iBOT
        targets (softmaxed, or bottlenecks at fused sites), the fused
        sites' prototype layers and the new centers."""
        model = state.model
        with torch.no_grad(), weights_swapped(state.trainable(),
                                              state.teacher):
            t_tokens = vit_features(model.backbone, g_crops, vit_cfg,
                                    return_all_tokens=True)
            t_cls = t_tokens[:, 0]
            t_patches = t_tokens[:, 1 + n_reg:]
            # swap the global chunks so crop A pairs with crop B
            t_cls_swapped = torch.cat(t_cls.chunk(n_global)[::-1], dim=0)
            t_masked = t_patches.reshape(-1, t_patches.shape[-1])[mask_idx]
            ihead = model.ibot_head if separate_head else model.dino_head
            wt_dino = wt_ibot = None
            dino_c, ibot_c = state.dino_center, state.ibot_center
            if centering == "centering":
                # fused sites keep teacher bottlenecks; the center EMA
                # uses linearity: mean_rows(X W) = mean_rows(X) W
                if fused_dino:
                    t_dino = dino_head_bottleneck(t_cls_swapped,
                                                  model.dino_head)
                    wt_dino = dino_head_last_w(model.dino_head)
                    new_dino_center = dino_c * center_momentum + torch.matmul(
                        t_dino.mean(dim=0, keepdim=True), wt_dino) \
                        * (1 - center_momentum)
                else:
                    t_cls_out = dino_head_forward(t_cls_swapped,
                                                  model.dino_head,
                                                  matmul_bf16=head_mm_bf16)
                    t_dino = softmax_center_teacher(t_cls_out, dino_c,
                                                    teacher_temp)
                    new_dino_center = dino_c * center_momentum + \
                        t_cls_out.mean(dim=0, keepdim=True) \
                        * (1 - center_momentum)
                denom = torch.clamp(mask_valid.sum(), min=1.0)
                if fused_ibot:
                    t_ibot = dino_head_bottleneck(t_masked, ihead)
                    wt_ibot = dino_head_last_w(ihead)
                    new_ibot_center = ibot_c * center_momentum + torch.matmul(
                        (t_ibot * mask_valid[:, None]).sum(dim=0,
                                                           keepdim=True)
                        / denom, wt_ibot) * (1 - center_momentum)
                else:
                    t_masked_out = dino_head_forward(t_masked, ihead,
                                                     matmul_bf16=head_mm_bf16)
                    t_ibot = softmax_center_teacher(t_masked_out, ibot_c,
                                                    teacher_temp)
                    new_ibot_center = ibot_c * center_momentum + (
                        (t_masked_out * mask_valid[:, None]).sum(
                            dim=0, keepdim=True) / denom) \
                        * (1 - center_momentum)
            else:                                   # sinkhorn_knopp
                t_cls_out = dino_head_forward(t_cls_swapped, model.dino_head,
                                              matmul_bf16=head_mm_bf16)
                t_masked_out = dino_head_forward(t_masked, ihead,
                                                 matmul_bf16=head_mm_bf16)
                t_dino = sinkhorn_knopp_teacher(t_cls_out, teacher_temp)
                t_ibot = sinkhorn_knopp_teacher(t_masked_out, teacher_temp,
                                                sample_mask=mask_valid)
                new_dino_center, new_ibot_center = dino_c, ibot_c
        return t_dino, t_ibot, wt_dino, wt_ibot, new_dino_center, \
            new_ibot_center

    def student_loss(state, g_c, l_c, masks_c, t_dino_c, m_idx, t_ibot_c,
                     m_weight, m_valid, n_imgs_g, wt_dino, wt_ibot,
                     teacher_temp, generator):
        model = state.model
        bb = model.backbone
        s_tokens_g = vit_features(bb, g_c, vit_cfg, return_all_tokens=True,
                                  deterministic=False, generator=generator,
                                  masks=masks_c)
        s_cls_g = s_tokens_g[:, 0]
        s_patches_g = s_tokens_g[:, 1 + n_reg:]
        head_in = [s_cls_g]
        if n_local:
            head_in.append(vit_features(
                bb, l_c, vit_cfg, deterministic=False, generator=generator,
                pack_segments=n_local if pack_local_crops else 0))
        s_masked = s_patches_g.reshape(-1, s_patches_g.shape[-1])[m_idx]
        if not separate_head and do_ibot:
            head_in.append(s_masked)
        sizes = [h.shape[0] for h in head_in]
        # one shared bottleneck pass; norm_last_layer=False: the dinov2
        # head's weight-norm magnitude g is trainable
        bott = dino_head_bottleneck(torch.cat(head_in, dim=0),
                                    model.dino_head)
        ws_dino = dino_head_last_w(model.dino_head, norm_last_layer=False)
        parts = _split_rows(bott, sizes)
        n_cls = sizes[0] + (sizes[1] if n_local else 0)
        if fused_dino or not do_dino:
            s_cls_g_out = parts[0]
            s_cls_l_out = parts[1] if n_local else None
        else:
            cls_logits = project(bott[:n_cls], ws_dino)
            s_cls_g_out = cls_logits[:sizes[0]]
            s_cls_l_out = cls_logits[sizes[0]:] if n_local else None
        ws_ibot = ws_dino
        if not do_ibot:
            s_masked_out = None
        elif separate_head:
            b_m = dino_head_bottleneck(s_masked, model.ibot_head)
            ws_ibot = dino_head_last_w(model.ibot_head, norm_last_layer=False)
            s_masked_out = b_m if fused_ibot else project(b_m, ws_ibot)
        else:
            s_masked_out = parts[-1] if fused_ibot \
                else project(parts[-1], ws_dino)

        losses = {}
        total = 0.0
        denom = max(n_local * n_global, 1) + (n_global - 1) * n_global
        if do_dino:
            t_list = list(t_dino_c.chunk(n_global))
            if n_local:
                s_local = list(s_cls_l_out.chunk(n_local))
                if fused_dino:
                    # every (student local chunk, teacher chunk) pair is
                    # row-aligned: one kernel call over the stacked pairs
                    xs_p = torch.cat([s for s in s_local for _ in t_list])
                    xt_p = torch.cat([t for _ in s_local for t in t_list])
                    ce = proto_ce(xs_p, ws_dino, xt_p, wt_dino,
                                  state.dino_center, teacher_temp,
                                  student_temp)
                    dino_local = (ce.sum() / s_local[0].shape[0]) / denom
                else:
                    dino_local = dinov2_dino_loss(
                        s_local, t_list, student_temp=student_temp) / denom
                losses["dino_local_crops_loss"] = dino_local
                total = total + dino_w * dino_local
            if fused_dino:
                ce = proto_ce(s_cls_g_out, ws_dino, t_dino_c, wt_dino,
                              state.dino_center, teacher_temp, student_temp)
                dino_global = ce.mean() * 2 / denom
            else:
                dino_global = dinov2_dino_loss(
                    [s_cls_g_out], [t_dino_c],
                    student_temp=student_temp) * 2 / denom
            losses["dino_global_crops_loss"] = dino_global
            total = total + dino_w * dino_global
            if do_koleo:
                kl = koleo_w * sum(koleo_loss(c)
                                   for c in s_cls_g.chunk(n_global))
                losses["koleo_loss"] = kl / 2
                total = total + kl
        if do_ibot:
            if fused_ibot:
                ce = proto_ce(s_masked_out, ws_ibot, t_ibot_c, wt_ibot,
                              state.ibot_center, teacher_temp, student_temp)
                il = (ce * (m_weight * m_valid)).sum() / n_imgs_g \
                    * 2 * (1.0 / n_global)
            else:
                il = ibot_patch_loss(s_masked_out, t_ibot_c,
                                     m_weight * m_valid, n_images=n_imgs_g,
                                     student_temp=student_temp) \
                    * 2 * (1.0 / n_global)
            losses["ibot_loss"] = il / 2
            total = total + ibot_w * il
        return total, losses

    def micro_batches(g_crops, l_crops, masks, t_dino, mask_idx, t_ibot,
                      masks_weight, mask_valid):
        """The student's inputs per micro-batch: crop-major splits, and
        the flat iBOT indices rebased into each micro-batch's patch space
        (entries of other micro-batches and padding keep weight 0)."""
        B = g_crops.shape[0] // n_global
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} "
                             "micro-batches")
        mb = B // accum_steps

        def split(x, n_crops):
            x = x.reshape((n_crops, accum_steps, mb) + x.shape[1:])
            return x.transpose(0, 1).reshape(
                (accum_steps, n_crops * mb) + x.shape[3:])

        g_m = split(g_crops, n_global)
        l_m = split(l_crops, n_local) if n_local else [None] * accum_steps
        masks_m, t_dino_m = split(masks, n_global), split(t_dino, n_global)
        n_tok = masks.shape[1]
        u_m = mask_idx.shape[0] // accum_steps
        rows, cols = mask_idx // n_tok, mask_idx % n_tok
        gi, bi = rows // B, rows % B
        owner = torch.where(mask_valid > 0, bi // mb,
                            torch.full_like(bi, accum_steps))
        local_flat = (gi * mb + bi % mb) * n_tok + cols
        out = []
        for m in range(accum_steps):
            mine = owner == m
            order = torch.argsort((~mine).int(), stable=True)[:u_m]
            zero = torch.zeros_like(masks_weight)
            out.append((g_m[m], l_m[m], masks_m[m], t_dino_m[m],
                        local_flat[order], t_ibot[order],
                        torch.where(mine, masks_weight, zero)[order],
                        torch.where(mine, mask_valid, zero)[order],
                        n_global * mb))
        return out

    def train_step(state: DINOv2TrainState, batch, lr, wd, momentum,
                   teacher_temp, generator):
        params = optimizer.params
        for p in params:
            p.grad = None
        if device_crop_cfgs is not None:
            g_crops, l_crops = device_multicrop(
                batch["raw_images"], generator, device_crop_cfgs, n_global,
                compute_dtype=vit_cfg.compute_dtype)
        else:
            g_crops = batch["collated_global_crops"]
            l_crops = batch.get("collated_local_crops")
        masks = batch["collated_masks"]
        mask_idx = batch["mask_indices_list"].long()
        masks_weight = batch["masks_weight"].float()
        mask_valid = batch["mask_valid"].float()
        teacher_temp = float(teacher_temp)

        (t_dino, t_ibot, wt_dino, wt_ibot, new_dino_center,
         new_ibot_center) = teacher_targets(state, g_crops, mask_idx,
                                            mask_valid, teacher_temp)
        extra = (wt_dino, wt_ibot, teacher_temp, generator)
        if accum_steps == 1:
            total, losses = student_loss(
                state, g_crops, l_crops, masks, t_dino, mask_idx, t_ibot,
                masks_weight, mask_valid, g_crops.shape[0], *extra)
            total.backward()
            loss = total.detach()
            losses = {k: v.detach() for k, v in losses.items()}
        else:
            loss, losses = 0.0, {}
            for micro in micro_batches(g_crops, l_crops, masks, t_dino,
                                       mask_idx, t_ibot, masks_weight,
                                       mask_valid):
                total_i, losses_i = student_loss(state, *micro, *extra)
                total_i.backward()
                loss = loss + total_i.detach()
                for k, v in losses_i.items():
                    losses[k] = losses.get(k, 0.0) + v.detach()
            loss = loss / accum_steps
            losses = {k: v / accum_steps for k, v in losses.items()}
            for p in params:
                p.grad.div_(accum_steps)
        if freeze_last_layer:
            # both weight-norm leaves of the prototype layer(s)
            zero_grads_of(state.trainable(), ("last_v", "last_g"))
        gnorm = global_norm([p.grad for p in params])
        optimizer.set_lr(lr, wd)
        optimizer.step(gnorm)
        ema_update(state.teacher, state.trainable(), momentum)
        state.dino_center = new_dino_center.detach()
        state.ibot_center = new_ibot_center.detach()
        state.step += 1
        metrics = {"loss": loss, "grad_norm": gnorm}
        metrics.update(losses)
        return state, metrics

    return train_step


# --------------------------------------------------------------------------- #
# wrapper + trainer
# --------------------------------------------------------------------------- #

class DINOv2Wrapper(DINOWrapper):
    strategy_name = "dinov2"
    is_supervised = False
    use_momentum = True

    def set_crops_params(self):
        """Crop counts and sizes from the strategy in effect."""
        spec = resolve_strategy_spec(self.parameters, "dinov2")
        ds = self.dataset_params
        self.crops_params = EDict(
            n_global_crops=int(spec["n_global"]),
            n_local_crops=int(spec["n_local"]),
            global_crops_size=int(ds.get("ssl_global_size",
                                         spec["global_size"])),
            local_crops_size=int(ds.get("ssl_local_size",
                                        spec["local_size"] or 0)))

    def init_dataloaders(self):
        self.set_crops_params()
        loaders = super().init_dataloaders()
        tp = self.model_params.transformers_params
        patch = int(tp.get("student", tp).get("patch_size", 14))
        grid = self.crops_params.global_crops_size // patch
        n_tokens = grid * grid
        ibot = self.model_params.dinov2.ibot
        loaders.trainloader.collate_fn = IBotCollate(
            self.crops_params.n_global_crops, self.crops_params.n_local_crops,
            tuple(ibot.mask_ratio_min_max),
            float(ibot.mask_sample_probability), n_tokens,
            MaskingGenerator((grid, grid),
                             max_num_patches=int(0.5 * n_tokens)),
            raw_mode=True, seed=int(self.training_params.get("seed", 0)),
            batches_per_epoch=len(loaders.trainloader))
        return loaders

    def build_vit_config(self):
        """The nested `transformers_params.student` schema of the dinov2
        recipes."""
        mp = self.model_params
        tp = EDict(mp.get("transformers_params") or {})
        sp = EDict(tp.get("student", tp))
        use_mp = self.training_params.get("use_mixed_precision", True)
        return VIT_BUILDERS[mp.backbone_type](
            img_size=int(sp.get("pre_img_size", 518)),
            patch_size=int(sp.get("patch_size", 14)),
            drop_path_rate=float(sp.get("drop_path_rate", 0.0)),
            has_layerscale=sp.get("layerscale") is not None,
            layerscale_init=float(sp.get("layerscale", 1e-5) or 1e-5),
            num_register_tokens=int(sp.get("num_register_tokens", 0)),
            use_swiglu=sp.get("ffn_layer", "mlp") == "swiglu",
            compute_dtype=torch.bfloat16 if use_mp else torch.float32,
            use_flash=bool(sp.get("is_memory_efficient", False)),
            use_fused_apla=bool(sp.get("use_fused_apla", False)),
            gelu_tanh=bool(sp.get("gelu_tanh", False)))

    def init_model(self, seed: int = 0):
        d2 = self.model_params.dinov2
        gen = torch.Generator().manual_seed(seed)
        vit = self._init_backbone(gen)
        if any(not p.requires_grad for p in vit.parameters()):
            # the iBOT mask token lives with the frozen backbone weights
            vit.mask_token = nn.Parameter(
                trunc_normal((1, 1, self.vit_cfg.embed_dim), gen),
                requires_grad=False)

        def head(h):
            return init_dino_head(
                self.vit_cfg.embed_dim, int(h.head_n_prototypes),
                nlayers=int(h.head_nlayers), hidden_dim=int(h.head_hidden_dim),
                bottleneck_dim=int(h.head_bottleneck_dim), generator=gen)

        separate = bool(d2.ibot.get("separate_head", False))
        self.model = DINOv2Model(vit, head(d2.dino),
                                 head(d2.ibot) if separate else None
                                 ).to(self.device)
        # the pretrained backbone, then the transfer checkpoint, before
        # the teacher copy (init_optimization)
        self.load_weights("dinov2")
        self.n_prototypes = int(d2.dino.head_n_prototypes)
        self.ibot_prototypes = int(d2.ibot.head_n_prototypes) if separate \
            else self.n_prototypes
        self._print_model("DINOv2 heads")

    def init_optimization(self):
        opt = self.optimization_params.default
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        self.optimizer = build_optimizer(
            opt.optimizer.type, dict(opt.optimizer.params), named,
            grad_clip=self.training_params.get("grad_clipping"))
        iters_per_epoch = len(self.dataloaders.trainloader)
        total_iters = iters_per_epoch * int(self.training_params.epochs)
        tp = self.model_params.transformers_params
        (self.lr_schedule, self.wd_schedule, self.momentum_schedule_tbl,
         self.teacher_temp_schedule, self.last_layer_lr_schedule) = \
            build_schedulers(opt, self.training_params, tp.teacher,
                             iters_per_epoch, max(total_iters, 1))
        self.state = DINOv2TrainState(
            step=0, model=self.model, optimizer=self.optimizer,
            teacher={n: p.detach().clone() for n, p in named},
            dino_center=torch.zeros((1, self.n_prototypes),
                                    device=self.device),
            ibot_center=torch.zeros((1, self.ibot_prototypes),
                                    device=self.device))


class Dinov2Trainer(BYOLTrainer):
    """The schedule tables drive lr, wd, EMA momentum and teacher
    temperature; the prototype layer is frozen for the first
    `freeze_last_layer_epochs`; the feature extractor is the teacher's
    backbone."""

    feature_branch = "teacher"

    def __init__(self, wrapper):
        super().__init__(wrapper, use_momentum=True)
        self.freeze_last_for = int(
            wrapper.training_params.get("freeze_last_layer_epochs", 1))
        self.n_global = wrapper.crops_params.n_global_crops
        self.n_local = wrapper.crops_params.n_local_crops
        self._steps = {}

    def _pack_local_crops(self) -> bool:
        tp = self.wrapper.model_params.get("transformers_params", {})
        return bool(tp.get("student", tp).get("pack_local_crops", False))

    def get_step(self, freeze: bool):
        if freeze not in self._steps:
            self._steps[freeze] = make_dinov2_train_step(
                self.vit_cfg, self.wrapper.optimizer,
                self.wrapper.model_params.dinov2, self.n_global,
                self.n_local, freeze_last_layer=freeze,
                device_crop_cfgs=self.wrapper.ssl_device_crop_cfgs,
                accum_steps=int(self.wrapper.training_params.get(
                    "accum_steps", 1)),
                pack_local_crops=self._pack_local_crops())
        return self._steps[freeze]

    def train_one(self, batch, epoch: int):
        freeze = bool(self.freeze_last_for
                      and epoch + 1 <= self.freeze_last_for)
        w = self.wrapper
        lr = w.lr_schedule[self.iters]
        wd = w.wd_schedule[self.iters]
        mom = w.momentum_schedule_tbl[self.iters]
        t_temp = w.teacher_temp_schedule[self.iters]
        # per-step draws (crops, masks' dropout): a resumed run draws what
        # the original would
        self.generator.manual_seed((self.seed << 32) + self.iters)
        dbatch = {k: v.to(self.device, non_blocking=True)
                  for k, v in batch.items()
                  if k not in ("label", "n_masked_patches")}
        self.state, m = self.get_step(freeze)(self.state, dbatch, lr, wd,
                                               mom, t_temp, self.generator)
        return m, {"lr": lr, "wd": wd, "teacher_temp": t_temp,
                   "momentum": mom}
