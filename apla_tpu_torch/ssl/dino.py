"""DINO (v1) self-supervised training.

Counterpart of `apla_tpu/ssl/dino.py`: student and teacher with the DINO
head, multi-crop (2 global + 8 local), the centering and sharpening loss
over every (teacher chunk, student chunk) pair of different views, the
EMA teacher, the cosine weight-decay table, the per-epoch teacher
temperature and the last layer frozen for the first epoch.

- The student is one `DINOModel` (backbone + DINO head).  The teacher is
  the EMA twin of the trainable tensors only (the frozen weights are
  shared); its forward runs on the student's modules with the teacher's
  tensors swapped in (`weights_swapped`).
- The teacher runs on the global crops of the full batch even when the
  student accumulates, so the centering is over the full batch.  The
  global and local crops run as two forwards, one per resolution.
- `DINOWrapper` is also the base of the DINOv2 wrapper, which overrides
  `init_model` and `init_optimization`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..data.device_augs import device_multicrop
from ..models.vit import ViT, vit_features
from ..train.optim import global_norm
from ..train.schedules import cosine_with_warmup_table
from ..train.train_state import TrainState, weights_swapped
from ..wrapper import DefaultWrapper
from .byol import BYOLTrainer, BYOLWrapper, ema_update, fill_missing_grads
from .heads import DINOHead, dino_head_forward, init_dino_head
from .multicrop import resolve_strategy_spec


class DINOModel(nn.Module):
    """The student: ViT backbone (APLA-split) + DINO head."""

    def __init__(self, backbone: ViT, head: DINOHead):
        super().__init__()
        self.backbone = backbone
        self.head = head


@dataclasses.dataclass
class DINOTrainState(TrainState):
    """`TrainState` plus the EMA teacher (name -> tensor, one per trainable
    parameter) and the loss-centering buffer [1, K]."""
    teacher: dict
    center: torch.Tensor

    def aux(self) -> dict:
        """What a checkpoint keeps beside the trainable tensors."""
        out = {f"teacher.{n}": t for n, t in self.teacher.items()}
        out["center"] = self.center
        return out

    @torch.no_grad()
    def load_aux(self, aux: dict) -> None:
        for n, t in self.teacher.items():
            t.copy_(aux[f"teacher.{n}"])
        self.center.copy_(aux["center"])


def make_teacher_temp_schedule(warmup_teacher_temp, teacher_temp,
                               warmup_epochs, nepochs):
    """Per-epoch teacher temperature: linear warm-up, then constant."""
    return np.concatenate([
        np.linspace(warmup_teacher_temp, teacher_temp, warmup_epochs),
        np.ones(max(nepochs - warmup_epochs, 0)) * teacher_temp,
    ]).astype(np.float32)


def dino_pair_ce(student_out, teacher_softmaxed, student_temp=0.1):
    """Mean CE over all (teacher chunk, student chunk) pairs, same-view
    pairs skipped: the loss the train step takes.  Each student chunk's
    log-softmax is formed once; the terms add in the JAX order (teacher
    chunk outer)."""
    logps = [torch.log_softmax(s / student_temp, dim=-1)
             for s in student_out]
    total, n_terms = 0.0, 0
    for iq, q in enumerate(teacher_softmaxed):
        q = q.detach()
        for v, logp in enumerate(logps):
            if v == iq:
                continue
            total = total + torch.mean(torch.sum(-q * logp, dim=-1))
            n_terms += 1
    return (total / n_terms).float()


def dino_loss(student_out, teacher_out, center, teacher_temp,
              student_temp=0.1, center_momentum=0.9):
    """Cross-entropy between the teacher (centered, sharpened) and student
    chunks.  student_out: list of [B, K] per crop; teacher_out: list of the
    2 global [B, K].  Returns (loss, new_center)."""
    t_sm = [torch.softmax((t - center) / teacher_temp, dim=-1)
            for t in teacher_out]
    loss = dino_pair_ce(student_out, t_sm, student_temp=student_temp)
    batch_center = torch.cat(teacher_out, dim=0).mean(dim=0, keepdim=True)
    new_center = center * center_momentum \
        + batch_center * (1 - center_momentum)
    return loss, new_center.detach()


def zero_grads_of(trainable: dict, leaves) -> None:
    """Zero the gradients of the parameters whose last name part is in
    `leaves` (the last layer frozen for the first epochs)."""
    for name, p in trainable.items():
        if name.rsplit(".", 1)[-1] in leaves and p.grad is not None:
            p.grad.zero_()


def make_dino_train_step(vit_cfg, optimizer, n_global: int, n_local: int,
                         student_temp=0.1, center_momentum=0.9,
                         freeze_last_layer: bool = False,
                         device_crop_cfgs=None, accum_steps: int = 1):
    """Returns train_step(state, global_stack, local_stack, lr, wd,
    momentum, teacher_temp, generator) -> (state, metrics)
    (`apla_tpu/ssl/dino.py:174-297`).

    `global_stack` [G*B, H, W, C] and `local_stack` [L*B, h, w, C] or None,
    crop-major; with `device_crop_cfgs`, `global_stack` is the raw uint8
    batch and every crop is made on the device from `generator`.  The
    teacher (no gradients) runs on the full batch; with `accum_steps` > 1
    the student runs over micro-batches and the gradients are averaged
    before one update."""

    def micro_split(x, n_crops):
        mb = x.shape[0] // (n_crops * accum_steps)
        x = x.reshape((n_crops, accum_steps, mb) + x.shape[1:])
        return x.transpose(0, 1).reshape(
            (accum_steps, n_crops * mb) + x.shape[3:])

    def student_loss(model, g_c, l_c, t_sm_c, generator):
        emb_g = vit_features(model.backbone, g_c, vit_cfg,
                             deterministic=False, generator=generator)
        student_out = list(dino_head_forward(emb_g, model.head)
                           .chunk(n_global))
        if l_c is not None:
            emb_l = vit_features(model.backbone, l_c, vit_cfg,
                                 deterministic=False, generator=generator)
            student_out += list(dino_head_forward(emb_l, model.head)
                                .chunk(n_local))
        return dino_pair_ce(student_out, t_sm_c, student_temp=student_temp)

    def train_step(state: DINOTrainState, global_stack, local_stack, lr, wd,
                   momentum, teacher_temp, generator):
        params = optimizer.params
        for p in params:
            p.grad = None
        if device_crop_cfgs is not None:
            global_stack, local_stack = device_multicrop(
                global_stack, generator, device_crop_cfgs, n_global,
                compute_dtype=vit_cfg.compute_dtype)
        model = state.model
        # teacher: the global crops of the full batch, no gradients
        with torch.no_grad(), weights_swapped(state.trainable(),
                                              state.teacher):
            t_out = dino_head_forward(
                vit_features(model.backbone, global_stack, vit_cfg),
                model.head)
            t_sm = [torch.softmax((t - state.center) / float(teacher_temp),
                                  dim=-1) for t in t_out.chunk(n_global)]
            new_center = state.center * center_momentum \
                + t_out.mean(dim=0, keepdim=True) * (1 - center_momentum)

        B = global_stack.shape[0] // n_global
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into "
                             f"{accum_steps} micro-batches")
        g_m = micro_split(global_stack, n_global)
        l_m = (micro_split(local_stack, n_local)
               if local_stack is not None else [None] * accum_steps)
        t_m = [t.reshape((accum_steps, -1) + t.shape[1:]) for t in t_sm]
        loss = 0.0
        for m in range(accum_steps):
            loss_m = student_loss(model, g_m[m], l_m[m],
                                  [t[m] for t in t_m], generator)
            loss_m.backward()
            loss = loss + loss_m.detach()
        grads = fill_missing_grads(params)
        if accum_steps > 1:
            loss = loss / accum_steps
            torch._foreach_div_(grads, float(accum_steps))
        if freeze_last_layer:
            zero_grads_of(state.trainable(), ("last_v",))
        gnorm = global_norm(grads)
        optimizer.set_lr(lr, wd)
        optimizer.step(gnorm)
        ema_update(state.teacher, state.trainable(), momentum)
        state.center = new_center
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


class DINOWrapper(BYOLWrapper):
    is_supervised = False
    use_momentum = True
    strategy_name = "dino"   # the host strategy and the device crop configs

    def init_model(self, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        vit = self._init_backbone(gen)
        self.dino_args = self.model_params.get("DINO", {})
        self.proj_size = int(self.dino_args.get("projection_size", 4096))
        head = init_dino_head(self.vit_cfg.embed_dim, self.proj_size,
                              generator=gen)
        self.model = DINOModel(vit, head).to(self.device)
        # the pretrained backbone, then the transfer checkpoint, before
        # the teacher copy (init_optimization)
        self.load_weights("dino")
        self._print_model("DINO head")

    def init_optimization(self):
        # the optimizer over the trainables and the lr schedule
        DefaultWrapper.init_optimization(self)
        total_iters, epochs = self.total_iters(), int(
            self.training_params.epochs)
        args = self.dino_args
        self.momentum_schedule = cosine_with_warmup_table(
            float(args.get("moving_average_decay", 0.99)), 1.0, total_iters)
        self.wd_schedule = cosine_with_warmup_table(
            float(self.optimization_params.default.optimizer.params.get(
                "weight_decay", 1e-5)), 1e-4, total_iters)
        self.teacher_temp_schedule = make_teacher_temp_schedule(
            float(args.get("warmup_teacher_temp", 0.04)),
            float(args.get("teacher_temp", 0.07)),
            int(args.get("warmup_teacher_temp_epochs", min(30, epochs))),
            epochs)
        self.state = DINOTrainState(
            step=0, model=self.model, optimizer=self.optimizer,
            teacher={n: p.detach().clone()
                     for n, p in self.state.trainable().items()},
            center=torch.zeros((1, self.proj_size), device=self.device))


class DINOTrainer(BYOLTrainer):
    """The BYOL loop with the wd table, the per-epoch teacher temperature
    and the last layer frozen for the first `freeze_last_for` epochs; the
    feature extractor is the teacher's backbone."""

    feature_branch = "teacher"

    def __init__(self, wrapper, freeze_last_for=1):
        super().__init__(wrapper, use_momentum=True)
        self.freeze_last_for = int(freeze_last_for)
        # crop counts from the strategy in effect (a user file wins)
        spec = resolve_strategy_spec(wrapper.parameters,
                                     wrapper.strategy_name)
        self.n_global = int(spec["n_global"])
        self.n_local = int(spec["n_local"])
        self._steps = {}

    def get_step(self, freeze: bool):
        if freeze not in self._steps:
            self._steps[freeze] = make_dino_train_step(
                self.vit_cfg, self.wrapper.optimizer, self.n_global,
                self.n_local, freeze_last_layer=freeze,
                device_crop_cfgs=self.wrapper.ssl_device_crop_cfgs,
                accum_steps=int(self.wrapper.training_params.get(
                    "accum_steps", 1)))
        return self._steps[freeze]

    def train_one(self, batch, epoch: int):
        w = self.wrapper
        freeze = epoch + 1 <= self.freeze_last_for
        temps = w.teacher_temp_schedule
        t_temp = float(temps[min(epoch, len(temps) - 1)])
        lr = w.scheduler.lr(self.iters)
        wd = float(w.wd_schedule[min(self.iters, len(w.wd_schedule) - 1)])
        mom = self.momentum_at(self.iters)
        self.generator.manual_seed((self.seed << 32) + self.iters)
        images = batch["image"].to(self.device, non_blocking=True)
        self.state, m = self.get_step(freeze)(
            self.state, images, None, lr, wd, mom, t_temp, self.generator)
        return m, {"lr": lr, "wd": wd, "teacher_temp": t_temp,
                   "ema_momentum": mom}
