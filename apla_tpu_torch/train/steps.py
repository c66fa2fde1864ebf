"""Supervised train / eval / embed steps.

Counterpart of `apla_tpu/train/steps.py:23-177`.  The JAX step is one jitted
function of (state, frozen, batch, lr, rng); here the step runs eagerly and
updates the model and optimizer in place (the module holds the frozen
weights), returning the state and a dict of device tensors, so nothing
waits on the host unless `skip_nonfinite` asks for it.

- Device augmentation runs inside the step, per micro-batch, as in JAX.
- `accum_steps` splits the batch into micro-batches whose float32 gradients
  accumulate in `.grad` and are averaged before ONE optimizer update; the
  loss is the mean of the micro-batch losses.
- `grad_norm` is the global norm of the averaged gradients, before the
  optimizer's clip.
- `skip_nonfinite`: when the loss or the norm is not finite the update is
  skipped (params and optimizer state keep their values), the step counter
  still advances, and `metrics['nonfinite']` is 1.
- Data parallel (a process group of W ranks, `parallel.launch`): `batch`
  holds this rank's rows, micro-batch by micro-batch
  (`parallel.mesh.rank_rows`); the random draws are the global batch's
  (`parallel.mesh.batch_rows`); the averaged gradients are all-reduced
  once per update, before the norm and the clip
  (`parallel.collectives.reduce_gradients`), and the loss is the mean over
  ranks, so every rank takes the same update as the 1-device run.
- On a model axis (`parallel.tensor`) the placement rides on the model
  (`ViT.placement`, set by `parallel.mesh.shard_params`), so the train,
  eval and embed steps run it as they are; the ranks of a model group
  hold the same rows, the loss is averaged over the data group, and
  `reduce_gradients` first sums over the model group each gradient the
  rank took as a share (`parallel.mesh.tp_plan`).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..data.device_augs import device_augment
from ..models.classifier import classifier_forward
from ..parallel.collectives import pmean, reduce_gradients
from ..parallel.mesh import batch_rows
from .optim import Optimizer, grad_norm
from .train_state import TrainState


def make_train_step(vit_cfg, optimizer: Optimizer, criterion: Callable,
                    device_aug_cfg=None, accum_steps: int = 1,
                    skip_nonfinite: bool = False) -> Callable:
    """Returns train_step(state, batch, lr, generator) -> (state, metrics)
    with metrics {'loss', 'grad_norm', 'logits'[, 'nonfinite']}.  `batch`
    holds device tensors 'image' [B, H, W, C] and 'label'; `generator` is a
    `torch.Generator` on their device (augmentation and dropout draws)."""

    def fwd_bwd(model, images, labels, generator):
        if device_aug_cfg is not None:
            images = device_augment(images, generator, device_aug_cfg,
                                    compute_dtype=vit_cfg.compute_dtype)
        logits = classifier_forward(model, images, vit_cfg,
                                    deterministic=False, generator=generator)
        loss = criterion(logits, labels)
        loss.backward()
        return loss.detach(), logits.detach()

    def train_step(state: TrainState, batch, lr: float, generator):
        params = optimizer.params
        for p in params:
            p.grad = None
        images, labels = batch["image"], batch["label"]
        B = images.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into "
                             f"{accum_steps} micro-batches")
        mb = B // accum_steps
        with batch_rows(mb):
            if accum_steps == 1:
                loss, logits = fwd_bwd(state.model, images, labels,
                                       generator)
            else:
                loss, logits = 0.0, []
                for i in range(accum_steps):
                    sl = slice(i * mb, (i + 1) * mb)
                    loss_i, logits_i = fwd_bwd(state.model, images[sl],
                                               labels[sl], generator)
                    loss = loss + loss_i
                    logits.append(logits_i)
                loss = loss / accum_steps
                logits = torch.cat(logits)
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
        reduce_gradients(params)
        loss = pmean(loss)
        gnorm = grad_norm(params)
        metrics = {"loss": loss, "grad_norm": gnorm, "logits": logits}
        update = True
        if skip_nonfinite:
            update = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            metrics["nonfinite"] = int(not update)
        if update:
            optimizer.set_lr(lr)
            optimizer.step(gnorm)
        state.step += 1
        return state, metrics

    return train_step


@torch.no_grad()
def per_sample_losses(criterion: Callable, logits, labels):
    """criterion applied to each sample alone ([B] losses)."""
    return torch.stack([criterion(logits[i:i + 1], labels[i:i + 1])
                        for i in range(logits.shape[0])])


def make_eval_step(vit_cfg, criterion: Callable) -> Callable:
    """Returns eval_step(model, batch) -> (losses [B], logits): per-sample
    losses, so a caller can average over exactly the real samples."""

    @torch.no_grad()
    def eval_step(model, batch):
        logits = classifier_forward(model, batch["image"], vit_cfg,
                                    deterministic=True)
        return per_sample_losses(criterion, logits, batch["label"]), logits

    return eval_step


def make_embed_step(vit_cfg) -> Callable:
    """Returns embed_step(model, images) -> L2-normalised float32
    embeddings [B, d]."""

    @torch.no_grad()
    def embed_step(model, images):
        _, emb = classifier_forward(model, images, vit_cfg,
                                    return_embedding=True)
        emb = emb.float()
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                      + 1e-12)

    return embed_step
