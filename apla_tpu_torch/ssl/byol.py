"""BYOL / SimSiam self-supervised training, and the SSL run loop the other
objectives share.

Counterpart of `apla_tpu/ssl/byol.py`:

- the objective: `SSLTrainState`, `byol_loss`, `simsiam_loss`,
  `BYOLWrapper.init_model` / `init_optimization` (BatchNorm heads at the
  JAX defaults: BYOL projection 256, hidden 4096, 2 layers, predictor
  4096; SimSiam 2048, 2048, 3 layers, predictor 512; the EMA momentum
  from `cosine_with_warmup_table(0.99, 1.0, ...)`) and
  `make_byol_train_step` with `accum_steps`;
- the plumbing: the multi-crop set-up (`update_augmentation_strategy`,
  `_setup_device_multicrop`) and the `BYOLTrainer` run loop: train,
  validation by kNN on the feature branch's backbone, best-model tracking,
  checkpoints with the auxiliary state (the teacher, the BN running stats,
  the centers), resume and the kNN test table.  The trainer keeps its
  records in `history`, as `Trainer` does.

The student is one `BYOLModel` (backbone + head + predictor).  The teacher
(BYOL) is the EMA twin of the trainable backbone and head tensors only:
the frozen weights are shared, and the target branch runs on the student's
modules with the teacher's tensors swapped in (`weights_swapped`).  SimSiam
takes the student's own weights as the target, without gradients, and its
teacher is never updated.  The BN running stats are a nested dict in the
state ({'student': {'head', 'predictor'}, 'teacher': {'head'}}), threaded
through every forward in the JAX order: student view 0's head then
predictor, then view 1's, the target head on the views reversed, and under
accumulation through the micro-batches in turn.

Only the on-device multi-crop path exists (the JAX package's
`dataset_params.device_augment` one): the host multi-crop transforms need
the PIL-free transforms (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
from torch import nn

from ..apla.core import build_apla
from ..data.device_augs import device_augment
from ..models.vit import ViT, init_vit_, vit_features
from ..train.checkpoint import load_aux_state, load_checkpoint, \
    save_checkpoint
from ..train.knn import knn_evaluate
from ..train.optim import global_norm
from ..train.schedules import cosine_with_warmup_table
from ..train.train_state import TrainState, weights_swapped
from ..wrapper import DefaultWrapper, build_apla_config, build_vit_config
from .heads import (BYOLHead, PredictionMLP, byol_head_forward,
                    init_byol_head, init_prediction_mlp,
                    prediction_mlp_forward)
from .multicrop import apply_augmentation_strategy, resolve_strategy_spec


# --------------------------------------------------------------------------- #
# model, state and losses
# --------------------------------------------------------------------------- #

class BYOLModel(nn.Module):
    """The student: ViT backbone (APLA-split) + projection head +
    predictor."""

    def __init__(self, backbone: ViT, head: BYOLHead,
                 predictor: PredictionMLP):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.predictor = predictor


def _tree_items(tree: dict, prefix: str = ""):
    """(dotted name, leaf) of a nested dict of tensors."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _tree_items(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@dataclasses.dataclass
class SSLTrainState(TrainState):
    """`TrainState` plus the EMA teacher (name -> tensor: the trainable
    `backbone.*` and `head.*`) and the BN running stats (`model_state`)."""
    teacher: dict
    model_state: dict

    def aux(self) -> dict:
        """What a checkpoint keeps beside the trainable tensors."""
        out = {f"teacher.{n}": t for n, t in self.teacher.items()}
        out.update((f"model_state.{n}", t)
                   for n, t in _tree_items(self.model_state))
        return out

    @torch.no_grad()
    def load_aux(self, aux: dict) -> None:
        for n, t in self.teacher.items():
            t.copy_(aux[f"teacher.{n}"])
        for n, t in _tree_items(self.model_state):
            t.copy_(aux[f"model_state.{n}"])


def _cosines(preds, targets):
    """Per pair, the rowwise cosine of f32 L2-normalised rows [B]."""
    out = []
    for p, t in zip(preds, targets):
        p, t = p.float(), t.float()
        p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
        t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
        out.append(torch.sum(p * t, dim=-1))
    return out


def byol_loss(preds, targets):
    """2 - 2 cos per view pair, summed over pairs, averaged over the
    batch."""
    return torch.mean(sum(2.0 - 2.0 * c for c in _cosines(preds, targets)))


def simsiam_loss(preds, targets):
    """-cos / 2 per view pair, summed over pairs, averaged over the
    batch."""
    return torch.mean(sum(-c / 2.0 for c in _cosines(preds, targets)))


def fill_missing_grads(params) -> list:
    """The gradients of `params`, zeros where autograd left none (a
    parameter the loss does not reach, as JAX's gradient of it is 0)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


@torch.no_grad()
def ema_update(teacher: dict, student: dict, momentum: float) -> None:
    """teacher <- teacher * m + student * (1 - m), over the teacher's
    names."""
    names = list(teacher)
    t = [teacher[n] for n in names]
    torch._foreach_mul_(t, float(momentum))
    torch._foreach_add_(t, [student[n].detach() for n in names],
                        alpha=1.0 - float(momentum))


# --------------------------------------------------------------------------- #
# train step
# --------------------------------------------------------------------------- #

def make_byol_train_step(vit_cfg, optimizer, use_momentum: bool,
                         device_crop_cfgs=None, accum_steps: int = 1):
    """Returns train_step(state, views, lr, momentum, generator) -> (state,
    metrics) (`apla_tpu/ssl/byol.py:228-349`).

    `views`: the raw uint8 batch [B, H, W, C] with `device_crop_cfgs` (one
    view per config, made on the device from `generator`), else the list
    of ready views.  With `accum_steps` > 1 the whole per-batch computation
    (target branch, student, BN updates) runs per micro-batch and the
    gradients are averaged before one update; BN statistics are then
    per-micro-batch, as in the JAX scan."""
    loss_pair = byol_loss if use_momentum else simsiam_loss

    def target_branch(state, views, t_head_s):
        """No gradients, deterministic: the target projections of the views
        reversed (teacher for BYOL, the student's own weights for SimSiam)
        and the teacher head's new running stats."""
        model = state.model
        weights = state.teacher if use_momentum else None
        targets = []
        with torch.no_grad(), weights_swapped(state.trainable(), weights):
            for view in views[::-1]:
                emb = vit_features(model.backbone, view, vit_cfg)
                proj, t_head_s = byol_head_forward(emb, model.head, t_head_s,
                                                   train=True)
                targets.append(proj)
        return targets, t_head_s

    def student_loss(state, views, targets, stats, generator):
        model = state.model
        head_s, pred_s = stats["head"], stats["predictor"]
        preds = []
        for view in views:
            emb = vit_features(model.backbone, view, vit_cfg,
                               deterministic=False, generator=generator)
            proj, head_s = byol_head_forward(emb, model.head, head_s,
                                             train=True)
            pred, pred_s = prediction_mlp_forward(proj, model.predictor,
                                                  pred_s, train=True)
            preds.append(pred)
        return loss_pair(preds, targets), {"head": head_s,
                                           "predictor": pred_s}

    def train_step(state: SSLTrainState, views, lr, momentum, generator):
        params = optimizer.params
        for p in params:
            p.grad = None
        if device_crop_cfgs is not None:
            views = [device_augment(views, generator, cfg,
                                    compute_dtype=vit_cfg.compute_dtype)
                     for cfg in device_crop_cfgs]
        B = views[0].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} "
                             "micro-batches")
        mb = B // accum_steps
        ms = state.model_state
        loss = 0.0
        for m in range(accum_steps):
            mviews = [v[m * mb:(m + 1) * mb] for v in views]
            targets, t_head_s = target_branch(state, mviews,
                                              ms["teacher"]["head"])
            loss_m, s_stats = student_loss(state, mviews, targets,
                                           ms["student"], generator)
            loss_m.backward()
            loss = loss + loss_m.detach()
            ms = {"student": s_stats, "teacher": {"head": t_head_s}}
        grads = fill_missing_grads(params)
        if accum_steps > 1:
            loss = loss / accum_steps
            torch._foreach_div_(grads, float(accum_steps))
        gnorm = global_norm(grads)
        optimizer.set_lr(lr)
        optimizer.step(gnorm)
        if use_momentum:
            ema_update(state.teacher, state.trainable(), momentum)
        state.model_state = ms
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


# --------------------------------------------------------------------------- #
# wrapper + trainer
# --------------------------------------------------------------------------- #

class BYOLWrapper(DefaultWrapper):
    is_supervised = False
    use_momentum = True  # False => SimSiam
    strategy_name = "byol"

    def __init__(self, parameters, use_momentum=None):
        if use_momentum is not None:
            self.use_momentum = use_momentum
        super().__init__(parameters)

    def update_augmentation_strategy(self, parameters):
        return apply_augmentation_strategy(parameters, self.strategy_name)

    def init_dataloaders(self):
        loaders = super().init_dataloaders()
        self._setup_device_multicrop(loaders)
        return loaders

    def _setup_device_multicrop(self, loaders):
        """The JAX package's `dataset_params.device_augment` path, the
        port's only one: the host ships one uint8 image per sample and every
        crop of the strategy is made on the device inside the step
        (`data.device_augs.device_multicrop`).  Host multi-crop waits for
        the PIL-free transforms (ROADMAP queue A), so a recipe with
        `device_augment` off runs this path too.  The host cannot resize
        yet, so the image ships at its stored size, where the JAX package
        resizes it to `int(global_size * 8 / 7)`; a recipe held against the
        JAX package stores its images at that size."""
        from ..data.device_augs import crop_cfgs_from_strategy
        if not self.dataset_params.get("device_augment"):
            print("note: SSL crops are made on the device (the port has no "
                  "host multi-crop yet, ROADMAP queue A)")
        spec = resolve_strategy_spec(self.parameters, self.strategy_name)
        trainset = loaders.trainloader.dataset
        g = int(self.dataset_params.get("ssl_global_size")
                or spec["global_size"])
        loc = self.dataset_params.get("ssl_local_size") or spec["local_size"]
        trainset.raw_mode = True
        self.ssl_device_crop_cfgs = crop_cfgs_from_strategy(
            spec, trainset.mean, trainset.std, g_size=g, l_size=loc)

    def build_vit_config(self):
        return build_vit_config(self.parameters)

    def _init_backbone(self, generator: torch.Generator) -> ViT:
        """A seeded ViT, APLA-split per the recipe (else frozen for a
        linear probe with `freeze_backbone`, else all trainable)."""
        self.vit_cfg = self.build_vit_config()
        vit = init_vit_(ViT(self.vit_cfg), generator)
        apla_cfg = build_apla_config(self.parameters)
        if apla_cfg is not None:
            build_apla(vit, apla_cfg)
        elif self.model_params.get("freeze_backbone"):
            vit.requires_grad_(False)
        return vit

    def _print_model(self, what: str):
        n_train = sum(p.numel() for p in self.model.parameters()
                      if p.requires_grad)
        n_total = sum(p.numel() for p in self.model.parameters())
        print(f"Model: {self.model_params.backbone_type} + {what} "
              f"trainable={n_train:,} / total={n_total:,}")

    def init_model(self, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        vit = self._init_backbone(gen)
        d = self.vit_cfg.embed_dim
        if self.use_momentum:   # BYOL defaults
            proj_size, proj_hidden, pred_hidden, nlayers = 256, 4096, 4096, 2
        else:                   # SimSiam defaults
            proj_size, proj_hidden, pred_hidden, nlayers = 2048, 2048, 512, 3
        head, head_s = init_byol_head(d, proj_size, proj_hidden, nlayers,
                                      generator=gen)
        pred, pred_s = init_prediction_mlp(proj_size, proj_size, pred_hidden,
                                           generator=gen)
        self.model = BYOLModel(vit, head, pred).to(self.device)
        # the pretrained backbone, then the transfer checkpoint, before
        # the teacher copy (init_optimization)
        self.load_weights("byol")
        # the teacher head's stats start as copies of the student's
        model_state = {"student": {"head": head_s, "predictor": pred_s},
                       "teacher": {"head": _tree_map(torch.clone, head_s)}}
        self.model_state = _tree_map(lambda t: t.to(self.device),
                                     model_state)
        self._print_model("BYOL heads" if self.use_momentum
                          else "SimSiam heads")

    def total_iters(self) -> int:
        return max(len(self.dataloaders.trainloader)
                   * int(self.training_params.epochs), 1)

    def init_optimization(self):
        # the optimizer over the trainables and the lr schedule
        super().init_optimization()
        self.momentum_schedule = cosine_with_warmup_table(
            0.99, 1.0, self.total_iters())
        # the teacher starts equal to the student's backbone and head
        self.state = SSLTrainState(
            step=0, model=self.model, optimizer=self.optimizer,
            teacher={n: p.detach().clone()
                     for n, p in self.state.trainable().items()
                     if n.startswith(("backbone.", "head."))},
            model_state=self.model_state)


class BYOLTrainer:
    """SSL run loop: train on multi-crop batches, kNN validation on the
    feature branch's backbone (the student's; DINO and DINOv2 take the
    teacher's), checkpoints with the auxiliary state.  `train_one` runs one
    step of the objective.  SSL runs do not handle preemption (nor does the
    JAX `BYOLTrainer`): SIGTERM ends them without a checkpoint, so
    `_preempted` stays False."""

    feature_branch = "student"
    _preempted = False

    def __init__(self, wrapper, use_momentum=None):
        self.wrapper = wrapper
        self.parameters = wrapper.parameters
        tp = wrapper.training_params
        self.epochs = int(tp.epochs)
        self.val_every = float(tp.get("val_every", 1.0))
        self.log_every = int(tp.get("log_every", 25))
        self.save_best_model = bool(tp.get("save_best_model", True))
        self.restore_session = bool(tp.get("restore_session", False))
        self.model_name = tp.get("model_name", "ssl_model")
        self.save_dir = tp.get("save_dir", "checkpoints")
        self.is_debug = bool(tp.get("is_debug", False))
        self.is_dry = bool(tp.get("is_dry", False))
        self.seed = int(tp.get("seed", 0))

        self.device = wrapper.device
        self.vit_cfg = wrapper.vit_cfg
        self.state = wrapper.state
        self.n_classes = int(wrapper.model_params.n_classes)
        self.knn_nhood = int(wrapper.model_params.get("knn_nhood", 200))
        self.target_metric = wrapper.model_params.target_metric
        self.use_momentum = (wrapper.use_momentum if use_momentum is None
                             else use_momentum)

        self.iters = 0
        self.epoch0 = 0
        self.best_val_target = -np.inf
        self.best_trainable = None
        self.generator = torch.Generator(device=self.device)
        self.history = []          # (iteration, record) for every log call
        self._last_val_iter = -1
        self._train_step = None

    # ------------------------------------------------------------------ #
    @property
    def checkpoint_path(self):
        return os.path.join(self.save_dir, self.model_name)

    def log(self, record: dict, it: int):
        self.history.append((it, dict(record)))

    def momentum_at(self, it: int) -> float:
        """The EMA momentum of iteration `it` from the wrapper's table."""
        table = self.wrapper.momentum_schedule
        return float(table[min(it, len(table) - 1)])

    def _feature_weights(self):
        """The feature extractor's backbone weights (name -> tensor): the
        teacher's for a teacher feature branch, else None (the live
        student's)."""
        if self.feature_branch == "teacher" and self.use_momentum:
            return {n: t for n, t in self.state.teacher.items()
                    if n.startswith("backbone.")}
        return None

    @torch.no_grad()
    def _embed(self, images, weights=None):
        """L2-normalised f32 cls embeddings of device images, with the
        backbone weights `weights` (default: the feature branch's)."""
        weights = self._feature_weights() if weights is None else weights
        with weights_swapped(self.state.trainable(), weights):
            emb = vit_features(self.state.model.backbone, images,
                               self.vit_cfg).float()
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                      + 1e-12)

    def train_one(self, batch, epoch: int):
        """One optimisation step on a host batch -> (metrics of device
        scalars, extra floats to log)."""
        if self._train_step is None:
            self._train_step = make_byol_train_step(
                self.vit_cfg, self.wrapper.optimizer, self.use_momentum,
                device_crop_cfgs=self.wrapper.ssl_device_crop_cfgs,
                accum_steps=int(self.wrapper.training_params.get(
                    "accum_steps", 1)))
        lr = self.wrapper.scheduler.lr(self.iters)
        mom = self.momentum_at(self.iters)
        # per-step draws (crops, dropout): a resumed run draws what the
        # original would
        self.generator.manual_seed((self.seed << 32) + self.iters)
        images = batch["image"].to(self.device, non_blocking=True)
        self.state, m = self._train_step(self.state, images, lr, mom,
                                         self.generator)
        return m, {"lr": lr, "ema_momentum": mom}

    # ------------------------------------------------------------------ #
    def train(self):
        if self.restore_session:
            self.load_session()
        loader = self.wrapper.dataloaders.trainloader
        steps_per_epoch = len(loader)
        val_interval = max(int(self.val_every * steps_per_epoch), 1)
        print(f"SSL training {self.model_name}: {self.epochs} epochs x "
              f"{steps_per_epoch} steps on {self.device}")
        t0 = time.time()
        images_seen = 0
        skip_first = self.iters % steps_per_epoch if self.iters else 0
        for epoch in range(self.epoch0, self.epochs):
            loader.set_epoch(epoch)
            self.epoch = epoch
            skip = skip_first if epoch == self.epoch0 else 0
            for bi, batch in enumerate(loader):
                if bi < skip:
                    continue
                m, extra = self.train_one(batch, epoch)
                images_seen += batch["label"].shape[0]
                self.iters += 1
                if self.iters % self.log_every == 0 or self.iters == 1:
                    rec = {("train_" + k if k == "loss" else k): float(v)
                           for k, v in m.items()}
                    rec.update(extra)
                    rec["images_per_sec"] = images_seen / max(
                        time.time() - t0, 1e-9)
                    self.log(rec, self.iters)
                    print(f"it {self.iters:6d} ep {epoch:3d} loss "
                          f"{rec['train_loss']:.4f} lr {extra.get('lr', 0):.2e}"
                          f" img/s {rec['images_per_sec']:.1f}")
                if self.iters % val_interval == 0:
                    self.epoch_step(epoch)
                    self._last_val_iter = self.iters
        if self._last_val_iter != self.iters:
            self.epoch_step(self.epochs - 1)
        self.save_session(self.epochs - 1)

    def epoch_step(self, epoch):
        results = self.evaluate()
        val_target = results.get(f"knn_val_{self.target_metric}")
        if val_target is not None and val_target >= self.best_val_target:
            self.best_val_target = val_target
            if self.save_best_model:
                weights = self._feature_weights()
                if weights is None:
                    weights = {n: p for n, p in self.state.trainable().items()
                               if n.startswith("backbone.")}
                self.best_trainable = {n: t.detach().cpu().clone()
                                       for n, t in weights.items()}
        self.log(results, self.iters)
        print(f"[knn val @ it {self.iters}] " + " ".join(
            f"{k}={v}" for k, v in results.items()))
        self.save_session(epoch)

    def evaluate(self, loader=None, prefix="val", weights=None):
        """kNN metrics (temperature 0.1) of `loader` (default: the val
        loader) against the feature bank, with the feature branch's backbone
        or `weights`."""
        if not self.wrapper.is_multiclass:
            raise NotImplementedError(
                "multi-label kNN evaluation is not ported yet (ROADMAP "
                "queue A: multi-label kNN)")
        return knn_evaluate(
            lambda x: self._embed(x, weights),
            self.wrapper.dataloaders.fbank_loader,
            loader or self.wrapper.dataloaders.valloader,
            self.wrapper.metric_class(self.n_classes, mode=f"knn_{prefix}",
                                      raw=False),
            self.n_classes, self.knn_nhood, 0.1, self.device)

    # ------------------------------------------------------------------ #
    def save_session(self, epoch):
        if self.is_dry or self.is_debug:
            return
        save_checkpoint(
            self.checkpoint_path, state=self.state, epoch=epoch,
            parameters=self.parameters,
            best_val_target=(None if self.best_val_target == -np.inf
                             else float(self.best_val_target)),
            best_trainable=self.best_trainable,
            aux_state=self.state.aux())

    def _restore(self, path, weights_only=False):
        manifest, best = load_checkpoint(path, self.state,
                                         weights_only=weights_only)
        aux = load_aux_state(path)
        if aux is not None:
            self.state.load_aux(aux)
        if best is not None:
            self.best_trainable = best
        return manifest

    def load_session(self):
        path = self.checkpoint_path
        if not os.path.isdir(path):
            print(f"restore_session: no checkpoint at {path}")
            return
        manifest = self._restore(path)
        self.iters = manifest["iters"]
        self.epoch0 = self.iters // max(
            len(self.wrapper.dataloaders.trainloader), 1)
        if manifest.get("best_val_target") is not None:
            self.best_val_target = manifest["best_val_target"]
        print(f"Restored SSL session from {path} at iter {self.iters}")

    def test(self, chpt_path=None):
        """kNN evaluation of the test set with the best feature-branch
        snapshot (of the checkpoint at `chpt_path` when given), else the
        current weights."""
        if chpt_path and os.path.isdir(chpt_path):
            self._restore(chpt_path, weights_only=True)
        results = self.evaluate(self.wrapper.dataloaders.testloader,
                                prefix="test", weights=self.best_trainable)
        print("SSL TEST RESULTS (kNN)")
        for k, v in results.items():
            print(f"  {k} : {v}")
        self.log(results, self.iters)
        return results
