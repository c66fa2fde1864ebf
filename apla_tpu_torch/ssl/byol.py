"""Shared SSL plumbing: the wrapper's multi-crop set-up and the run loop.

Counterpart of the parts of `apla_tpu/ssl/byol.py` that the DINOv2
objective inherits: `BYOLWrapper.update_augmentation_strategy` and
`_setup_device_multicrop` (`:84-115`), and the `BYOLTrainer` run loop
(`:352-602`): train, validation by kNN on the feature branch's backbone,
best-model tracking, checkpoints with the auxiliary state (teacher,
centers), resume and the kNN test table.  The trainer keeps its records in
`history`, as `Trainer` does.

The BYOL/SimSiam objective itself (heads with BatchNorm, the train step)
is not ported yet: `make_byol_train_step`, `BYOLWrapper.init_model` and
`BYOLTrainer.train_one` raise naming ROADMAP queue A.  Only the on-device
multi-crop path exists (the JAX package's `dataset_params.device_augment`
one): the host multi-crop transforms need the PIL-free transforms (ROADMAP
queue A).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.vit import vit_features
from ..train.checkpoint import load_aux_state, load_checkpoint, \
    save_checkpoint
from ..train.knn import knn_evaluate
from ..train.train_state import weights_swapped
from ..wrapper import DefaultWrapper
from .multicrop import apply_augmentation_strategy, resolve_strategy_spec

ROADMAP_OBJECTIVES = "ROADMAP queue A: BYOL/SimSiam/DINO v1 objectives"


def make_byol_train_step(*args, **kwargs):
    raise NotImplementedError(f"the BYOL/SimSiam train step is not ported "
                              f"yet ({ROADMAP_OBJECTIVES})")


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

    def init_model(self, seed: int = 0):
        raise NotImplementedError(f"the BYOL/SimSiam heads are not ported "
                                  f"yet ({ROADMAP_OBJECTIVES})")

    def init_optimization(self):
        raise NotImplementedError(f"the BYOL/SimSiam optimisation is not "
                                  f"ported yet ({ROADMAP_OBJECTIVES})")


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

    # ------------------------------------------------------------------ #
    @property
    def checkpoint_path(self):
        return os.path.join(self.save_dir, self.model_name)

    def log(self, record: dict, it: int):
        self.history.append((it, dict(record)))

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
        raise NotImplementedError(f"the BYOL/SimSiam train step is not "
                                  f"ported yet ({ROADMAP_OBJECTIVES})")

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
