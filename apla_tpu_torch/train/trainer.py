"""Supervised Trainer: the run loop.

Counterpart of `apla_tpu/train/trainer.py:29-331`: validation every
`val_every` fraction of an epoch, logging every `log_every` steps, best-model
tracking by the dataset's `target_metric`, the plateau schedule fed once per
epoch, checkpoint save and resume (a resume inside an epoch skips the
batches already trained: the shuffle is deterministic in (seed, epoch)),
a checkpoint on SIGTERM/SIGINT at the next step boundary, and the test
table, with the kNN rows when `training_params.knn_eval` is set (`--knn`).
`training_params.profile_dir` traces steps 10..20 with `torch.profiler` (a
chrome trace plus the by-kernel table).  Each record goes to the run
logger (`utils/logging.make_run_logger`: on rank 0,
`<save_dir>/<run_name>.metrics.jsonl` and the optional wandb run), is kept
in `history` and printed.

Data parallel (`apla_tpu/train/trainer.py:134-148`, `:280-300`): each rank
trains on its rows of the global batch (the loaders are sharded by the
wrapper; the last batch padded to a multiple of W by repeating its last
row, whose copies enter the loss as JAX's do); `evaluate` and the kNN
gather the per-row outputs in global order and drop the padding, so every
rank's metrics are the 1-device run's; every rank saves (the checkpoint
writer writes on rank 0 only) and reads; a preemption signal on any rank
stops every rank at the same step boundary.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time

import numpy as np
import torch

from ..parallel.collectives import any_rank, data_size, gather_rows
from ..utils.logging import make_run_logger
from ..utils.profiling import StepTimer, device_memory_stats
from .checkpoint import load_checkpoint, save_checkpoint
from .knn import knn_evaluate
from .steps import make_embed_step, make_eval_step, make_train_step


class Trainer:
    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.parameters = wrapper.parameters
        tp = wrapper.training_params
        self.epochs = int(tp.epochs)
        self.val_every = float(tp.get("val_every", 1.0))
        self.log_every = int(tp.get("log_every", 25))
        self.save_best_model = bool(tp.get("save_best_model", True))
        self.restore_session = bool(tp.get("restore_session", False))
        self.restore_only_model = bool(tp.get("restore_only_model", False))
        self.model_name = tp.get("model_name", "model")
        self.save_dir = tp.get("save_dir", "checkpoints")
        self.is_debug = bool(tp.get("is_debug", False))
        self.is_dry = bool(tp.get("is_dry", False))
        self.seed = int(tp.get("seed", 0))
        self.knn_eval = bool(tp.get("knn_eval", False))
        self.knn_nhood = int(wrapper.model_params.get("knn_nhood", 200))

        self.device = wrapper.device
        self.vit_cfg = wrapper.vit_cfg
        self.state = wrapper.state
        self.scheduler = wrapper.scheduler
        self.criterion = wrapper.criterion
        self.target_metric = wrapper.model_params.target_metric
        self.n_classes = int(wrapper.model_params.n_classes)

        self.train_step = make_train_step(
            self.vit_cfg, wrapper.optimizer, self.criterion,
            device_aug_cfg=wrapper.device_aug_cfg,
            accum_steps=int(tp.get("accum_steps", 1)),
            skip_nonfinite=bool(tp.get("skip_nonfinite_updates", False)))
        self.eval_step = make_eval_step(self.vit_cfg, self.criterion)
        self.embed_step = make_embed_step(self.vit_cfg)

        self.iters = 0
        self.epoch0 = 0
        self.best_val_target = -np.inf
        self.best_trainable = None
        self.generator = torch.Generator(device=self.device)
        self.history = []          # (iteration, record) for every log call
        self._preempted = False
        self._last_val_iter = -1
        self._plateau_fed_epoch = -1
        self.logger = make_run_logger(wrapper, self)

    # ------------------------------------------------------------------ #
    @property
    def checkpoint_path(self):
        return os.path.join(self.save_dir, self.model_name)

    def log(self, record: dict, it: int):
        self.history.append((it, dict(record)))
        self.logger.log(record, it)

    def load_session(self):
        """Resume from the last checkpoint."""
        path = self.checkpoint_path
        if not os.path.isdir(path):
            print(f"restore_session: no checkpoint at {path}")
            return
        manifest, best = load_checkpoint(
            path, self.state, weights_only=self.restore_only_model)
        if not self.restore_only_model:
            self.iters = manifest["iters"]
            # the resume epoch follows from the iteration count, so a
            # checkpoint written at the end of training resumes as a no-op
            self.epoch0 = self.iters // max(
                len(self.wrapper.dataloaders.trainloader), 1)
            if manifest.get("best_val_target") is not None:
                self.best_val_target = manifest["best_val_target"]
            self.scheduler.load_state_dict(manifest.get("scheduler", {}))
        self.best_trainable = best
        print(f"Restored session from {path} at iter {self.iters}")

    def save_session(self, epoch, verbose=False):
        if self.is_dry or self.is_debug:
            return
        save_checkpoint(
            self.checkpoint_path, state=self.state, epoch=epoch,
            parameters=self.parameters,
            best_val_target=(None if self.best_val_target == -np.inf
                             else self.best_val_target),
            best_trainable=self.best_trainable,
            extra={"scheduler": self.scheduler.state_dict()})
        if verbose:
            print(f"Checkpoint saved to {self.checkpoint_path}")

    # ------------------------------------------------------------------ #
    def _device_batch(self, batch):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items() if k != "valid"}

    @contextlib.contextmanager
    def _preemption_handler(self):
        """SIGTERM/SIGINT request a checkpoint at the next step boundary;
        the previous handlers come back afterwards."""
        def handler(signum, frame):
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass            # not the main thread: set the flag directly
        try:
            yield
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _profile_step(self, prof):
        """Starts the profiler at step 10 and stops it at step 20 when
        `training_params.profile_dir` is set; returns the live profiler."""
        profile_dir = self.wrapper.training_params.get("profile_dir")
        if not profile_dir:
            return None
        if prof is None and self.iters == 10:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        elif prof is not None and self.iters == 20:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "train_trace.json"))
            sort = "cuda_time_total" if self.device.type == "cuda" \
                else "cpu_time_total"
            print(prof.key_averages().table(sort_by=sort, row_limit=20))
            print(f"profiler trace of steps 10..20 written to {profile_dir}")
            prof = None
        return prof

    def train(self):
        if self.restore_session:
            self.load_session()
        loader = self.wrapper.dataloaders.trainloader
        steps_per_epoch = len(loader)
        val_interval = max(int(self.val_every * steps_per_epoch), 1)
        print(f"Training {self.model_name}: {self.epochs} epochs x "
              f"{steps_per_epoch} steps on {self.device}")
        t_start = time.time()
        images_seen = 0
        skip_first = self.iters % steps_per_epoch if self.iters else 0
        timer = StepTimer(sync_every=self.log_every)
        prof = None
        with self._preemption_handler():
            for epoch in range(self.epoch0, self.epochs):
                loader.set_epoch(epoch)
                skip = skip_first if epoch == self.epoch0 else 0
                for bi, batch in enumerate(loader):
                    if bi < skip:
                        continue
                    lr = self.scheduler.lr(self.iters)
                    # per-step draws, as the JAX step folds the step into
                    # its key: a resumed run draws what the original would
                    self.generator.manual_seed((self.seed << 32) + self.iters)
                    self.state, m = self.train_step(
                        self.state, self._device_batch(batch), lr,
                        self.generator)
                    images_seen += batch["label"].shape[0] * data_size()
                    self.iters += 1
                    timer.tick(sync_value=m["loss"])
                    prof = self._profile_step(prof)

                    if self.iters % self.log_every == 0:
                        loss = float(m["loss"])
                        gnorm = float(m["grad_norm"])
                        ips = images_seen / max(time.time() - t_start, 1e-9)
                        rec = {"train_loss": loss, "lr": lr,
                               "grad_norm": gnorm, "images_per_sec": ips}
                        rec.update(timer.summary())
                        rec.update(device_memory_stats(self.device))
                        self.log(rec, self.iters)
                        print(f"it {self.iters:6d} ep {epoch:3d} "
                              f"loss {loss:.4f} lr {lr:.2e} "
                              f"gnorm {gnorm:.2f} img/s {ips:.1f}")

                    if self.iters % val_interval == 0:
                        self.epoch_step(epoch)
                        self._last_val_iter = self.iters

                    self._preempted = any_rank(self._preempted,
                                               self.device)
                    if self._preempted:
                        print(f"Preemption signal received: saving "
                              f"checkpoint at iter {self.iters}")
                        self.save_session(epoch, verbose=True)
                        self.logger.finish()
                        return
        if prof is not None:
            prof.__exit__(None, None, None)
        if self._last_val_iter != self.iters:
            self.epoch_step(self.epochs - 1)
        self.save_session(self.epochs - 1, verbose=True)
        self.logger.finish()

    # ------------------------------------------------------------------ #
    def epoch_step(self, epoch):
        """Validate, select the best model, checkpoint."""
        results = self.evaluate(self.wrapper.dataloaders.valloader,
                                prefix="val")
        val_target = results.get(f"val_{self.target_metric}")
        # plateau patience counts epochs: with val_every < 1 this runs
        # several times per epoch, so the scheduler is fed once per epoch
        if epoch != self._plateau_fed_epoch:
            self.scheduler.epoch_feedback(val_target=val_target,
                                          val_loss=results.get("val_loss"))
            self._plateau_fed_epoch = epoch
        if val_target is not None and val_target >= self.best_val_target:
            self.best_val_target = val_target
            if self.save_best_model:
                self.best_trainable = {
                    k: v.detach().cpu().clone()
                    for k, v in self.state.trainable().items()}
        self.log(results, self.iters)
        print(f"[val @ it {self.iters}] " + " ".join(
            f"{k}={v}" for k, v in results.items()))
        self.save_session(epoch)

    @contextlib.contextmanager
    def _trainable_swapped(self, trainable):
        """The model with `trainable` (name -> tensor) loaded, restored on
        exit; unchanged when `trainable` is None."""
        if trainable is None:
            yield
            return
        live = self.state.trainable()
        saved = {k: v.detach().clone() for k, v in live.items()}
        with torch.no_grad():
            for k, v in trainable.items():
                live[k].copy_(v)
        try:
            yield
        finally:
            with torch.no_grad():
                for k, v in saved.items():
                    live[k].copy_(v)

    def evaluate(self, loader, prefix="val", trainable=None):
        metric = self.wrapper.metric_class(self.n_classes, mode=prefix)
        loss_sum, loss_count = 0.0, 0
        with self._trainable_swapped(trainable):
            for batch in loader:
                losses, logits = self.eval_step(self.state.model,
                                                self._device_batch(batch))
                labels = batch["label"]
                if "valid" in batch:
                    losses, logits, labels = gather_rows(
                        batch["valid"], losses, logits, labels)
                loss_sum += float(losses.sum())
                loss_count += int(losses.shape[0])
                metric.add_preds(logits.float().cpu().numpy(),
                                 labels.numpy())
        results = metric.get_values()
        results[f"{prefix}_loss"] = round(loss_sum / max(loss_count, 1), 4)
        return results

    # ------------------------------------------------------------------ #
    def test(self, chpt_path=None):
        """Test-set evaluation with the best weights: those of the
        checkpoint at `chpt_path` when given, else the best of this run."""
        trainable = self.best_trainable
        if chpt_path and os.path.isdir(chpt_path):
            _, best = load_checkpoint(chpt_path, self.state,
                                      weights_only=True)
            trainable = best
        results = self.evaluate(self.wrapper.dataloaders.testloader,
                                prefix="test", trainable=trainable)
        if self.knn_eval and self.wrapper.dataloaders.fbank_loader is not None:
            results.update(self.knn_evaluate(
                self.wrapper.dataloaders.testloader, trainable, prefix="test"))
        print("TEST RESULTS")
        width = max(len(k) for k in results)
        for k, v in results.items():
            print(f"  {k:<{width}} : {v}")
        self.log(results, self.iters)
        return results

    def knn_evaluate(self, loader, trainable=None, prefix="val"):
        """kNN metrics of `loader` against the feature bank (the training
        images through the eval transforms), temperature 0.07, with the
        weights `trainable` (name -> tensor) or the live ones; a
        multi-label set votes with the neighbours' label vectors."""
        model = self.state.model
        with self._trainable_swapped(trainable):
            return knn_evaluate(
                lambda x: self.embed_step(model, x),
                self.wrapper.dataloaders.fbank_loader, loader,
                self.wrapper.metric_class(self.n_classes,
                                          mode=f"knn_{prefix}"),
                self.n_classes, self.knn_nhood, 0.07, self.device)
