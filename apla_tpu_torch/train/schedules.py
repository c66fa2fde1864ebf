"""Learning-rate schedules with reference-parity semantics.

Carried over line for line from `apla_tpu/train/schedules.py` (numpy only):
the card's machine cannot import the JAX copy, whose package `__init__`
imports optax.  The learning rate is computed on the host as a closed-form
function of the iteration (plus host-side plateau/milestone state) and
written into the optimizer's param groups each step.

Supported types (reference whitelist): LinearWarmup, CosineAnnealingLR,
MultiStepLR, OneCycleLR, PolynomialLR, ReduceLROnPlateau, composed as the
reference's MixedLRScheduler composes them:
- warmup ramps eta_min -> max_lr over `warmup_iters` iterations;
- cosine/polynomial only start stepping after warmup (T_max = total - warmup);
- MultiStepLR decays by gamma at epoch milestones;
- ReduceLROnPlateau applies a multiplicative factor driven by val metrics,
  evaluated once per epoch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class LRScheduler:
    """Host-side LR multiplexer.  `lr(it)` returns the scalar for iteration
    `it` (0-based); `epoch_feedback(val_acc, val_loss)` drives plateau decay.
    """

    ACCEPTED = [None, "LinearWarmup", "MultiStepLR", "ReduceLROnPlateau",
                "OneCycleLR", "CosineAnnealingLR", "PolynomialLR"]

    def __init__(self, scheduler_types, sched_params, max_lr: float,
                 steps_per_epoch: int, epochs: int):
        if not isinstance(scheduler_types, (list, tuple)):
            scheduler_types = [scheduler_types]
        for st in scheduler_types:
            if st not in self.ACCEPTED:
                raise ValueError(f"{st} is not a supported scheduler")
        self.types = [t for t in scheduler_types if t is not None]
        self.params = sched_params or {}
        self.max_lr = float(max_lr)
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.total_iters = self.steps_per_epoch * int(epochs)

        # --- warmup (reference LinearWarmup, _utils.py:123-172) ---
        self.warmup_iters = 0
        self.warmup_eta_min = 1e-8
        if "LinearWarmup" in self.types:
            wp = dict(self.params.get("LinearWarmup", {}))
            warmup_iters = int(wp.get("warmup_iters", 0) or 0)
            warmup_epochs = int(wp.get("warmup_epochs", 0) or 0)
            if warmup_epochs:  # epochs take precedence (reference behaviour)
                warmup_iters = warmup_epochs * self.steps_per_epoch
            self.warmup_iters = max(warmup_iters, 1)
            self.warmup_eta_min = float(wp.get("eta_min", 1e-8))

        # --- plateau state ---
        self._plateau_factor = 1.0
        if "ReduceLROnPlateau" in self.types:
            pp = dict(self.params.get("ReduceLROnPlateau", {}))
            self._p_mode = pp.get("mode", "min")
            self._p_factor = float(pp.get("factor", 0.1))
            self._p_patience = int(pp.get("patience", 10))
            self._p_best = -math.inf if self._p_mode == "max" else math.inf
            self._p_bad_epochs = 0

        # --- multistep state ---
        self._ms_milestones = []
        self._ms_gamma = 0.1
        if "MultiStepLR" in self.types:
            mp = dict(self.params.get("MultiStepLR", {}))
            self._ms_milestones = sorted(mp.get("milestones", []) or [])
            self._ms_gamma = float(mp.get("gamma", 0.1))

        # --- cosine / polynomial / onecycle ---
        cp = dict(self.params.get("CosineAnnealingLR", {}))
        self._cos_eta_min = float(cp.get("eta_min", 0.0))
        pp2 = dict(self.params.get("PolynomialLR", {}))
        self._poly_power = float(pp2.get("power", 1.0))
        oc = dict(self.params.get("OneCycleLR", {}))
        self._oc_pct_start = float(oc.get("pct_start", 0.3))
        self._oc_final_div = float(oc.get("final_div_factor", 1e4))
        self._oc_div = float(oc.get("div_factor",
                                    1.0 if "LinearWarmup" in self.types
                                    else self.max_lr / 1e-8))
        self._oc_strategy = oc.get("anneal_strategy", "cos")

    # ------------------------------------------------------------------ #
    @property
    def _post_warmup_peak(self) -> float:
        """LR at the end of warmup, REFERENCE-EXACT: torch LinearWarmup's
        get_lr guard is `last_epoch > warmup_iters`, so the step at
        last_epoch == warmup_iters adds one increment too many — the lr
        actually reached is max_lr + (max_lr - eta_min)/W, and the cosine /
        polynomial tail telescopes from that value (verified step-for-step
        against the reference scheduler stack in
        tests/test_trajectory_parity.py)."""
        if self.warmup_iters > 0 and "LinearWarmup" in self.types:
            return self.max_lr + (self.max_lr - self.warmup_eta_min) \
                / self.warmup_iters
        return self.max_lr

    def lr(self, it: int) -> float:
        """LR at 0-based iteration `it`."""
        main_iters = max(self.total_iters - self.warmup_iters, 1)

        if "OneCycleLR" in self.types:
            # reference composition quirk (MixedLRScheduler, _utils.py:
            # 369-415): OneCycleLR is iteration-based, so with LinearWarmup
            # present BOTH step every iteration and OneCycle (later in the
            # list) overwrites the group lr the warmup just wrote.  The
            # effective schedule is therefore the bare cycle over ALL
            # iterations — wrappers.py:272-276 sets div_factor=1.0 so it
            # starts at max_lr instead of ramping.
            base = self._one_cycle(it)
        elif it < self.warmup_iters and self.warmup_iters > 0:
            frac = (it + 1) / self.warmup_iters
            base = self.warmup_eta_min + frac * (self.max_lr - self.warmup_eta_min)
        else:
            t = it - self.warmup_iters
            peak = self._post_warmup_peak
            if "CosineAnnealingLR" in self.types:
                prog = min(t / main_iters, 1.0)
                base = self._cos_eta_min + 0.5 * (peak - self._cos_eta_min) \
                    * (1.0 + math.cos(math.pi * prog))
            elif "PolynomialLR" in self.types:
                prog = min(t / main_iters, 1.0)
                base = peak * (1.0 - prog) ** self._poly_power
            else:
                base = peak

        if self._ms_milestones:
            epoch = it // self.steps_per_epoch
            n_decays = sum(1 for m in self._ms_milestones if epoch >= m)
            base *= self._ms_gamma ** n_decays

        return base * self._plateau_factor

    def _one_cycle(self, it: int) -> float:
        # the cycle spans ALL iterations (see the composition note in lr():
        # with LinearWarmup present the reference's OneCycle still runs over
        # the full horizon, div_factor=1)
        total = max(self.total_iters, 1)
        init_lr = self.max_lr / self._oc_div
        final_lr = init_lr / self._oc_final_div
        up = max(int(self._oc_pct_start * total), 1)
        down = max(total - up, 1)

        def anneal(a, b, pct):
            if self._oc_strategy == "linear":
                return a + (b - a) * pct
            return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1)

        if it < up:
            return anneal(init_lr, self.max_lr, it / up)
        return anneal(self.max_lr, final_lr, min((it - up) / down, 1.0))

    # ------------------------------------------------------------------ #
    def epoch_feedback(self, val_target: Optional[float] = None,
                       val_loss: Optional[float] = None) -> None:
        """Once-per-epoch hook for ReduceLROnPlateau (reference steps it every
        `steps_per_epoch` iters with val metric / loss, _utils.py:395-400)."""
        if "ReduceLROnPlateau" not in self.types:
            return
        metric = val_target if self._p_mode == "max" else val_loss
        if metric is None:
            return
        improved = (metric > self._p_best) if self._p_mode == "max" \
            else (metric < self._p_best)
        if improved:
            self._p_best = metric
            self._p_bad_epochs = 0
        else:
            self._p_bad_epochs += 1
            if self._p_bad_epochs > self._p_patience:
                self._plateau_factor *= self._p_factor
                self._p_bad_epochs = 0

    def state_dict(self) -> dict:
        d = {"plateau_factor": self._plateau_factor}
        if "ReduceLROnPlateau" in self.types:
            d.update(best=self._p_best, bad_epochs=self._p_bad_epochs)
        return d

    def load_state_dict(self, d: dict) -> None:
        self._plateau_factor = d.get("plateau_factor", 1.0)
        if "ReduceLROnPlateau" in self.types:
            self._p_best = d.get("best", self._p_best)
            self._p_bad_epochs = d.get("bad_epochs", 0)


def cosine_with_warmup_table(base_value, final_value, iters, warmup_iters=0,
                             warmup_init_val=None) -> np.ndarray:
    """Dense schedule table — parity with the reference's SSL
    `CosineSchedulerWithWarmup` (`_utils.py:261-288`) and DINOv2's
    `CosineScheduler` (`dinov2_utils.py:143-163`): linear warmup then
    half-cosine from base to final.  Returns np.float32 [iters]."""
    if warmup_init_val is None:
        warmup_init_val = base_value
    warmup = np.linspace(warmup_init_val, base_value, warmup_iters)
    n = max(iters - warmup_iters, 0)
    steps = np.arange(n)
    core = final_value + 0.5 * (base_value - final_value) * \
        (1 + np.cos(np.pi * steps / max(len(steps), 1)))
    sched = np.concatenate([warmup, core])
    if not sched.size:
        sched = np.array([base_value])
    return sched.astype(np.float32)
