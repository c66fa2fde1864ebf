"""DINO (v1): only what the DINOv2 wrapper inherits.

Counterpart of `apla_tpu/ssl/dino.py:82-85`: `DINOWrapper` is the BYOL
plumbing with the "dino" multi-crop strategy.  The DINO v1 objective (its
head, step and trainer) is not ported yet (ROADMAP queue A: BYOL/SimSiam/
DINO v1 objectives).
"""

from __future__ import annotations

from .byol import ROADMAP_OBJECTIVES, BYOLTrainer, BYOLWrapper


class DINOWrapper(BYOLWrapper):
    is_supervised = False
    use_momentum = True
    strategy_name = "dino"   # the host strategy and the device crop configs


class DINOTrainer(BYOLTrainer):
    feature_branch = "teacher"

    def __init__(self, wrapper, freeze_last_for=1):
        raise NotImplementedError(f"the DINO v1 trainer is not ported yet "
                                  f"({ROADMAP_OBJECTIVES})")
