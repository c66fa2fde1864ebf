"""Self-supervised objectives: BYOL and SimSiam (`ssl/byol.py`), DINO v1
(`ssl/dino.py`) and DINOv2 (`ssl/dinov2.py`)."""

import functools


def get_ssl_wrapper_and_trainer(args):
    """(wrapper class, trainer class) for the SSL flag in `args`
    (`apla_tpu/ssl/__init__.py`).  BYOL and SimSiam share one wrapper
    class; the flag goes to the instance (`use_momentum`), not the class,
    so one run's choice does not carry into the next in the same
    process."""
    if args.dinov2:
        from .dinov2 import DINOv2Wrapper, Dinov2Trainer
        return DINOv2Wrapper, Dinov2Trainer
    if args.dino:
        from .dino import DINOTrainer, DINOWrapper
        return DINOWrapper, DINOTrainer
    from .byol import BYOLTrainer, BYOLWrapper
    return (functools.partial(BYOLWrapper, use_momentum=bool(args.byol)),
            BYOLTrainer)
