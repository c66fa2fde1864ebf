"""Self-supervised objectives: DINOv2 (`ssl/dinov2.py`); BYOL, SimSiam and
DINO v1 wait (ROADMAP queue A: BYOL/SimSiam/DINO v1 objectives)."""


def get_ssl_wrapper_and_trainer(args):
    """(wrapper class, trainer class) for the SSL flag in `args`
    (`apla_tpu/ssl/__init__.py`)."""
    if args.dinov2:
        from .dinov2 import DINOv2Wrapper, Dinov2Trainer
        return DINOv2Wrapper, Dinov2Trainer
    flag = "--dino" if args.dino else "--byol" if args.byol else "--simsiam"
    raise NotImplementedError(
        f"{flag}: the objective is not ported yet (ROADMAP queue A: "
        "BYOL/SimSiam/DINO v1 objectives)")
