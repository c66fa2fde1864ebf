"""Training: losses, optimizers, schedules, steps, metrics, checkpoints and
the run loop (counterpart of `apla_tpu/train/`)."""
