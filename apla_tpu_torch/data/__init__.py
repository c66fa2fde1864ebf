"""Data: the synthetic dataset, the loader, mixup/cutmix and the on-device
augmentation tail (counterpart of `apla_tpu/data/`)."""
