"""Mixup / CutMix batch collate.

Counterpart of `apla_tpu/data/mixup.py` (numpy, timm's batch-mode `Mixup`
semantics), enabled by `dataset_params.train_transforms.advanced_aug`.
`__call__` draws from the collate's own generator, seeded from the params,
unless the loader hands it one (`rng`): the port's loader passes one keyed
by (seed, epoch, batch index), so batches do not depend on which worker
process collates them.  `collate_rows` gives a data-parallel rank its rows
of the batch's mix (`data/loader.py`).
"""

from __future__ import annotations

import numpy as np


def one_hot(labels, num_classes, on_value, off_value):
    out = np.full((len(labels), num_classes), off_value, dtype=np.float32)
    out[np.arange(len(labels)), labels] = on_value
    return out


def rand_bbox(h, w, lam, rng):
    """CutMix box with area ratio (1-lam)."""
    cut_ratio = np.sqrt(1.0 - lam)
    cut_h, cut_w = int(h * cut_ratio), int(w * cut_ratio)
    cy = int(rng.integers(0, h))
    cx = int(rng.integers(0, w))
    y1, y2 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    x1, x2 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    return y1, y2, x1, x2


class AdvancedAugCollate:
    def __init__(self, adv_aug_params: dict):
        p = dict(adv_aug_params)
        self.mixup_alpha = float(p.get("mixup_alpha", 0.8))
        self.cutmix_alpha = float(p.get("cutmix_alpha", 1.0))
        self.prob = float(p.get("prob", 1.0))
        self.switch_prob = float(p.get("switch_prob", 0.5))
        self.label_smoothing = float(p.get("label_smoothing", 0.1))
        self.num_classes = int(p.get("num_classes", 1000))
        self.rng = np.random.default_rng(p.get("seed", 0))

    def __call__(self, samples, rng: np.random.Generator | None = None,
                 batch_key=None):
        del batch_key
        return self._mix(samples, samples[::-1], rng)

    def collate_rows(self, samples, positions, n, load, rng=None,
                     batch_key=None):
        """A rank's rows (`samples` at `positions` of a batch of `n`):
        each pairs with the batch's row n - 1 - position (timm's flip), so
        the rank loads those partners (`load(position)`), at most as many
        again, and mixes with the batch's one lambda / box."""
        del batch_key
        partners = [load(n - 1 - p) for p in positions]
        return self._mix(samples, partners, rng)

    def _mix(self, samples, partners, rng):
        rng = self.rng if rng is None else rng
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        labels = np.asarray([s["label"] for s in samples], dtype=np.int64)
        n = self.num_classes
        off = self.label_smoothing / n
        on = 1.0 - self.label_smoothing + off
        targets = one_hot(labels, n, on, off)

        if rng.random() < self.prob:
            use_cutmix = (self.cutmix_alpha > 0
                          and rng.random() < self.switch_prob) \
                or self.mixup_alpha <= 0
            # timm batch mode: row i pairs with row B - 1 - i
            perm = np.stack([s["image"] for s in partners]).astype(
                np.float32)
            t_perm = one_hot(np.asarray([s["label"] for s in partners],
                                        dtype=np.int64), n, on, off)
            if use_cutmix:
                lam = float(rng.beta(self.cutmix_alpha, self.cutmix_alpha))
                h, w = images.shape[1:3]
                y1, y2, x1, x2 = rand_bbox(h, w, lam, rng)
                images = images.copy()
                images[:, y1:y2, x1:x2] = perm[:, y1:y2, x1:x2]
                lam = 1.0 - ((y2 - y1) * (x2 - x1) / (h * w))
            else:
                lam = float(rng.beta(self.mixup_alpha, self.mixup_alpha))
                images = lam * images + (1.0 - lam) * perm
            targets = lam * targets + (1.0 - lam) * t_perm

        return {"image": images.astype(np.float32),
                "label": targets.astype(np.float32)}
