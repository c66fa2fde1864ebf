"""Classification losses.

Counterpart of `apla_tpu/train/losses.py`: cross entropy for multiclass
(integer or soft targets, as the mixup/cutmix collate produces), BCE with
logits for multi-label/binary.  Logits go to float32 first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels):
    """Integer labels -> standard CE; float labels of the logits' rank ->
    soft-target CE.  Mean over the batch."""
    logits = logits.float()
    if labels.dim() == logits.dim() and labels.is_floating_point():
        return -(labels.float() * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    return F.cross_entropy(logits, labels.long())


def bce_with_logits(logits, labels):
    logits = logits.float()
    labels = labels.float()
    if labels.dim() == logits.dim() - 1:
        # binary head: logits [B, 1] vs labels [B] -- align instead of
        # broadcasting to a [B, B] loss
        labels = labels[..., None]
    return F.binary_cross_entropy_with_logits(logits, labels)


def get_criterion(task: str, is_multiclass: bool):
    if task != "classification":
        raise NotImplementedError("Only classification tasks for now")
    return cross_entropy if is_multiclass else bce_with_logits
