"""Train state: step counter, the model and its optimizer.

Counterpart of `apla_tpu/train/train_state.py`.  The JAX state carries the
trainable tree and the optax state as values; here the model module holds
the trainable parameters (`requires_grad`) and the frozen ones, and the
train step updates model and optimizer in place.
"""

from __future__ import annotations

import dataclasses

import torch

from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer

    def trainable(self) -> dict:
        """name -> trainable parameter."""
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def frozen(self) -> dict:
        """name -> frozen parameter or buffer (`inds`)."""
        out = {n: p for n, p in self.model.named_parameters()
               if not p.requires_grad}
        out.update(self.model.named_buffers())
        return out
