"""Train state: step counter, the model and its optimizer.

Counterpart of `apla_tpu/train/train_state.py`.  The JAX state carries the
trainable tree and the optax state as values; here the model module holds
the trainable parameters (`requires_grad`) and the frozen ones, and the
train step updates model and optimizer in place.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def weights_swapped(params: dict, values: dict | None):
    """Parameters `params` (name -> parameter) hold `values` (name ->
    tensor of the same shape) inside the block, and their own data again
    after it; `values` None changes nothing.  The data are swapped, not
    copied (an SSL teacher runs on the student's modules this way); use it
    under `torch.no_grad()`."""
    if values is None:
        yield
        return
    saved = {}
    try:
        for name, v in values.items():
            p = params[name]
            saved[name] = p.data
            p.data = v.to(device=p.device, dtype=p.dtype)
        yield
    finally:
        for name, d in saved.items():
            params[name].data = d
