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
        """name -> frozen parameter or persistent buffer (`inds`, a W8A8
        kernel's `w_int8` / `scale`)."""
        return frozen_state(self.model)


def frozen_state(model: torch.nn.Module) -> dict:
    """The entries of `model.state_dict()` that take no gradient: frozen
    parameters and persistent buffers (not `QuantizedKernel.w_kmajor`,
    which every load makes anew)."""
    return {n: t for n, t in model.state_dict(keep_vars=True).items()
            if not (isinstance(t, torch.nn.Parameter) and t.requires_grad)}


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
