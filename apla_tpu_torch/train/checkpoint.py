"""Checkpoint save/load.

Counterpart of `apla_tpu/train/checkpoint.py`: a directory holding

- `state.pt`: the trainable parameters, the optimizer state, when there is
  one the best-model trainable snapshot, and for an SSL run its auxiliary
  state (the EMA teacher and the centers; `torch.save`);
- `frozen.pt`: the frozen parameters and buffers, written once per
  directory (they never change), so a checkpoint's per-save size scales
  with the APLA rank;
- `manifest.json`: `iters`, `epoch`, `best_val_target` and any extra
  fields (the trainer adds `scheduler`);
- `parameters.pkl`: the run's full config.

The format is the port's own; the JAX package does not read it.
"""

from __future__ import annotations

import json
import os
import pickle

import torch

from .train_state import TrainState


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def save_checkpoint(path: str, *, state: TrainState, epoch: int = 0,
                    parameters: dict | None = None,
                    best_val_target: float | None = None,
                    best_trainable: dict | None = None,
                    aux_state: dict | None = None,
                    extra: dict | None = None) -> None:
    """`state`: anything with `step`, `optimizer`, `trainable()` and
    `frozen()` (a `TrainState` or the SSL states).  `aux_state`: name ->
    tensor saved beside the trainable tensors (`load_aux_state`)."""
    os.makedirs(path, exist_ok=True)
    payload = {"trainable": _cpu(state.trainable()),
               "optimizer": state.optimizer.state_dict()}
    if best_trainable is not None:
        payload["best_trainable"] = best_trainable
    if aux_state is not None:
        payload["aux"] = _cpu(aux_state)
    torch.save(payload, os.path.join(path, "state.pt"))
    frozen_path = os.path.join(path, "frozen.pt")
    if not os.path.exists(frozen_path):
        torch.save(_cpu(state.frozen()), frozen_path)
    manifest = {"iters": int(state.step), "epoch": int(epoch),
                "best_val_target": (None if best_val_target is None
                                    else float(best_val_target))}
    manifest.update(extra or {})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if parameters is not None:
        with open(os.path.join(path, "parameters.pkl"), "wb") as f:
            pickle.dump(dict(parameters), f)


def load_aux_state(path: str) -> dict | None:
    """The `aux_state` a checkpoint was saved with (CPU tensors), or
    None."""
    payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                         weights_only=False)
    return payload.get("aux")


def load_checkpoint(path: str, state: TrainState, weights_only: bool = False):
    """Restore `state` in place from `path`: trainable and frozen weights,
    and unless `weights_only` the optimizer state and step.  Returns
    (manifest, best_trainable or None)."""
    payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                         weights_only=False)
    frozen_path = os.path.join(path, "frozen.pt")
    weights = dict(payload["trainable"])
    if os.path.exists(frozen_path):
        weights.update(torch.load(frozen_path, map_location="cpu"))
    state.model.load_state_dict(weights, strict=True)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if not weights_only:
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(manifest["iters"])
    return manifest, payload.get("best_trainable")
