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

The format is the port's own; the JAX package does not read it.  With
more than one rank every rank calls `save_checkpoint` (FSDP's and TP's
frozen shards are gathered whole for `frozen.pt`; under a pipeline's "pp"
placement every stage's block tensors, trainable ones, their optimizer
state and an SSL teacher's among them, from the stage that holds them)
and rank 0 alone writes whole tensors, which a one-rank run loads;
`load_checkpoint` on every rank cuts them to the rank's placement.

Transfer learning (`transfer_learning_params.pretrained_path`, and `serve
export --pretrained_path`) reads such a directory with
`load_transfer_checkpoint` and adopts it into a model with `transfer_into`,
as `apla_tpu/train/checkpoint.py:138-239` does with its own format: the
whole trainable and frozen state when the names match, else the backbone
alone (SSL pre-training -> supervised fine-tune, and back).
"""

from __future__ import annotations

import json
import os
import pickle

import torch

from ..ops.quant import quantize_like_state
from ..parallel.collectives import broadcast_object, is_rank0, synchronize
from ..parallel.mesh import (local_optimizer_state, local_state,
                             whole_optimizer_state, whole_state)
from .train_state import TrainState, frozen_state


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
    frozen_path = os.path.join(path, "frozen.pt")
    frozen = None
    # the sharded tensors are the model's (every rank gathers)
    whole = (lambda t: whole_state(state.model, t)) \
        if hasattr(state, "model") else (lambda t: t)
    if broadcast_object(not os.path.exists(frozen_path)):
        frozen = _cpu(whole(state.frozen()))
    trainable = _cpu(whole(state.trainable()))
    optimizer = state.optimizer.state_dict()
    if hasattr(state, "model"):
        optimizer = whole_optimizer_state(state.model, optimizer,
                                          state.optimizer.params)
    if best_trainable is not None:
        best_trainable = _cpu(whole(best_trainable))
    if aux_state is not None:
        aux_state = _cpu(whole(aux_state))
    if not is_rank0():
        synchronize()
        return
    os.makedirs(path, exist_ok=True)
    payload = {"trainable": trainable, "optimizer": optimizer}
    if best_trainable is not None:
        payload["best_trainable"] = best_trainable
    if aux_state is not None:
        payload["aux"] = aux_state
    torch.save(payload, os.path.join(path, "state.pt"))
    if frozen is not None:
        torch.save(frozen, frozen_path)
    manifest = {"iters": int(state.step), "epoch": int(epoch),
                "best_val_target": (None if best_val_target is None
                                    else float(best_val_target))}
    manifest.update(extra or {})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if parameters is not None:
        with open(os.path.join(path, "parameters.pkl"), "wb") as f:
            pickle.dump(dict(parameters), f)
    synchronize()


def load_aux_state(path: str, model=None) -> dict | None:
    """The `aux_state` a checkpoint was saved with (CPU tensors), or
    None; cut to `model`'s placement when given."""
    payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                         weights_only=False)
    aux = payload.get("aux")
    return aux if aux is None or model is None else local_state(model, aux)


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
    quantize_like_state(state.model, weights)
    state.model.load_state_dict(local_state(state.model, weights),
                                strict=True)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if not weights_only:
        state.optimizer.load_state_dict(local_optimizer_state(
            state.model, payload["optimizer"], state.optimizer.params))
        state.step = int(manifest["iters"])
    best = payload.get("best_trainable")
    return manifest, (None if best is None
                      else local_state(state.model, best))


def load_parameters(path: str) -> dict | None:
    """The run config a checkpoint directory was saved with, or None."""
    p = os.path.join(path, "parameters.pkl")
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return pickle.load(f)


def _backbone(state: dict) -> dict:
    return {n: t for n, t in state.items() if n.startswith("backbone.")}


def load_transfer_checkpoint(path: str):
    """A checkpoint directory read for transfer learning: (trainable,
    frozen or None), name -> CPU tensor maps.  The best-model snapshot is
    preferred when the checkpoint has one: a supervised run's (the whole
    trainable state) in place of the trainable tensors, an SSL run's (the
    feature branch's backbone alone) grafted over their backbone."""
    payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                         weights_only=False)
    trainable = dict(payload["trainable"])
    best = payload.get("best_trainable")
    if best:
        best_bb = _backbone(best)
        if best_bb and len(best_bb) < len(best):
            trainable = dict(best)          # a whole trainable snapshot
        elif best_bb and _backbone(trainable):
            trainable = {n: t for n, t in trainable.items()
                         if not n.startswith("backbone.")}
            trainable.update(best_bb)
    frozen = None
    fpath = os.path.join(path, "frozen.pt")
    if os.path.exists(fpath):
        frozen = torch.load(fpath, map_location="cpu")
    return trainable, frozen


def adopt_state(template: dict, loaded: dict, where: str = "checkpoint"):
    """`loaded`'s tensors for every name of `template`, with the
    reference's strictness (`apla_tpu/train/checkpoint.py:adopt_pytree`):
    a name of `template` missing from `loaded`, or a shape that differs,
    raises ValueError; names only `loaded` has are ignored (an SSL
    backbone's mask token when fine-tuning without one)."""
    missing = [n for n in template if n not in loaded]
    if missing:
        raise ValueError(f"transfer {where}: missing keys: {missing}")
    for n, t in template.items():
        if tuple(loaded[n].shape) != tuple(t.shape):
            raise ValueError(
                f"transfer {where}: leaf shape mismatch at {n}: "
                f"{tuple(loaded[n].shape)} vs {tuple(t.shape)}")
    return {n: loaded[n] for n in template}


@torch.no_grad()
def transfer_into(model: torch.nn.Module, path: str,
                  where: str = "wrapper") -> None:
    """Adopt the checkpoint at `path` into `model` in place.  The whole
    trainable state when its names all resolve (supervised -> supervised),
    else the backbone's alone (SSL <-> supervised); the same for the frozen
    state.  Every name is resolved before anything is written.  Prints the
    JAX package's line, with the scope ("full" or "backbone-only")."""
    t_ck, f_ck = load_transfer_checkpoint(path)
    trainable = {n: p for n, p in model.named_parameters()
                 if p.requires_grad}
    frozen = frozen_state(model)
    try:
        adopted = adopt_state(trainable, t_ck, where=f"{where}.trainable")
        scope = "full"
    except ValueError:
        if not _backbone(trainable) or not _backbone(t_ck):
            raise
        adopted = adopt_state(_backbone(trainable), _backbone(t_ck),
                              where=f"{where}.backbone")
        scope = "backbone-only"
    if f_ck is not None:
        try:
            adopted.update(adopt_state(frozen, f_ck,
                                       where=f"{where}.frozen"))
        except ValueError:
            if not _backbone(frozen) or not _backbone(f_ck):
                raise
            adopted.update(adopt_state(_backbone(frozen), _backbone(f_ck),
                                       where=f"{where}.frozen.backbone"))
    live = {**frozen, **trainable}
    for name, t in adopted.items():
        live[name].copy_(t)
    print(f"Transfer-loaded {scope} weights from {path}")
