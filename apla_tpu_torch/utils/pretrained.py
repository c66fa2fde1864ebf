"""Weight bridges into the port.

`params_from_jax` turns the JAX package's `(trainable, frozen)` trees (nested
dicts and lists of numpy arrays, block leaves stacked `[L, ...]`) into the
port's module state, split the same way: two flat `name -> tensor` maps whose
names are the port's parameter and buffer names.  Every parity test goes
through it, and `models.classifier.classifier_from_state` builds a module
from it.  `dinov2_state_from_jax` carries a JAX DINOv2 train state across:
student trainable tree, teacher tree, frozen tree (with `mask_token`) and
both centers.
"""

from __future__ import annotations

import numpy as np
import torch

# Leaves of the APLA trainable block tree, placed under the block's attn.
_APLA_LEAVES = ("proj_wt", "proj_bt")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    dtype = np.int64 if a.dtype.kind in "iu" else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _flatten(tree, prefix: str, out: dict) -> None:
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            _flatten(val, name + ".", out)
        else:
            out[name] = val


def _split_blocks(flat: dict, prefix: str) -> dict:
    """Flat JAX names -> port names: `{prefix}blocks.<path>` leaves [L, ...]
    become `{prefix}blocks.{i}.<path>`; APLA leaves go under `attn.`."""
    out = {}
    for name, val in flat.items():
        head = f"{prefix}blocks."
        if not name.startswith(head):
            out[name] = _tensor(val)
            continue
        path = name[len(head):]
        if path in _APLA_LEAVES:
            path = "attn." + path
        for i, leaf in enumerate(np.asarray(val)):
            out[f"{head}{i}.{path}"] = _tensor(leaf)
    return out


def params_from_jax(trainable: dict, frozen: dict):
    """(trainable, frozen) JAX trees -> (trainable, frozen) port state.

    Accepts classifier trees (`{'backbone': ..., 'fc': ...}`, any of the
    APLA / linear-probe / full fine-tune partitions) and bare ViT trees
    (the `build_apla` output), whose names then carry no `backbone.`."""
    is_classifier = ("fc" in trainable or "backbone" in frozen
                     or "backbone" in trainable)
    prefix = "backbone." if is_classifier else ""
    states = []
    for tree in (trainable, frozen):
        flat = {}
        _flatten(tree, "", flat)
        states.append(_split_blocks(flat, prefix))
    return states[0], states[1]


def dinov2_state_from_jax(state, frozen: dict) -> dict:
    """A JAX `DINOv2TrainState` (numpy leaves) and its frozen tree -> the
    port's pieces: {'trainable', 'teacher', 'frozen'} name -> tensor maps
    (`DINOv2Model` names: `backbone.*`, `dino_head.mlp.{i}.*`,
    `dino_head.last_v`, `dino_head.last_g`, `backbone.mask_token`) and the
    'dino_center' / 'ibot_center' tensors [1, K]."""
    trainable, frozen_t = params_from_jax(dict(state.trainable), frozen)
    teacher, _ = params_from_jax(dict(state.teacher), {})
    return {"trainable": trainable, "teacher": teacher, "frozen": frozen_t,
            "dino_center": _tensor(state.dino_center),
            "ibot_center": _tensor(state.ibot_center)}
