"""Weight bridges into the port.

`params_from_jax` turns the JAX package's `(trainable, frozen)` trees (nested
dicts of numpy arrays, block leaves stacked `[L, ...]`) into the port's
module state, split the same way: two flat `name -> tensor` maps whose names
are the port's parameter and buffer names.  Every parity test goes through
it, and `models.classifier.classifier_from_state` builds a module from it.
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


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
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
    is_classifier = "fc" in trainable or "backbone" in frozen
    prefix = "backbone." if is_classifier else ""
    states = []
    for tree in (trainable, frozen):
        flat = {}
        _flatten(tree, "", flat)
        states.append(_split_blocks(flat, prefix))
    return states[0], states[1]
