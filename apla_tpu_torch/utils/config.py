"""Param files: YAML/JSON loading, the recursive `__common__.yml` merge, and
dot-access dicts.

Counterpart of `apla_tpu/utils/config.py`, which the port cannot import on
the card's machine (no PyYAML there).  PyYAML is imported only when a YAML
file is read, so everything else here, and `DefaultWrapper` fed a plain
dict, works without it.
"""

from __future__ import annotations

import json
import os
from copy import deepcopy
from typing import Any


class EDict(dict):
    """Dict with attribute (dot) access, applied recursively: nested dicts
    become EDicts on construction and on assignment, lists of dicts too."""

    def __init__(self, d: dict | None = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, EDict):
            return EDict(value)
        if isinstance(value, (list, tuple)):
            converted = [EDict._convert(v) for v in value]
            return type(value)(converted) if isinstance(value, tuple) \
                else converted
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, EDict._convert(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return EDict({k: deepcopy(v, memo) for k, v in self.items()})


def load_param_file(path: str) -> dict:
    """A .yml/.yaml/.json param file as a dict."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        if path.endswith((".yml", ".yaml")):
            import yaml
            return yaml.safe_load(f)
    raise NotImplementedError(f"Unsupported param file type: {path}")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save_json(data: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=4)


def update_nested_values(base: dict, target: dict) -> dict:
    """Merge `target` into `base` in place: leaves of `target` override,
    missing subtrees are added whole.  Returns `base`."""
    for key, value in target.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            update_nested_values(base[key], value)
        else:
            base[key] = value
    return base


def load_merged_params(params_path: str) -> EDict:
    """`<dir>/__common__.yml` merged with the variant file at `params_path`
    (a variant under an `_others` directory looks one level up)."""
    parent = os.path.split(params_path)[0]
    up = ".." if "_others" in params_path else ""
    common_path = os.path.join(parent, up, "__common__.yml")
    parameters = load_param_file(common_path) \
        if os.path.isfile(common_path) else {}
    if os.path.abspath(params_path) != os.path.abspath(common_path):
        update_nested_values(parameters, load_param_file(params_path))
    return EDict(parameters)
