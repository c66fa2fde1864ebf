"""SSL augmentation strategies: the declarative multi-crop recipes.

A copy of `apla_tpu/ssl/multicrop.py` (pure Python; the port imports nothing
of the JAX package): the reference's `augmentation_strategy.json` next to
each SSL wrapper, applied by `update_augmentation_strategy`, turns the train
transforms into a LIST of per-crop pipelines inheriting Resize/Normalize
from the dataset config.
"""

from __future__ import annotations

import os
from copy import deepcopy

from ..utils.config import EDict, load_json


def _global_crop(size=224, scale=(0.4, 1.0), blur_p=1.0, solarize=False):
    d = {
        "RandomResizedCrop": {"apply": True, "size": size,
                              "scale": list(scale)},
        "HorizontalFlip": {"apply": True, "p": 0.5},
        "ColorJitter": {"apply": True, "brightness": 0.4, "contrast": 0.4,
                        "saturation": 0.2, "hue": 0.1, "p": 0.8},
        "RandomGrayscale": {"apply": True, "p": 0.2},
        "RandomGaussianBlur": {"apply": True, "radius_min": 0.1,
                               "radius_max": 2.0, "p": blur_p},
    }
    if solarize:
        d["RandomSolarize"] = {"apply": True, "threshold": 128, "p": 0.2}
    return d


def _local_crop(size=96, scale=(0.05, 0.4)):
    d = _global_crop(size=size, scale=scale, blur_p=0.5)
    return d


# crop counts/sizes: BYOL 2x224 global; DINO 2 global + 8 local 96
# (DINO/augmentation_strategy.json); DINOv2 2 global 224 + 8 local 98
# (dinov2/augmentation_strategy.json:7-10)
STRATEGIES = {
    "byol": {
        "inherit": ["Resize", "Normalize"],
        "crops": [("global", _global_crop(blur_p=1.0)),
                  ("global", _global_crop(blur_p=0.1, solarize=True))],
        "n_global": 2, "n_local": 0,
        "global_size": 224, "local_size": None,
    },
    "dino": {
        "inherit": ["Resize", "Normalize"],
        "crops": ([("global", _global_crop(blur_p=1.0)),
                   ("global", _global_crop(blur_p=0.1, solarize=True))]
                  + [("local", _local_crop(96))] * 8),
        "n_global": 2, "n_local": 8,
        "global_size": 224, "local_size": 96,
    },
    "dinov2": {
        "inherit": ["Resize", "Normalize"],
        "crops": ([("global", _global_crop(224, (0.32, 1.0), blur_p=1.0)),
                   ("global", _global_crop(224, (0.32, 1.0), blur_p=0.1,
                                           solarize=True))]
                  + [("local", _local_crop(98, (0.05, 0.32)))] * 8),
        "n_global": 2, "n_local": 8,
        "global_size": 224, "local_size": 98,
    },
}


def apply_strategy_json(parameters: EDict, strategy: dict) -> EDict:
    """Apply a reference-format `augmentation_strategy.json` dict
    (reference wrappers.py:343-379): for every `transforms` key present in
    dataset_params, rebuild it as a per-crop list following
    `repetition_strategy.order` x `n_augmentations`, inheriting the
    `general_args.inherit` keys (Resize/Normalize) from the original def."""
    general = strategy.get("general_args", {})
    if not general.get("overwrite_defaults", False):
        return parameters
    rep = strategy["repetition_strategy"]
    transforms = strategy["transforms"]
    params = EDict(deepcopy(dict(parameters)))
    for key in parameters.dataset_params.keys():
        if key not in transforms:
            continue
        org_def = parameters.dataset_params[key]
        updated = []
        for order, aug_type in enumerate(rep["order"]):
            new_trans = deepcopy(dict(transforms[key][aug_type]))
            for k in general.get("inherit", []):
                if k in org_def:
                    new_trans[k] = deepcopy(org_def[k])
            updated.extend(deepcopy(new_trans)
                           for _ in range(int(rep["n_augmentations"][order])))
        params.dataset_params[key] = updated
    return params


def _find_strategy_file(parameters: EDict, strategy: str):
    """External strategy file, load-if-present: an explicit
    `dataset_params.augmentation_strategy_path`, else a JSON colocated with
    this package (`augmentation_strategy_<name>.json` or
    `augmentation_strategy.json`) — mirroring the reference's file colocated
    with each SSL wrapper (wrappers.py:347-352)."""
    explicit = parameters.dataset_params.get("augmentation_strategy_path")
    if explicit:
        if not os.path.isfile(explicit):
            raise FileNotFoundError(
                f"augmentation_strategy_path: {explicit}")
        return explicit
    here = os.path.dirname(os.path.abspath(__file__))
    for name in (f"augmentation_strategy_{strategy}.json",
                 "augmentation_strategy.json"):
        path = os.path.join(here, name)
        if os.path.isfile(path):
            return path
    return None


def apply_augmentation_strategy(parameters: EDict, strategy: str) -> EDict:
    """Replace `dataset_params.train_transforms` with the strategy's per-crop
    transform list (reference update_augmentation_strategy semantics).

    A user-supplied strategy file wins over the builtin dict."""
    path = _find_strategy_file(parameters, strategy)
    if path:
        print(f"Using aug strategy file: {path}")
        return apply_strategy_json(parameters, load_json(path))
    spec = STRATEGIES[strategy]
    params = EDict(deepcopy(dict(parameters)))
    base = params.dataset_params.get("train_transforms", EDict())
    # optional crop-size overrides (small-image datasets / tests)
    g_size = params.dataset_params.get("ssl_global_size")
    l_size = params.dataset_params.get("ssl_local_size")
    crop_list = []
    for kind, crop in spec["crops"]:
        t = deepcopy(crop)
        if kind == "global" and g_size:
            t["RandomResizedCrop"]["size"] = int(g_size)
        if kind == "local" and l_size:
            t["RandomResizedCrop"]["size"] = int(l_size)
        for key in spec["inherit"]:
            if key in base:
                t[key] = deepcopy(base[key])
        crop_list.append(t)
    params.dataset_params.train_transforms = crop_list
    return params


def spec_from_strategy_json(strategy: dict) -> dict:
    """Build a STRATEGIES-shaped spec from a reference-format
    `augmentation_strategy.json` — crop counts/sizes derive from
    `repetition_strategy` exactly as the reference wrapper does
    (dinov2/wrappers.py:36-49 set_crops_params): order names starting
    with 'local' are local crops, everything else is global."""
    rep = strategy["repetition_strategy"]
    tr = strategy.get("transforms", {}).get("train_transforms", {})
    crops = []
    n_global = n_local = 0
    g_size = l_size = None
    for order, aug_type in enumerate(rep["order"]):
        kind = "local" if str(aug_type).startswith("local") else "global"
        if kind == "global" and n_local:
            # every consumer (collate s['image'][:n_global], device crop
            # list, _stack_views) is crop-major with globals FIRST — a
            # locals-before-globals file would silently swap geometries
            raise ValueError(
                "augmentation strategy order must list all global crops "
                f"before local crops; got {rep['order']}")
        t = dict(tr.get(aug_type, {}))
        size = t.get("RandomResizedCrop", {}).get("size")
        n = int(rep["n_augmentations"][order])
        crops.extend((kind, t) for _ in range(n))
        if kind == "local":
            n_local += n
            l_size = size if size is not None else l_size
        else:
            n_global += n
            g_size = size if size is not None else g_size
    return {
        "inherit": strategy.get("general_args", {}).get("inherit", []),
        "crops": crops, "n_global": n_global, "n_local": n_local,
        "global_size": g_size or 224, "local_size": l_size,
    }


def resolve_strategy_spec(parameters: EDict, strategy: str) -> dict:
    """The crop-geometry spec in effect: from the user's strategy file when
    one is configured AND active (general_args.overwrite_defaults — the
    same gate apply_strategy_json honors; an inactive file must not drive
    crop counts while the transform pipeline ignores it), otherwise the
    builtin STRATEGIES entry."""
    path = _find_strategy_file(parameters, strategy)
    if path:
        loaded = load_json(path)
        if loaded.get("general_args", {}).get("overwrite_defaults", False):
            return spec_from_strategy_json(loaded)
    return STRATEGIES[strategy]
