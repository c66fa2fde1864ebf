"""Datasets: the `BaseSet` contract and the hermetic `Synthetic` set.

Counterpart of `apla_tpu/data/datasets.py` (`BaseSet`, `Synthetic`), with no
PIL anywhere: the card's machine has none.  A dataset declares the
reference's metadata (`n_classes`, `task`, `is_multiclass`, `mean`/`std`,
`knn_nhood`, `target_metric`) and returns records {'image', 'label'}.

- `raw_mode` (set by the wrapper for `device_augment`): the image as uint8
  HWC at `raw_size`, for the on-device augmentation tail.
- Otherwise the mode's transforms run in numpy.  Only the ones the
  synthetic recipes use are ported: an identity-size Resize, HorizontalFlip,
  CenterCrop, Normalize.  Any other transform that is switched on raises
  when a record is read (ROADMAP queue A: PIL-free transforms and real
  datasets), and so does every dataset but `Synthetic`.
"""

from __future__ import annotations

import numpy as np

# The transform names `apla_tpu/data/transforms.py:build_transform` reads,
# in its order; the first four are ported.
_PORTED = ("Resize", "CenterCrop", "HorizontalFlip", "Normalize")
_ALL_TRANSFORMS = _PORTED + (
    "RandomCrop", "RandomResizedCrop", "VerticalFlip", "RandomRotation",
    "ColorJitter", "RandomGrayscale", "RandomGaussianBlur", "RandomAffine",
    "RandomPerspective", "RandomSolarize", "AugMix", "RandAugment",
    "AutoAugment", "TrivialAugment", "RandomErasing")
_ROADMAP_DATA = "ROADMAP queue A: PIL-free transforms and real datasets"


def _on(td: dict, name: str) -> bool:
    entry = td.get(name)
    return bool(entry) and (entry is True or bool(entry.get("apply")))


def _center_crop(arr, th: int, tw: int):
    """CenterCrop as the JAX package's (PIL) one: zero-pad an undersized
    image around its centre first, then take the centre."""
    h, w = arr.shape[:2]
    if h < th or w < tw:
        out = np.zeros((max(h, th), max(w, tw)) + arr.shape[2:], arr.dtype)
        top, left = (out.shape[0] - h) // 2, (out.shape[1] - w) // 2
        out[top:top + h, left:left + w] = arr
        arr, (h, w) = out, out.shape[:2]
    top, left = (h - th) // 2, (w - tw) // 2
    return arr[top:top + th, left:left + tw]


class BaseSet:
    is_multiclass = True
    task = "classification"
    knn_nhood = 200
    target_metric = "accuracy"
    mean = (0.485, 0.456, 0.406)
    std = (0.229, 0.224, 0.225)
    raw_mode = False
    raw_size = None

    def __init__(self, dataset_params, mode="train"):
        self.attr_from_dict(dataset_params)
        self.mode = mode
        self.data = self.get_data_as_list()

    def attr_from_dict(self, param_dict):
        self.name = self.__class__.__name__
        for key in param_dict:
            setattr(self, key, param_dict[key])

    def __len__(self):
        return len(self.data)

    def get_data_as_list(self):
        raise NotImplementedError

    def get_transform_defs(self) -> dict:
        if self.mode == "train":
            return self.train_transforms
        if self.mode in ("val", "eval"):
            return self.val_transforms
        return self.test_transforms

    def transform(self, arr, rng: np.random.Generator):
        """The mode's transforms on a uint8 HWC array, consuming `rng` as
        the JAX pipeline does -> float32 HWC."""
        td = self.get_transform_defs() or {}
        off_port = [n for n in _ALL_TRANSFORMS[len(_PORTED):] if _on(td, n)]
        if off_port:
            raise NotImplementedError(
                f"transforms {off_port} need the PIL-free transforms "
                f"({_ROADMAP_DATA})")
        if _on(td, "Resize"):
            size = (td["Resize"]["height"], td["Resize"]["width"])
            if arr.shape[:2] != tuple(size):
                raise NotImplementedError(
                    f"Resize {arr.shape[:2]} -> {size} needs the PIL-free "
                    f"transforms ({_ROADMAP_DATA})")
        if _on(td, "CenterCrop"):
            arr = _center_crop(arr, td["CenterCrop"]["height"],
                               td["CenterCrop"]["width"])
        if _on(td, "HorizontalFlip") \
                and rng.random() < td["HorizontalFlip"]["p"]:
            arr = arr[:, ::-1]
        out = np.asarray(arr, dtype=np.float32) / 255.0
        if td.get("Normalize"):
            out = (out - np.asarray(self.mean, np.float32)) \
                / np.asarray(self.std, np.float32)
        return out

    def __getitem__(self, idx, rng=None):
        """{'image': float32 HWC (uint8 HWC in raw_mode), 'label': int}."""
        if rng is None:
            rng = np.random.default_rng()
        record = self.data[idx]
        arr = record["img_arr"]
        if self.raw_mode:
            if self.raw_size and arr.shape[:2] != (self.raw_size,) * 2:
                raise NotImplementedError(
                    f"raw_size {self.raw_size} for {arr.shape[:2]} images "
                    f"needs the PIL-free transforms ({_ROADMAP_DATA})")
            return {"image": arr, "label": record["label"]}
        return {"image": self.transform(arr, rng), "label": record["label"]}


class Synthetic(BaseSet):
    """Deterministic fake images: class-dependent mean plus noise, the same
    records as `apla_tpu/data/datasets.py:Synthetic`."""

    n_classes = 10
    mean = (0.5, 0.5, 0.5)
    std = (0.25, 0.25, 0.25)

    def __init__(self, dataset_params, mode="train"):
        self.attr_from_dict(dataset_params)
        self.mode = mode
        self.n_classes = int(getattr(self, "synthetic_classes", 10))
        self.size = int(getattr(self, "synthetic_size",
                                512 if mode == "train" else 128))
        self.img_hw = int(getattr(self, "synthetic_img_size", 32))
        self.data = self.get_data_as_list()

    def get_data_as_list(self):
        rng = np.random.default_rng(0 if self.mode == "train" else 1)
        data = []
        for i in range(self.size):
            label = int(i % self.n_classes)
            base = np.full((self.img_hw, self.img_hw, 3),
                           40 + 15 * label, np.float32)
            noise = rng.normal(0, 25, base.shape)
            arr = np.clip(base + noise, 0, 255).astype(np.uint8)
            data.append({"img_arr": arr, "label": label})
        return data


def get_dataset_class(name: str):
    if name == "Synthetic":
        return Synthetic
    if name == "SyntheticMultiLabel":
        raise NotImplementedError(
            "multi-label datasets are not ported yet (ROADMAP queue A: "
            "multi-label metrics)")
    raise NotImplementedError(f"dataset {name!r} is not ported yet "
                              f"({_ROADMAP_DATA})")
