"""Datasets: the `BaseSet` contract, the hermetic `Synthetic` set and the
ImageNet reader.

Counterpart of `apla_tpu/data/datasets.py` (`BaseSet`, `Synthetic`,
`ImageNet`), with no PIL anywhere: the card's machine has none.  A dataset
declares the reference's metadata (`n_classes`, `task`, `is_multiclass`,
`mean`/`std`, `knn_nhood`, `target_metric`) and returns records {'image',
'label'}; images are uint8 HWC arrays until the transforms
(`data/transforms.py`) turn them into float32.

- Files are decoded by their content (`detection_data.read_image`: JPEG
  through the port's own decoder, PNG), a `.png` twin preferred as the JAX
  package prefers it; a file that cannot be decoded raises, naming it.
- `raw_mode` (set by the wrapper for `device_augment`): the image as uint8
  HWC at `raw_size`, for the on-device augmentation tail.  A JPEG that
  libjpeg's RGB output takes is decoded at the smallest DCT scale that
  covers `raw_size` and resized bilinearly (the JAX package's native fast
  path); anything else (CMYK, a PNG under a JPEG name, an array record) is
  decoded at full size and resized as Pillow's BICUBIC (the JAX package's
  Pillow path), so the bits are the JAX package's either way.
- Otherwise the mode's transforms run, with a Resize that every pipeline
  shares hoisted out and run once (`disentangle_resizes_from_transforms`).

Of the JAX package's 43 dataset classes, `Synthetic` and `ImageNet` are
here; the others raise when asked for (ROADMAP A 5, multi-label: A 6).
"""

from __future__ import annotations

import glob
import os
import random
from pathlib import Path

import numpy as np

from ..native import CmykJpeg, JpegError, decode_jpeg_resize
from ..utils.config import load_json, save_json
from .detection_data import read_image
from .transforms import ROADMAP_DATA, Compose, Resize, build_transform, \
    resize_bicubic


def files_with_suffix(directory, suffix):
    """Recursive glob, sorted absolute paths."""
    return sorted(
        os.path.abspath(p) for p in
        glob.glob(os.path.join(directory, "**", f"*{suffix}"), recursive=True))


def read_file_to_list(filepath):
    with open(filepath) as f:
        return f.read().splitlines()


def _png_twin(path: str) -> str:
    return ".".join(path.split(".")[:-1]) + ".png"


class BaseSet:
    img_channels = 3
    is_multiclass = True
    task = "classification"
    knn_nhood = 200
    target_metric = "accuracy"
    mean = (0.485, 0.456, 0.406)
    std = (0.229, 0.224, 0.225)
    num_augmentations = 1
    raw_mode = False
    raw_size = None

    def __init__(self, dataset_params, mode="train"):
        self.attr_from_dict(dataset_params)
        self.mode = mode
        self.dataset_location = getattr(self, "dataset_location",
                                        self.__class__.__name__)
        self.root_dir = os.path.join(self.data_location, self.dataset_location)
        self.data = self.get_data_as_list()
        self.transform, self.resizing = self.get_transforms()

    def attr_from_dict(self, param_dict):
        self.name = self.__class__.__name__
        for key in param_dict:
            setattr(self, key, param_dict[key])

    def __len__(self):
        return len(self.data)

    def get_data_as_list(self):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    def load_image(self, record) -> np.ndarray:
        """The record's image as uint8 RGB HWC (its array, or its file
        decoded by content, a `.png` twin first)."""
        if "img_arr" in record:
            return record["img_arr"]
        if self.img_channels != 3:
            raise NotImplementedError(
                f"img_channels={self.img_channels}: only RGB images are "
                f"read ({ROADMAP_DATA})")
        path = record["img_path"]
        if os.path.exists(_png_twin(path)):
            path = _png_twin(path)
        return read_image(path)

    def load_raw(self, record) -> np.ndarray:
        """raw_mode: the image at [raw_size, raw_size] uint8 (at its stored
        size without a raw_size)."""
        path = record.get("img_path")
        size = int(self.raw_size) if self.raw_size else None
        if (path and size and self.img_channels == 3
                and path.lower().endswith((".jpg", ".jpeg"))
                and not os.path.exists(_png_twin(path))):
            with open(path, "rb") as f:
                data = f.read()
            if data[:2] == b"\xff\xd8":     # else decoded by its content
                try:
                    return decode_jpeg_resize(data, size, size)
                except CmykJpeg:
                    pass    # the full decode + BICUBIC, as Pillow's in JAX
                except JpegError as e:
                    raise ValueError(f"{path}: JPEG stream not decoded: "
                                     f"{e}") from None
        img = self.load_image(record)
        if size and img.shape[:2] != (size, size):
            img = resize_bicubic(img, size, size)
        return img

    def __getitem__(self, idx, rng=None):
        """{'image': float32 HWC (a list for multi-crop pipelines; uint8 HWC
        in raw_mode), 'label': int}."""
        if rng is None:
            rng = np.random.default_rng()
        record = self.data[idx]
        if self.raw_mode:
            return {"image": self.load_raw(record), "label": record["label"]}
        img = self.load_image(record)
        if self.resizing is not None:
            img = self.resizing(img, rng)
        if isinstance(self.transform, list):
            image = [tr(img, rng) for tr in self.transform]
        else:
            image = [self.transform(img, rng)
                     for _ in range(self.num_augmentations)]
            image = image[0] if len(image) == 1 else image
        return {"image": image, "label": record["label"]}

    # ------------------------------------------------------------------ #
    def get_transform_defs(self):
        if self.mode == "train":
            return self.train_transforms
        if self.mode in ("val", "eval"):
            return self.val_transforms
        return self.test_transforms

    def get_transforms(self):
        applied = self.get_transform_defs()
        if isinstance(applied, list):  # SSL: one pipeline per crop
            transforms = [build_transform(t, self.mean, self.std)
                          for t in applied]
        else:
            transforms = build_transform(applied, self.mean, self.std)
        return self.disentangle_resizes_from_transforms(transforms)

    @staticmethod
    def disentangle_resizes_from_transforms(transforms):
        """Hoist a shared Resize out of the pipelines, so it runs once per
        image: -> (pipelines without it, the Resize or None)."""
        if isinstance(transforms, Compose):
            resizes = [t for t in transforms.transforms
                       if isinstance(t, Resize)]
            rest = [t for t in transforms.transforms
                    if not isinstance(t, Resize)]
            return Compose(rest), (resizes[0] if resizes else None)
        if isinstance(transforms, list):
            all_resizes = []
            for tr in transforms:
                r = [t for t in tr.transforms if isinstance(t, Resize)]
                if not r:
                    return transforms, None
                all_resizes.append(r[0])
            sizes = {str(r.size) for r in all_resizes}
            if len(sizes) == 1 and len(all_resizes) > 1:
                stripped = [Compose([t for t in tr.transforms
                                     if not isinstance(t, Resize)])
                            for tr in transforms]
                return stripped, all_resizes[0]
            return transforms, None
        raise TypeError(type(transforms))

    @staticmethod
    def get_validation_ids(total_size, val_size, json_path, dataset_name,
                           seed_n=42, overwrite=False):
        """A seeded train/val split of range(total_size), persisted at
        `json_path` and made anew when the stored one has other sizes."""
        idxs = list(range(total_size))
        if val_size < 1:
            val_size = int(total_size * val_size)
        train_size = total_size - val_size
        if not os.path.isfile(json_path) or overwrite:
            random.Random(seed_n).shuffle(idxs)
            train_split = idxs[val_size:]
            val_split = idxs[:val_size]
            save_json({"train_split": train_split, "val_split": val_split},
                      json_path)
        else:
            s = load_json(json_path)
            if isinstance(s, dict):
                val_split, train_split = s["val_split"], s["train_split"]
            else:
                val_split = s
                train_split = sorted(set(range(total_size)) - set(val_split))
            if val_size != len(val_split) or train_size != len(train_split):
                return BaseSet.get_validation_ids(
                    total_size, val_size, json_path, dataset_name,
                    seed_n=seed_n, overwrite=True)
        return train_split, val_split


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
        self.transform, self.resizing = self.get_transforms()

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


class ImageNet(BaseSet):
    """The ILSVRC folder layout: <data_location>/ImageNet/{train,val}/
    <wnid>/*.JPEG (or .jpg); labels are the sorted class folders' indices.
    Val and test both read `val`."""

    n_classes = 1000
    mean = (0.485, 0.456, 0.406)
    std = (0.229, 0.224, 0.225)

    def get_data_as_list(self):
        split = "train" if self.mode == "train" else "val"
        split_dir = os.path.join(self.root_dir, split)
        files = (files_with_suffix(split_dir, ".JPEG")
                 + files_with_suffix(split_dir, ".jpg"))
        classes = sorted({Path(f).parent.name for f in files})
        to_int = {c: i for i, c in enumerate(classes)}
        return [{"img_path": f, "label": to_int[Path(f).parent.name]}
                for f in files]


DATASETS = {"Synthetic": Synthetic, "ImageNet": ImageNet}


def get_dataset_class(name: str):
    if name in DATASETS:
        return DATASETS[name]
    if name == "SyntheticMultiLabel":
        raise NotImplementedError(
            "multi-label datasets are not ported yet (ROADMAP A 6: "
            "multi-label metrics)")
    raise NotImplementedError(f"dataset {name!r} is not ported yet "
                              f"({ROADMAP_DATA})")
