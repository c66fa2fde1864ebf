"""Datasets: the `BaseSet` contract, the hermetic `Synthetic` set and every
classification dataset reader of the JAX package.

Counterpart of `apla_tpu/data/datasets.py`, with no PIL and no pandas
anywhere: the card's machine has neither.  A dataset declares the
reference's metadata (`n_classes`, `task`, `is_multiclass`, `mean`/`std`,
`knn_nhood`, `target_metric`) and returns records {'image', 'label'};
images are uint8 HWC arrays until the transforms (`data/transforms.py`)
turn them into float32.

- Each reader parses its dataset's layout under `data_location` as the
  JAX class does (the same records in the same order, the same seeded
  splits in the same `val_ids.json`): the VTAB-1k suite, the FGVC sets,
  the medical sets, CIFAR, ImageNet; CSV files through `data/csv.py`
  (pandas' readings: an all-digit column is int), `.mat` files through
  scipy, imported when read.
- Files are decoded by their content (`detection_data.read_image`: PNG,
  JPEG, BMP, GIF and TIFF through the port's own decoders) into Pillow's
  `convert("RGB")`, `"L"` ([H, W]) or `"RGBA"` for `img_channels` 3, 1
  or 4, a `.png` twin preferred as the JAX package prefers it; a file
  that cannot be decoded raises, naming it.
- `raw_mode` (set by the wrapper for `device_augment`): the image as uint8
  HWC at `raw_size`, for the on-device augmentation tail.  A JPEG that
  libjpeg's RGB output takes is decoded at the smallest DCT scale that
  covers `raw_size` and resized bilinearly (the JAX package's native fast
  path); anything else (CMYK, a PNG, an array record) is decoded at full
  size and resized as Pillow's BICUBIC (the JAX package's Pillow path), so
  the bits are the JAX package's either way.  At `img_channels` 1 and 4
  every file takes the full decode, resized in its mode (L per band; RGBA
  per band, not Pillow's premultiplied resample: no RGBA batch trains).
- Otherwise the mode's transforms run, with a Resize that every pipeline
  shares hoisted out and run once (`disentangle_resizes_from_transforms`).

`get_dataset_class` resolves every name the JAX one resolves.
"""

from __future__ import annotations

import glob
import os
import pickle
import random
from pathlib import Path

import numpy as np

from ..native import CmykJpeg, JpegError, decode_jpeg_resize
from ..utils.config import load_json, save_json
from .csv import read_csv
from .detection_data import read_image
from .transforms import Compose, Resize, build_transform, resize_bicubic


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
        """The record's image: its array as it is, or its file decoded by
        content (a `.png` twin first) as Pillow's `convert("RGB")` ([H, W,
        3]), `convert("L")` ([H, W]) or `convert("RGBA")` for
        `img_channels` 3, 1 or anything else, as the JAX package reads
        it."""
        if "img_arr" in record:
            return record["img_arr"]
        path = record["img_path"]
        if os.path.exists(_png_twin(path)):
            path = _png_twin(path)
        mode = {3: "RGB", 1: "L"}.get(self.img_channels, "RGBA")
        return read_image(path, mode)

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
        in raw_mode; the image / 255 when `transform` is None), 'label':
        int}."""
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
        elif self.transform is not None:
            image = [self.transform(img, rng)
                     for _ in range(self.num_augmentations)]
            image = image[0] if len(image) == 1 else image
        else:                       # no pipeline: the image in [0, 1]
            image = np.asarray(img, dtype=np.float32) / 255.0
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


class SyntheticMultiLabel(Synthetic):
    """Multi-label variant of `Synthetic`: record i carries labels i % C
    and (i + 1) % C as a float vector (the BCE and multi-label metrics
    path)."""

    is_multiclass = False
    target_metric = "mAP"

    def get_data_as_list(self):
        data = super().get_data_as_list()
        for rec in data:
            c = rec["label"]
            vec = np.zeros(self.n_classes, np.float32)
            vec[c] = 1.0
            vec[(c + 1) % self.n_classes] = 1.0
            rec["label"] = vec
        return data


# --------------------------------------------------------------------------- #
# VTAB-1k: PNG files named img_<i>-label_<n>.png under
# <data_location>/<location>/{train,val,test}
# --------------------------------------------------------------------------- #

_VTAB_LOCATIONS = {
    "VTAB_flowers": "VTAB_oxford_flowers102",
    "_VTAB_flowers": "VTAB_oxford_flowers102",
    "VTAB_pets": "VTAB_oxford_iiit_pet",
    "VTAB_pcam": "VTAB_patch_camelyon",
    "VTAB_clevr_count": "VTAB_clevr_count_all",
    "VTAB_clevr_dist": "VTAB_clevr_closest_object_distance",
    "VTAB_dsprites_loc": "VTAB_dsprites_label_x_position",
    "VTAB_dsprites_ori": "VTAB_dsprites_label_orientation",
    "VTAB_smallnorb_azimuth": "VTAB_smallnorb_label_azimuth",
    "VTAB_smallnorb_elevation": "VTAB_smallnorb_label_elevation",
    "VTAB_kitti_dist": "VTAB_kitti_closest_vehicle_distance",
    "VTAB_retinopathy": "VTAB_diabetic_retinopathy_detection",
    "VTAB_svhn": "VTAB_svhn_cropped",
}
# two corrupt files of the exports, left out as the JAX package leaves them
_VTAB_EXCLUDED = ("VTAB_oxford_iiit_pet/train/img_261-label_20.png",
                  "VTAB_sun397/train/img_442-label_85.png")


class VTABDataset(BaseSet):
    """One VTAB-1k task: `train_val` trains on train + val and tests on
    test; otherwise each mode reads its own folder.  The label is the
    number after `-label_` (read from the path's text before its first
    dot, as the JAX package reads it)."""

    def __init__(self, dataset_params, mode="train"):
        self.dataset_location = _VTAB_LOCATIONS.get(
            self.__class__.__name__, self.__class__.__name__)
        super().__init__(dataset_params, mode)

    def get_data_as_list(self):
        def pngs(split):
            return files_with_suffix(os.path.join(self.root_dir, split),
                                     ".png")
        if getattr(self, "train_val", False):
            files = (pngs("train") + pngs("val") if self.mode == "train"
                     else pngs("test"))
        else:
            files = pngs(self.mode)
        files = [f for f in files if not f.endswith(_VTAB_EXCLUDED)]
        return [{"img_path": f,
                 "label": int(f.split(".")[0].split("-label_")[1])}
                for f in files]


class VTAB_cifar100(VTABDataset):
    n_classes = 100


class VTAB_caltech101(VTABDataset):
    n_classes = 102


class VTAB_dtd(VTABDataset):
    n_classes = 47


class VTAB_flowers(VTABDataset):
    n_classes = 102


class VTAB_pets(VTABDataset):
    n_classes = 37


class VTAB_svhn(VTABDataset):
    n_classes = 10


class VTAB_sun397(VTABDataset):
    n_classes = 397


class VTAB_pcam(VTABDataset):
    n_classes = 2


class VTAB_eurosat(VTABDataset):
    n_classes = 10


class VTAB_resisc45(VTABDataset):
    n_classes = 45


class VTAB_retinopathy(VTABDataset):
    n_classes = 5


class VTAB_clevr_count(VTABDataset):
    n_classes = 8


class VTAB_clevr_dist(VTABDataset):
    n_classes = 6


class VTAB_dmlab(VTABDataset):
    n_classes = 6


class VTAB_kitti_dist(VTABDataset):
    n_classes = 4


class VTAB_dsprites_loc(VTABDataset):
    n_classes = 16


class VTAB_dsprites_ori(VTABDataset):
    n_classes = 16


class VTAB_smallnorb_azimuth(VTABDataset):
    n_classes = 18


class VTAB_smallnorb_elevation(VTABDataset):
    n_classes = 9


# --------------------------------------------------------------------------- #
# CSV and list-file datasets
# --------------------------------------------------------------------------- #

class _SimpleCsvSet(BaseSet):
    """<root>/{train,val,test}.csv with a file-name and a label column,
    the images under <root>/<images_subdir>/."""

    images_subdir = "images"
    filename_col = "filename"
    label_col = "label"

    def get_data_as_list(self):
        df = read_csv(os.path.join(self.root_dir, f"{self.mode}.csv"))
        return [{
            "img_path": os.path.join(self.root_dir, self.images_subdir,
                                     row[self.filename_col]),
            "label": int(row[self.label_col]),
        } for _, row in df.iterrows()]


class NABirds(BaseSet):
    """data_info.csv (image_id, imagepath, class_id) and the ids of each
    split in {train,val,test}_image_ids.txt; `train_val` trains on train +
    val and tests on test, mode "all" reads every row.  Labels are the
    indices of the class ids sorted as strings.  An all-digit image_id
    column reads as int and then matches none of the files' ids, as in
    the JAX package (pandas' reading)."""

    n_classes = 555
    mean = (0.492, 0.508, 0.464)
    std = (0.218, 0.217, 0.264)

    def get_data_as_list(self):
        df = read_csv(os.path.join(self.root_dir, "data_info.csv"))
        if self.mode == "all":
            sel = df
        else:
            train_val = getattr(self, "train_val", False)
            if train_val and self.mode == "train":
                names = ("train_image_ids.txt", "val_image_ids.txt")
            elif train_val:
                names = ("test_image_ids.txt",)
            else:
                names = ({"train": "train_image_ids.txt",
                          "val": "val_image_ids.txt"}.get(
                              self.mode, "test_image_ids.txt"),)
            ids = [i for fn in names for i in read_file_to_list(
                os.path.join(self.root_dir, fn))]
            sel = df[df["image_id"].isin(ids)]
        classes = sorted(df["class_id"].astype(str).unique())
        to_int = {c: i for i, c in enumerate(classes)}
        return [{
            "img_path": os.path.join(self.root_dir, "images",
                                     row["imagepath"]),
            "label": to_int[str(row["class_id"])],
        } for _, row in sel.iterrows()]


class DDSM(BaseSet):
    """{train,val,test}.csv with `filename` (relative to the root) and
    `label`."""

    n_classes = 2
    target_metric = "roc_auc"
    mean = (0.44, 0.44, 0.44)
    std = (0.25, 0.25, 0.25)

    def get_data_as_list(self):
        df = read_csv(os.path.join(self.root_dir, f"{self.mode}.csv"))
        return [{"img_path": os.path.join(self.root_dir, row["filename"]),
                 "label": int(row["label"])} for _, row in df.iterrows()]


class _CsvWithSeededSplit(BaseSet):
    """A ground-truth table split by `get_validation_ids` (`val_size` of it
    held out, persisted in <root>/val_ids.json); the held-out part's first
    half is val, the rest test; `train_val` trains on train + val."""

    val_size = 0.2

    def frame(self) -> dict:
        """{'img_path': [...], 'label': [...]}."""
        raise NotImplementedError

    def get_data_as_list(self):
        df = self.frame()
        train_ids, test_val_ids = self.get_validation_ids(
            total_size=len(df["img_path"]), val_size=self.val_size,
            json_path=os.path.join(self.root_dir, "val_ids.json"),
            dataset_name=self.name)
        half = len(test_val_ids) // 2
        val_ids, test_ids = test_val_ids[:half], test_val_ids[half:]
        if getattr(self, "train_val", False) and self.mode == "train":
            ids = train_ids + val_ids
        elif self.mode == "train":
            ids = train_ids
        elif self.mode in ("val", "eval"):
            ids = val_ids
        else:
            ids = test_ids
        return [{"img_path": df["img_path"][i], "label": int(df["label"][i])}
                for i in ids]


class ISIC2019(_CsvWithSeededSplit):
    """ISIC_2019_Training_GroundTruth.csv (image, then one-hot MEL, NV,
    BCC, AK, BKL, DF, VASC, SCC, UNK) and train/<image>.jpg; the label is
    the argmax of the one-hot floats (UNK, the 9th, is never set in the
    data: 8 classes)."""

    n_classes = 8
    target_metric = "recall"
    mean = (0.66776717, 0.52960888, 0.52434725)
    std = (0.22381877, 0.20363036, 0.21538623)
    val_size = 0.2

    def frame(self):
        df = read_csv(os.path.join(self.root_dir,
                                   "ISIC_2019_Training_GroundTruth.csv"))
        values = df.values
        labels = values[:, 1:].astype(float).argmax(axis=1).tolist()
        paths = [os.path.join(self.root_dir, "train", n + ".jpg")
                 for n in values[:, 0].tolist()]
        return {"img_path": paths, "label": labels}


class APTOS2019(_CsvWithSeededSplit):
    """train.csv (id_code, diagnosis) and train_images/<id_code>.png."""

    n_classes = 5
    target_metric = "quadratic_kappa"
    mean = (0.415, 0.221, 0.073)
    std = (0.275, 0.150, 0.081)
    val_size = 0.3

    def frame(self):
        df = read_csv(os.path.join(self.root_dir, "train.csv"))
        paths = [os.path.join(self.root_dir, "train_images", n + ".png")
                 for n in df["id_code"].tolist()]
        return {"img_path": paths, "label": df["diagnosis"].tolist()}


class Flowers102(_SimpleCsvSet):
    """{train,val,test}.csv (or all_labels.csv for any other mode), labels
    from 1 in the files, from 0 here."""

    n_classes = 102
    target_metric = "mean_per_class_accuracy"
    mean = (0.435, 0.38, 0.292)
    std = (0.293, 0.243, 0.27)

    def get_data_as_list(self):
        csv_file = {"train": "train.csv", "val": "val.csv",
                    "test": "test.csv"}.get(self.mode, "all_labels.csv")
        df = read_csv(os.path.join(self.root_dir, csv_file))
        return [{
            "img_path": os.path.join(self.root_dir, "images",
                                     row["filename"]),
            "label": int(row["label"]) - 1,
        } for _, row in df.iterrows()]


class SUN397(BaseSet):
    """Partitions/{Training,Testing}_01.txt and val_imagefiles.txt (val
    carved out of training); labels from the sorted class folders."""

    n_classes = 397
    mean = (0.473, 0.456, 0.42)
    std = (0.258, 0.256, 0.279)

    def get_data_as_list(self):
        train_val = read_file_to_list(
            os.path.join(self.root_dir, "Partitions", "Training_01.txt"))
        test = read_file_to_list(
            os.path.join(self.root_dir, "Partitions", "Testing_01.txt"))
        val = set(read_file_to_list(
            os.path.join(self.root_dir, "val_imagefiles.txt")))
        if self.mode == "train":
            files = [f for f in train_val if f not in val]
        elif self.mode in ("val", "eval"):
            files = sorted(val)
        else:
            files = test
        classes = sorted({"/".join(f.split("/")[:-1])
                          for f in train_val + test})
        to_int = {c: i for i, c in enumerate(classes)}
        return [{"img_path": os.path.join(self.root_dir, "SUN397",
                                          f.lstrip("/")),
                 "label": to_int["/".join(f.split("/")[:-1])]}
                for f in files]


class CIFAR_10(BaseSet):
    """The python pickle batches; a seeded 10% of the training batches is
    val (persisted in <root>/val_ids.json); records hold the arrays."""

    n_classes = 10
    mean = (0.493, 0.484, 0.448)
    std = (0.241, 0.237, 0.256)
    batch_dir = "cifar-10-batches-py"
    train_batches = [f"data_batch_{i}" for i in range(1, 6)]
    test_batches = ["test_batch"]
    label_key = b"labels"

    def _load_batches(self, names):
        images, labels = [], []
        for name in names:
            with open(os.path.join(self.root_dir, self.batch_dir, name),
                      "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1))
            labels += list(d[self.label_key])
        return np.concatenate(images), labels

    def get_data_as_list(self):
        if self.mode in ("train", "val", "eval"):
            images, labels = self._load_batches(self.train_batches)
            train_ids, val_ids = self.get_validation_ids(
                total_size=len(labels), val_size=0.1,
                json_path=os.path.join(self.root_dir, "val_ids.json"),
                dataset_name=self.name)
            ids = train_ids if self.mode == "train" else val_ids
            if getattr(self, "train_val", False) and self.mode == "train":
                ids = train_ids + val_ids
        else:
            images, labels = self._load_batches(self.test_batches)
            ids = range(len(labels))
        return [{"img_arr": images[i], "label": int(labels[i])} for i in ids]


class CIFAR_100(CIFAR_10):
    n_classes = 100
    mean = (0.508, 0.487, 0.441)
    std = (0.263, 0.252, 0.272)
    batch_dir = "cifar-100-python"
    train_batches = ["train"]
    test_batches = ["test"]
    label_key = b"fine_labels"


class Colorectal(_SimpleCsvSet):
    n_classes = 8
    mean = (0.654, 0.475, 0.586)
    std = (0.252, 0.325, 0.266)


class AID(BaseSet):
    """images/<class>/*.jpg, the split's file names in {train,val,test}.csv
    (all_labels.csv for any other mode); labels from the sorted class
    folders."""

    n_classes = 30
    mean = (0.401, 0.413, 0.372)
    std = (0.21, 0.187, 0.185)

    def get_data_as_list(self):
        csv_file = {"train": "train.csv", "val": "val.csv",
                    "test": "test.csv"}.get(self.mode, "all_labels.csv")
        df = read_csv(os.path.join(self.root_dir, csv_file))
        all_files = files_with_suffix(
            os.path.join(self.root_dir, "images"), ".jpg")
        wanted = set(df["filename"].tolist())
        files = [f for f in all_files if os.path.split(f)[-1] in wanted]
        classes = sorted({Path(f).parent.name for f in all_files})
        to_int = {c: i for i, c in enumerate(classes)}
        return [{"img_path": f, "label": to_int[Path(f).parent.name]}
                for f in files]


class RSSCN7(AID):
    n_classes = 7
    target_metric = "mean_per_class_accuracy"
    mean = (0.402, 0.409, 0.38)
    std = (0.2, 0.18, 0.183)


class Aircraft(BaseSet):
    """FGVC-Aircraft: data/images_variant_{train,val,test}.txt (`all` for
    any other mode), lines `<7-digit id> <variant>`; labels from the sorted
    variants of the file read."""

    n_classes = 100
    target_metric = "mean_per_class_accuracy"
    mean = (0.478, 0.509, 0.533)
    std = (0.217, 0.21, 0.242)

    def get_data_as_list(self):
        textfile = {"train": "images_variant_train.txt",
                    "val": "images_variant_val.txt",
                    "test": "images_variant_test.txt"}.get(
                        self.mode, "images_variant_all.txt")
        lines = read_file_to_list(os.path.join(self.root_dir, "data",
                                               textfile))
        variants = sorted({line[8:] for line in lines})
        to_int = {v: i for i, v in enumerate(variants)}
        return [{
            "img_path": os.path.join(self.root_dir, "data", "images",
                                     f"{line[:7]}.jpg"),
            "label": to_int[line[8:]],
        } for line in lines]


class StanfordCars(BaseSet):
    """The devkit layout, stanford_cars/{devkit/cars_train_annos.mat,
    cars_test_annos_withlabels.mat, cars_train/, cars_test/}, read with
    scipy.io (imported when read), classes from 1 in the files; val is the
    training files listed in val_imgfiles.txt; `train_val` trains on all
    of train and tests on test."""

    n_classes = 196
    mean = (0.469, 0.459, 0.454)
    std = (0.29, 0.289, 0.297)

    def _mat_samples(self, split):
        from scipy.io import loadmat
        base = os.path.join(self.root_dir, "stanford_cars")
        if split == "train":
            mat = os.path.join(base, "devkit", "cars_train_annos.mat")
            img_dir = os.path.join(base, "cars_train")
        else:
            mat = os.path.join(base, "cars_test_annos_withlabels.mat")
            img_dir = os.path.join(base, "cars_test")
        annos = loadmat(mat, squeeze_me=True)["annotations"]
        return [(os.path.join(img_dir, str(a["fname"])),
                 int(a["class"]) - 1) for a in np.atleast_1d(annos)]

    def get_data_as_list(self):
        train_samples = self._mat_samples("train")
        test_samples = self._mat_samples("test")
        val_files = {os.path.join(self.root_dir, p) for p in
                     read_file_to_list(os.path.join(self.root_dir,
                                                    "val_imgfiles.txt"))}
        if getattr(self, "train_val", False):
            selected = (train_samples if self.mode == "train"
                        else test_samples)
        elif self.mode == "train":
            selected = [s for s in train_samples if s[0] not in val_files]
        elif self.mode in ("val", "eval"):
            selected = [s for s in train_samples if s[0] in val_files]
        elif self.mode == "test":
            selected = test_samples
        else:  # 'all'
            selected = train_samples + test_samples
        return [{"img_path": p, "label": t} for p, t in selected]


class DTD(BaseSet):
    """dtd/dtd/{labels/{train,val,test}1.txt, images/<class>/<file>}: the
    split files list `class/file.jpg`; labels from the sorted classes of
    the splits read (mode "all": all three)."""

    n_classes = 47
    mean = (0.531, 0.474, 0.425)
    std = (0.265, 0.255, 0.263)
    partition = 1

    def _split_entries(self, split):
        data_dir = os.path.join(self.root_dir, "dtd", "dtd")
        lines = read_file_to_list(os.path.join(
            data_dir, "labels", f"{split}{self.partition}.txt"))
        return [(os.path.join(data_dir, "images", ln.strip()),
                 ln.strip().split("/")[0]) for ln in lines if ln.strip()]

    def get_data_as_list(self):
        splits = (("train", "val", "test") if self.mode == "all"
                  else ({"train": ("train",), "val": ("val",),
                         "eval": ("val",), "test": ("test",)}[self.mode]))
        entries = [e for s in splits for e in self._split_entries(s)]
        classes = sorted({c for _, c in entries})
        to_int = {c: i for i, c in enumerate(classes)}
        return [{"img_path": p, "label": to_int[c]} for p, c in entries]


class StanfordDogs(_SimpleCsvSet):
    n_classes = 120
    mean = (0.476, 0.452, 0.391)
    std = (0.259, 0.253, 0.258)


class OxfordIII_Pet(BaseSet):
    """oxford-iiit-pet/{images/<id>.jpg, annotations/{trainval,test}.txt}
    (lines `id label ...`, labels from 1 in the files); val is the
    trainval files listed in val_imgfiles.txt."""

    n_classes = 37
    target_metric = "mean_per_class_accuracy"
    mean = (0.482, 0.449, 0.395)
    std = (0.265, 0.26, 0.268)

    def _split_samples(self, split):
        base = os.path.join(self.root_dir, "oxford-iiit-pet")
        samples = []
        for ln in read_file_to_list(
                os.path.join(base, "annotations", f"{split}.txt")):
            if not ln.strip() or ln.startswith("#"):
                continue
            image_id, label = ln.split()[:2]
            samples.append((os.path.join(base, "images", image_id + ".jpg"),
                            int(label) - 1))
        return samples

    def get_data_as_list(self):
        trainval = self._split_samples("trainval")
        test = self._split_samples("test")
        val_files = {os.path.join(self.root_dir, p) for p in
                     read_file_to_list(os.path.join(self.root_dir,
                                                    "val_imgfiles.txt"))}
        if self.mode == "train":
            selected = [s for s in trainval if s[0] not in val_files]
        elif self.mode in ("val", "eval"):
            selected = [s for s in trainval if s[0] in val_files]
        elif self.mode == "test":
            selected = test
        else:  # 'all'
            selected = trainval + test
        return [{"img_path": p, "label": t} for p, t in selected]


class CUB_200_2011(_SimpleCsvSet):
    n_classes = 200
    mean = (0.486, 0.5, 0.43)
    std = (0.228, 0.223, 0.262)
    filename_col = "img_name"


class Birdsnap(_SimpleCsvSet):
    n_classes = 500
    mean = (0.488, 0.502, 0.456)
    std = (0.224, 0.221, 0.262)


class Caltech_101(BaseSet):
    """<images_dirname>/<class>/*.{jpg,png} without BACKGROUND_Google,
    split by `get_validation_ids` (0.4 held out, persisted in
    <root>/val_ids.json; its first half val, the rest test)."""

    n_classes = 101
    target_metric = "mean_per_class_accuracy"
    mean = (0.547, 0.526, 0.495)
    std = (0.32, 0.316, 0.327)
    images_dirname = "101_ObjectCategories"

    def get_data_as_list(self):
        img_dir = os.path.join(self.root_dir, self.images_dirname)
        files = (files_with_suffix(img_dir, ".jpg")
                 + files_with_suffix(img_dir, ".png"))
        classes = [c for c in sorted({Path(f).parent.name for f in files})
                   if c != "BACKGROUND_Google"]
        to_int = {c: i for i, c in enumerate(classes)}
        files = [f for f in files if Path(f).parent.name in to_int]
        train_ids, test_val_ids = self.get_validation_ids(
            total_size=len(files), val_size=0.4,
            json_path=os.path.join(self.root_dir, "val_ids.json"),
            dataset_name=self.name)
        half = len(test_val_ids) // 2
        ids = {"train": train_ids, "val": test_val_ids[:half],
               "eval": test_val_ids[:half]}.get(self.mode,
                                                test_val_ids[half:])
        return [{"img_path": files[i],
                 "label": to_int[Path(files[i]).parent.name]} for i in ids]


class Caltech_256(Caltech_101):
    n_classes = 257
    images_dirname = "256_ObjectCategories"


class MIT_Indoor(_SimpleCsvSet):
    n_classes = 67
    target_metric = "mean_per_class_accuracy"
    mean = (0.487, 0.43, 0.372)
    std = (0.263, 0.257, 0.259)
    images_subdir = os.path.join("indoorCVPR_09", "Images")


class Pneumonia(_SimpleCsvSet):
    n_classes = 2
    target_metric = "roc_auc"
    mean = (0.482, 0.482, 0.482)
    std = (0.236, 0.236, 0.236)


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


def compute_stats(loader):
    """Per-channel mean and std over a loader's images ([B, H, W, C]
    batches, arrays or tensors), each batch's mean weighted alike, in
    float64: for a new dataset's `mean` / `std`."""
    x_tot = x2_tot = None
    n = 0
    for batch in loader:
        imgs = np.asarray(batch["image"]).astype(np.float64)
        if x_tot is None:
            x_tot = np.zeros(imgs.shape[-1])
            x2_tot = np.zeros(imgs.shape[-1])
        x_tot += imgs.mean(axis=(0, 1, 2))
        x2_tot += (imgs ** 2).mean(axis=(0, 1, 2))
        n += 1
    mean = x_tot / n
    std = np.sqrt(x2_tot / n - mean ** 2)
    return mean, std


def get_dataset_class(name: str):
    """The `BaseSet` class of this module called `name` (as the JAX
    package's lookup); an unknown name raises KeyError."""
    cls = globals().get(name)
    if cls is None or not (isinstance(cls, type) and issubclass(cls, BaseSet)):
        raise KeyError(f"Unknown dataset: {name}")
    return cls
