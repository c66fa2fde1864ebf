"""Semantic-segmentation dataset (ADE20K directory layout), without PIL.

Counterpart of `apla_tpu/data/segmentation_data.py`: a reader for

    <root>/images/<split>/*.jpg
    <root>/annotations/<split>/<stem>.png   (per-pixel class ids)

emitting fixed-size (image [S, S, 3] float32 normalised, label [S, S] int32)
pairs, with mmseg's ADE20K `reduce_zero_label` (ids shift down by one; 0,
the unlabelled id, and a raw 255 become the ignore label 255).

Files are decoded by their content, as Pillow opens them
(`detection_data.read_image`: a JPEG or a PNG stream, whatever the file's
name), so a set that stores PNG-encoded images under ADE20K's `.jpg` names
reads the same here and in the JAX reader.  The image is
converted to RGB and resized as Pillow's BILINEAR does; the label map is
read as its stored samples (a palette PNG's indices, a grey PNG's levels,
an RGB PNG's first channel) and resized as Pillow's NEAREST does.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .detection_data import read_image, read_png, resize, resize_nearest


class ADE20KSegmentation:
    mean = (0.485, 0.456, 0.406)
    std = (0.229, 0.224, 0.225)
    ignore_index = 255
    n_classes = 150

    def __init__(self, root: str, split: str = "training",
                 img_size: int = 512, reduce_zero_label: bool = True):
        self.img_size = img_size
        self.reduce_zero_label = reduce_zero_label
        img_dir = os.path.join(root, "images", split)
        ann_dir = os.path.join(root, "annotations", split)
        self.samples = []
        for img_path in sorted(glob.glob(os.path.join(img_dir, "*.jpg"))):
            stem = os.path.splitext(os.path.basename(img_path))[0]
            ann_path = os.path.join(ann_dir, stem + ".png")
            if os.path.exists(ann_path):
                self.samples.append((img_path, ann_path))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx, rng=None):
        img_path, ann_path = self.samples[idx]
        s = self.img_size
        img = resize(read_image(img_path), s, s)
        label = resize_nearest(read_png(ann_path, raw=True)[..., 0], s, s)
        # float64 in between, as numpy promotes the JAX reader's float32
        # image against the tuples
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - self.mean) / self.std
        label = label.astype(np.int64)
        if self.reduce_zero_label:
            # 0 = unlabelled -> ignore; classes 1..150 -> 0..149; a raw 255
            # shifts to 254 and maps back to ignore too (mmseg)
            label = np.where(label == 0, 256, label) - 1
            label = np.where(label >= 254, self.ignore_index, label)
        return {"image": arr.astype(np.float32),
                "label": label.astype(np.int32)}


def segmentation_collate(samples, rng=None, batch_key=None):
    del rng, batch_key
    return {"image": np.stack([s["image"] for s in samples]),
            "label": np.stack([s["label"] for s in samples])}
