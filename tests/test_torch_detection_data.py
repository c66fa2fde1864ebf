"""The port's PIL-free COCO detection dataset against the JAX package's.

`apla_tpu_torch.data.detection_data.CocoDetection` decodes PNGs with zlib
and numpy and resizes them as Pillow's `Image.resize(BILINEAR)` does; the
JAX package's reader uses Pillow itself.  On PNGs of several sizes and
colour types (written here with Pillow, which picks its scanline filters
adaptively), boxes and labels must be identical and pixels within 1/255
before normalisation; the resize repeats Pillow's fixed-point arithmetic,
and reads the same pixels as Pillow here.  Also: the PNG
writer round-trips through Pillow, and `read_png` refuses a JPEG stream
naming its ROADMAP item (`read_image` decodes it, by content).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from apla_tpu.data.detection_data import CocoDetection as JCoco
from apla_tpu.data.detection_data import detection_collate as j_collate
from apla_tpu_torch.data import detection_data as tdd

MEAN = np.asarray(tdd.CocoDetection.mean)
STD = np.asarray(tdd.CocoDetection.std)

# (height, width, PIL mode): reductions in one or both axes, an enlargement,
# an unchanged size, and the colour types the decoder takes
IMAGES = [(60, 80, "RGB"), (192, 256, "RGB"), (40, 24, "RGBA"),
          (56, 56, "L"), (70, 50, "P"), (100, 100, "LA")]


def _write_set(root):
    rng = np.random.default_rng(0)
    img_dir = root / "imgs"
    os.makedirs(img_dir)
    images, anns = [], []
    for i, (h, w, mode) in enumerate(IMAGES):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        arr[h // 4:h // 2, w // 4:w // 2] = (200, 30, 90)   # a flat region
        im = Image.fromarray(arr)
        if mode == "P":
            im = im.quantize(64)
        elif mode != "RGB":
            im = im.convert(mode)
        name = f"im{i}.png"
        im.save(img_dir / name)
        images.append({"id": 10 + i, "file_name": name, "width": w,
                       "height": h})
        for j in range(i % 3 + 1):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": [3, 7, 9][j],
                         "bbox": [x, y, rng.uniform(2, w / 2),
                                  rng.uniform(2, h / 2)],
                         "iscrowd": int(j == 2 and i == 5)})
    ann = root / "instances.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": str(c)} for c in (3, 7, 9)]}))
    return str(img_dir), str(ann)


@pytest.mark.parametrize("img_size", [56, 224])
def test_dataset_matches_jax(tmp_path, img_size):
    img_dir, ann = _write_set(tmp_path)
    ours = tdd.CocoDetection(img_dir, ann, img_size=img_size, max_boxes=4)
    ref = JCoco(img_dir, ann, img_size=img_size, max_boxes=4)
    assert (len(ours), ours.n_classes, ours.ids) == (len(ref), ref.n_classes,
                                                    ref.ids)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["image"].dtype == np.float32 and \
            a["image"].shape == b["image"].shape == (img_size, img_size, 3)
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        assert a["n_boxes"] == b["n_boxes"]
        px_a = a["image"] * STD + MEAN
        px_b = b["image"] * STD + MEAN
        assert np.abs(px_a - px_b).max() <= 1 / 255 + 1e-5, i
    batch = tdd.detection_collate([ours[i] for i in range(3)])
    j_batch = j_collate([ref[i] for i in range(3)])
    assert {k: v.shape for k, v in batch.items()} == \
        {k: v.shape for k, v in j_batch.items()}


@pytest.mark.parametrize("resample", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(60, 80, 56, 56), (192, 256, 224, 224),
                                  (30, 20, 56, 56), (56, 56, 56, 56),
                                  (200, 150, 50, 70)])
def test_resize_is_pillows(size, resample):
    """Pixel for pixel: the port's resize against Pillow's, on noise
    (reductions, enlargements, mixed, unchanged)."""
    h, w, oh, ow = size
    arr = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    ref = np.asarray(Image.fromarray(arr).resize(
        (ow, oh), {"bilinear": Image.BILINEAR,
                   "bicubic": Image.BICUBIC}[resample]))
    got = tdd.resize(arr, ow, oh, resample)
    np.testing.assert_array_equal(got, ref)


def test_png_writer_and_reader_round_trip(tmp_path):
    arr = np.random.default_rng(1).integers(0, 256, (33, 47, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "x.png")
    tdd.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(tdd.read_png(path), arr)


def test_other_formats_and_masks_raise(tmp_path):
    """Other image formats still raise naming their ROADMAP item; the
    instance masks are ported: `with_masks=True` samples carry the JAX
    reader's masks (here each annotation's box fallback: the set has no
    segmentations; tests/test_torch_detection_masks.py holds RLE and
    polygons)."""
    from apla_tpu.data.detection_data import CocoDetection as JCoco
    path = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    with pytest.raises(NotImplementedError, match="PIL-free transforms"):
        tdd.read_png(str(path))
    img_dir, ann = _write_set(tmp_path)
    got = tdd.CocoDetection(img_dir, ann, with_masks=True, img_size=56)
    want = JCoco(img_dir, ann, with_masks=True, img_size=56)
    for i in range(len(got)):
        assert got[i]["masks"].shape == (32, 14, 14)
        np.testing.assert_array_equal(got[i]["masks"], want[i]["masks"])
    assert got[0]["masks"].any()
