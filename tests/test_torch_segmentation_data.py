"""The port's ADE20K-layout reader (`apla_tpu_torch.data.segmentation_data`)
against the JAX package's (`apla_tpu/data/segmentation_data.py`, PIL).

The test writes its own sets: PNG content under ADE20K's `.jpg` image
names (both readers decode by content), annotations as grey, palette and
RGB PNGs holding labels 0 (unlabelled) and 255, images not square, resized
up and down.  Images agree within 1e-6 (both normalise through float64),
labels exactly; the port's NEAREST resize equals Pillow's on odd sizes up
and down; a JPEG stream decodes as the JAX reader decodes it, and one the
decoder refuses raises naming the file.  Also the JAX package's own cases
(tests/test_segmentation_data.py) on the port.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from apla_tpu.data.segmentation_data import \
    ADE20KSegmentation as JaxADE20KSegmentation
from apla_tpu_torch.data.detection_data import (FORMATS_TODO, read_png,
                                                resize_nearest, write_png)
from apla_tpu_torch.data.segmentation_data import (ADE20KSegmentation,
                                                   segmentation_collate)

SIZES = ((40, 50), (61, 37), (512, 683), (33, 33))


def _ann_image(ann: np.ndarray, mode: str) -> Image.Image:
    if mode == "L":
        return Image.fromarray(ann, "L")
    if mode == "P":
        im = Image.fromarray(ann, "L").convert("P")
        return im
    # RGB: the label in the first channel, noise elsewhere
    rgb = np.stack([ann, 255 - ann, ann // 2], axis=-1)
    return Image.fromarray(rgb, "RGB")


def make_ade(root, n=4, sizes=SIZES, modes=("L", "P", "RGB")):
    """An ADE20K-layout set under `root`: PNG-encoded images under `.jpg`
    names, annotations in the given PNG modes, labels 0..150 and 255."""
    rng = np.random.default_rng(0)
    for split in ("training", "validation"):
        os.makedirs(os.path.join(root, "images", split))
        os.makedirs(os.path.join(root, "annotations", split))
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ann = np.zeros((h, w), np.uint8)
            ann[h // 4:h // 2, w // 4:3 * w // 4] = 1 + i
            ann[h // 2:, :w // 3] = 150
            ann[-3:, -5:] = 255
            write_png(os.path.join(root, "images", split, f"a{i}.jpg"), img)
            _ann_image(ann, modes[i % len(modes)]).save(
                os.path.join(root, "annotations", split, f"a{i}.png"))
        # an image without an annotation is skipped by both
        write_png(os.path.join(root, "images", split, "lonely.jpg"),
                  np.zeros((8, 8, 3), np.uint8))
    return str(root)


@pytest.mark.parametrize("img_size", [32, 64, 512])
def test_reader_matches_jax(tmp_path, img_size):
    root = make_ade(tmp_path)
    for split in ("training", "validation"):
        ours = ADE20KSegmentation(root, split, img_size=img_size)
        ref = JaxADE20KSegmentation(root, split, img_size=img_size)
        assert ours.samples == ref.samples and len(ours) == 4
        for i in range(len(ours)):
            a, r = ours[i], ref[i]
            assert a["image"].dtype == np.float32 == r["image"].dtype
            assert a["label"].dtype == np.int32 == r["label"].dtype
            np.testing.assert_allclose(a["image"], r["image"], rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(a["label"], r["label"])
    assert set(np.unique(ours[0]["label"])) >= {0, 149, 255}


def test_no_zero_label_reduction_matches_jax(tmp_path):
    root = make_ade(tmp_path, n=3)
    ours = ADE20KSegmentation(root, img_size=48, reduce_zero_label=False)
    ref = JaxADE20KSegmentation(root, img_size=48, reduce_zero_label=False)
    for i in range(3):
        np.testing.assert_array_equal(ours[i]["label"], ref[i]["label"])
    assert 0 in ours[0]["label"] and 255 in ours[0]["label"]


@pytest.mark.parametrize("shape", [(7, 13), (61, 37), (683, 512), (512, 683)])
@pytest.mark.parametrize("out", [(1, 1), (5, 9), (32, 32), (513, 511),
                                 (1000, 701)])
def test_nearest_resize_is_pillows(shape, out):
    rng = np.random.default_rng(shape[0] * out[0])
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(Image.fromarray(a).resize(out, Image.NEAREST))
    np.testing.assert_array_equal(resize_nearest(a, *out), ref)
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(rgb).resize(out, Image.NEAREST))
    np.testing.assert_array_equal(resize_nearest(rgb, *out), ref)


@pytest.mark.parametrize("mode", ["L", "P", "RGB", "LA"])
def test_raw_png_samples_are_pillows(tmp_path, mode):
    """`read_png(raw=True)`: the stored samples (a palette PNG's indices,
    not its colours), as np.asarray of the unconverted Pillow image."""
    rng = np.random.default_rng(1)
    ann = rng.integers(0, 151, (9, 14), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    im = (Image.fromarray(np.stack([ann, ann], -1), "LA") if mode == "LA"
          else _ann_image(ann, mode))
    im.save(path)
    ref = np.asarray(Image.open(path))
    got = read_png(path, raw=True)
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)


def test_grey_png_round_trip(tmp_path):
    a = np.random.default_rng(2).integers(0, 256, (11, 6), dtype=np.uint8)
    write_png(str(tmp_path / "g.png"), a)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")),
                                  a)


def test_jpeg_stream_raises(tmp_path):
    """A JPEG stream that the decoder refuses (a frame header cut short)
    raises naming the file; JPEG streams read as the JAX reader reads
    them."""
    root = make_ade(tmp_path, n=2)
    rng = np.random.default_rng(5)
    for i, sub in enumerate((2, 0)):
        img_path = os.path.join(root, "images", "training", f"a{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (45, 61, 3), np.uint8)).save(
            img_path, format="JPEG", quality=85, subsampling=sub)
        with open(img_path, "rb") as f:
            assert f.read(2) == b"\xff\xd8"
    ours, ref = ADE20KSegmentation(root, img_size=24), \
        JaxADE20KSegmentation(root, img_size=24)
    for i in range(2):
        got, want = ours[i], ref[i]
        np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["label"], want["label"])
    with open(img_path, "wb") as f:
        f.write(b"\xff\xd8\xff\xc0\x00\x11\x08")
    with pytest.raises(ValueError, match="a1.jpg"):
        ours[1]
    assert "PIL-free transforms" in FORMATS_TODO


def test_ade_layout_and_labels(tmp_path):
    """The JAX package's layout case: class 2 becomes label 1, 0 becomes
    ignore; the collate stacks."""
    root = make_ade(tmp_path, n=3, sizes=((40, 50),), modes=("L",))
    ds = ADE20KSegmentation(root, "training", img_size=32)
    assert len(ds) == 3
    s = ds[1]
    assert s["image"].shape == (32, 32, 3) and s["label"].shape == (32, 32)
    labels = np.unique(s["label"])
    assert 255 in labels and 1 in labels
    batch = segmentation_collate([ds[i] for i in range(2)])
    assert batch["label"].shape == (2, 32, 32)
    assert batch["image"].shape == (2, 32, 32, 3)


def test_seg_training_smoke(tmp_path):
    """The JAX package's smoke case on the port: eight steps on three
    read samples lower the loss; the mIoU is in [0, 1]."""
    from apla_tpu_torch.models.seg import (init_segmenter, mean_iou,
                                           make_seg_train_step,
                                           seg_optimizer, segmenter_forward)
    from apla_tpu_torch.models.vit import ViTConfig

    torch.manual_seed(0)
    root = make_ade(tmp_path, n=3, sizes=((40, 50),), modes=("L",))
    ds = ADE20KSegmentation(root, "training", img_size=32)
    b = segmentation_collate([ds[i] for i in range(3)])
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    cfg = ViTConfig(img_size=32, patch_size=8, embed_dim=64, depth=2,
                    num_heads=4, compute_dtype=torch.float32)
    model = init_segmenter(cfg, 5 + 150, channels=16)
    step = make_seg_train_step(cfg, seg_optimizer(model, 1e-3, 1e-4))
    losses = [float(step(model, batch)["loss"]) for _ in range(8)]
    assert losses[-1] < losses[0], losses
    with torch.no_grad():
        pred = segmenter_forward(model, batch["image"], cfg).argmax(-1)
    assert 0.0 <= mean_iou(pred.numpy(), b["label"], n_classes=155) <= 1.0
