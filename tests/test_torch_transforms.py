"""The port's PIL-free transforms (`apla_tpu_torch.data.transforms`) against
the JAX package's (`apla_tpu/data/transforms.py`, Pillow).

Each ported transform runs on the same uint8 image from the same
`np.random.Generator` state in both packages: uint8 outputs must be bit
equal, normalised float32 outputs within 1e-6 (`native.normalize` on both
sides gives them bit-equal here), and the generator's next draw equal (the
same draws were consumed).  `build_transform` of every shipped recipe's
transform dicts is run the same way, over many generator states.  Pillow's
pixel arithmetic that ColorJitter rests on (RGB -> L, RGB <-> HSV, blend)
is checked on every third 24-bit colour (5.6 million, every value of each
channel among them) in `test_pixel_arithmetic_*`.
"""

import os

import numpy as np
import pytest
from PIL import Image, ImageEnhance

from apla_tpu.data import transforms as jt
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.data import transforms as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "imagenet": "params/finetune/dinov2/ImageNet/vit_b/apla.yml",
    "nabirds": "params/finetune/dinov2/NABirds/vit_b/apla.yml",
    "isic2019": "params/pretrain/dinov2/ISIC2019/vit_b/apla.yml",
    "synthetic": "params/synthetic/vit_tiny/apla.yml",
}


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x * 5 + y * 3) % 256], -1).astype(np.float32)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(
        np.uint8)


def _run_both(ours, ref, img, seed):
    """-> (port output, JAX output as an array), after checking the two
    generators' next draws are equal."""
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got = ours(img, g1)
    want = ref(Image.fromarray(img), g2)
    assert g1.random() == g2.random(), "the draws differ"
    return got, np.asarray(want)


@pytest.mark.parametrize("size", [(40, 40), (33, 57), (200, 150), 48])
def test_resize_matches(size):
    img = _image(61, 90, 1)
    got, want = _run_both(tt.Resize(size), jt.Resize(size), img, 0)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,crop", [((61, 90), (32, 32)),
                                     ((20, 30), (32, 24)),
                                     ((31, 31), (31, 31))])
def test_center_crop_matches(hw, crop):
    img = _image(*hw, 2)
    got, want = _run_both(tt.CenterCrop(crop), jt.CenterCrop(crop), img, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale,hw", [((0.8, 1.2), (256, 256)),
                                      ((0.08, 1.0), (75, 120)),
                                      ((1.5, 2.0), (60, 30))])
def test_random_resized_crop_matches(scale, hw):
    img = _image(*hw, 3)
    for seed in range(8):        # tries that fit, tries that fall back
        got, want = _run_both(tt.RandomResizedCrop(24, scale=scale),
                              jt.RandomResizedCrop(24, scale=scale), img,
                              seed)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


def test_horizontal_flip_and_random_apply_match():
    img = _image(9, 13, 4)
    for seed in range(6):
        got, want = _run_both(tt.RandomHorizontalFlip(0.5),
                              jt.RandomHorizontalFlip(0.5), img, seed)
        np.testing.assert_array_equal(got, want)
        got, want = _run_both(
            tt.RandomApply(tt.RandomHorizontalFlip(1.0), 0.5),
            jt.RandomApply(jt.RandomHorizontalFlip(1.0), 0.5), img, seed)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [(0.2, 0.2, 0.1, 0.1), (0.8, 0.8, 0.8, 0.4),
                                    (0.0, 0.5, 0.0, 0.0), (0.4, 0.0, 0.0, 0.5)])
def test_color_jitter_matches(params):
    img = _image(40, 52, 5)
    for seed in range(10):
        got, want = _run_both(tt.ColorJitter(*params), jt.ColorJitter(*params),
                              img, seed)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


def test_to_array_and_normalize_match():
    img = _image(17, 23, 6)
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    for ours, ref in ((tt.ToArray(), jt.ToArray()),
                      (tt.NativeToArrayNormalize(mean, std),
                       jt.NativeToArrayNormalize(mean, std))):
        got, want = _run_both(ours, ref, img, 0)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    arr = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(tt.Normalize(mean, std)(arr, None),
                               jt.Normalize(mean, std)(arr, None), rtol=0,
                               atol=1e-6)


def test_pixel_arithmetic_rgb_to_l_and_hsv_on_a_third_of_all_colours():
    allc = np.arange(0, 1 << 24, 3, dtype=np.uint32)
    for chunk in np.array_split(allc, 12):
        rgb = np.stack([(chunk >> 16) & 255, (chunk >> 8) & 255, chunk & 255],
                       -1).astype(np.uint8).reshape(1, -1, 3)
        np.testing.assert_array_equal(
            tt.rgb_to_l(rgb), np.asarray(Image.fromarray(rgb).convert("L")))
        np.testing.assert_array_equal(
            tt.rgb_to_hsv(rgb), np.asarray(Image.fromarray(rgb).convert("HSV")))
        np.testing.assert_array_equal(
            tt.hsv_to_rgb(rgb),
            np.asarray(Image.fromarray(rgb, "HSV").convert("RGB")))
        for shift in (-0.1, 0.05):          # the C++ round trip too
            np.testing.assert_array_equal(tt.hue_shift(rgb, shift),
                                          tt.hue_shift_reference(rgb, shift))


@pytest.mark.parametrize("factor", [0.0, 0.35, 1.0, 1.2, 2.5])
def test_pixel_arithmetic_enhance_matches_pillow(factor):
    img = _image(33, 45, 7)
    pil = Image.fromarray(img)
    for ours, ref in ((tt.brightness, ImageEnhance.Brightness),
                      (tt.contrast, ImageEnhance.Contrast),
                      (tt.saturation, ImageEnhance.Color)):
        np.testing.assert_array_equal(ours(img, factor),
                                      np.asarray(ref(pil).enhance(factor)))


def _recipe_dicts():
    for name, path in RECIPES.items():
        ds = load_merged_params(os.path.join(ROOT, path)).dataset_params
        for mode in ("train_transforms", "val_transforms", "test_transforms"):
            td = ds.get(mode)
            if isinstance(td, dict):
                yield pytest.param(name, td, id=f"{name}-{mode}")


@pytest.mark.parametrize("name,td", list(_recipe_dicts()))
def test_build_transform_of_the_shipped_recipes_matches(name, td):
    """The same pipeline, step for step; one that names a transform not
    ported yet (the ImageNet recipe's TrivialAugment and RandomErasing,
    which its `device_augment: true` never runs) has a placeholder at that
    step, raises when run, and the rest of it matches."""
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    img = _image(75, 100, 8) if name != "synthetic" else _image(32, 32, 8)
    ours = tt.build_transform(td, mean, std)
    ref = jt.build_transform(td, mean, std)
    assert len(ours.transforms) == len(ref.transforms)
    unported = [t for t in ours.transforms if isinstance(t, tt.Unported)]
    if unported:
        with pytest.raises(NotImplementedError, match="ROADMAP A 5"):
            ours(img, np.random.default_rng(0))
        td = {k: v for k, v in td.items() if k not in tt.UNPORTED}
        ours = tt.build_transform(td, mean, std)
        ref = jt.build_transform(td, mean, std)
    assert [type(t).__name__ for t in ours.transforms] == \
        [type(t).__name__ for t in ref.transforms]
    for seed in range(6):
        got, want = _run_both(ours, ref, img, seed)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=f"seed {seed}")


def test_unported_transforms_build_and_raise_when_run():
    td = {"Resize": {"apply": True, "height": 8, "width": 8},
          "RandomGaussianBlur": {"apply": True, "p": 0.5, "radius_min": 0.1,
                                 "radius_max": 2.0},
          "RandomErasing": {"apply": True, "p": 0.5, "scale": [0.1, 0.2],
                            "ratio": [0.3, 3.3], "value": 0},
          "Normalize": True}
    comp = tt.build_transform(td, (0.5,) * 3, (0.25,) * 3)
    assert [repr(t) for t in comp.transforms] == [
        "Resize", "Unported(RandomGaussianBlur)", "NativeToArrayNormalize",
        "Unported(RandomErasing)"]
    with pytest.raises(NotImplementedError, match="ROADMAP A 5"):
        comp(_image(8, 8), np.random.default_rng(0))
    assert set(tt.UNPORTED) | set(tt.ORDER) >= {"RandomErasing", "AugMix"}
