"""The port's PIL-free transforms (`apla_tpu_torch.data.transforms`) against
the JAX package's (`apla_tpu/data/transforms.py`, Pillow).

Each transform runs on the same uint8 image (square and not, odd sizes)
from the same `np.random.Generator` state in both packages: uint8 outputs
must be bit equal, normalised float32 outputs within 1e-6 (`native.normalize`
on both sides gives them bit-equal here), and the generator's next draw
equal (the same draws were consumed).  The transforms that rest on the host
C++ ops (blur, the bilinear transform, the hue shift, the resample) run
twice, through the ops and through their plain numpy versions
(`plain_ops`).  Each of the auto-augment ops runs at every magnitude bin
TrivialAugment can draw, both signs (Rotate's bin 20 is 90 degrees, a
transpose on a square image).  `build_transform` of every shipped recipe's
transform dicts is run the same way, over many generator states; the
ImageNet recipe's RandomErasing `value: "random"` raises in both packages
at the same draws.  The committed manifest of the chip check
(`tests/data/transforms/manifest.json`) is what the JAX package computes
now and what the port gives through either arm.  Pillow's pixel arithmetic
that ColorJitter rests on (RGB -> L, RGB <-> HSV, blend) is checked on
every third 24-bit colour (5.6 million, every value of each channel among
them) in `test_pixel_arithmetic_*`.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageFilter

from apla_tpu.data import transforms as jt
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch import native
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


def _run_both(ours, ref, img, seed, plain=False):
    """-> (port output, JAX output as an array), after checking the two
    generators' next draws are equal; `plain`: the port on the plain
    numpy versions of its host C++ ops."""
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    if plain:
        with tt.plain_ops():
            got = ours(img, g1)
    else:
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
    """ImageEnhance's Brightness, Contrast and Color: the native blends
    (`native.enhance`) and their plain versions, on odd sizes."""
    for hw in ((33, 45), (7, 3)):
        img = _image(*hw, 7)
        pil = Image.fromarray(img)
        for ours, kind, ref in (
                (tt.brightness, "brightness", ImageEnhance.Brightness),
                (tt.contrast, "contrast", ImageEnhance.Contrast),
                (tt.saturation, "color", ImageEnhance.Color)):
            want = np.asarray(ref(pil).enhance(factor))
            np.testing.assert_array_equal(ours(img, factor), want)
            np.testing.assert_array_equal(
                tt.enhance_reference(img, kind, factor), want)


@pytest.mark.parametrize("shape,dtype", [((9, 7), np.uint8),
                                         ((9, 7, 4), np.uint8),
                                         ((9, 7, 3), np.float32)],
                         ids=["l", "rgba", "float"])
def test_native_enhance_takes_only_rgb_uint8(shape, dtype):
    """The native op is RGB uint8: other input raises there rather than
    passing to another arm.  The transforms bring L and RGBA to it as RGB
    (held against Pillow in `test_torch_img_channels.py`); float input
    still raises through them."""
    from apla_tpu_torch import native
    img = np.zeros(shape, dtype)
    with pytest.raises(ValueError, match="uint8 RGB HWC"):
        native.enhance(img, "brightness", 1.2)
    if dtype != np.uint8:
        with pytest.raises(ValueError, match="uint8 RGB HWC"):
            tt.brightness(img, 1.2)


def _recipe_dicts():
    for name, path in RECIPES.items():
        ds = load_merged_params(os.path.join(ROOT, path)).dataset_params
        for mode in ("train_transforms", "val_transforms", "test_transforms"):
            td = ds.get(mode)
            if isinstance(td, dict):
                yield pytest.param(name, td, id=f"{name}-{mode}")


def _run_or_raise(fn, img, seed):
    """-> ('out', the output, the next draw) or ('raise', the message,
    the next draw)."""
    rng = np.random.default_rng(seed)
    try:
        out = fn(img, rng)
    except ValueError as e:
        return "raise", str(e), rng.random()
    return "out", np.asarray(out), rng.random()


@pytest.mark.parametrize("name,td", list(_recipe_dicts()))
def test_build_transform_of_the_shipped_recipes_matches(name, td):
    """The same pipeline, step for step, with nothing left out: the
    ImageNet recipe's TrivialAugment and RandomErasing run too.  Its
    RandomErasing `value: "random"` raises in the JAX package whenever an
    erase is drawn (numpy cannot write the string into the float array);
    the port raises at the same seeds and agrees on the others."""
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    img = _image(75, 100, 8) if name != "synthetic" else _image(32, 32, 8)
    ours = tt.build_transform(td, mean, std)
    ref = jt.build_transform(td, mean, std)
    assert [type(t).__name__ for t in ours.transforms] == \
        [type(t).__name__ for t in ref.transforms]
    raised = 0
    for seed in range(12):
        got = _run_or_raise(ours, img, seed)
        want = _run_or_raise(ref, Image.fromarray(img), seed)
        assert got[0] == want[0] and got[2] == want[2], f"seed {seed}"
        if got[0] == "raise":
            raised += 1
            assert "could not convert string to float" in got[1] \
                and "JAX package" in got[1]
            continue
        assert got[1].dtype == np.float32 and got[1].shape == want[1].shape
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6,
                                   err_msg=f"seed {seed}")
    erasing = td.get("RandomErasing") or {}
    assert (raised > 0) == (erasing.get("apply") is True
                            and erasing.get("value") == "random")


def test_unported_transforms_build_and_raise_when_run():
    """The names that were placeholders once now build real transforms: a
    dict naming every transform of the JAX module builds the JAX module's
    pipeline, step for step, and runs it to the same output; only a
    RandomErasing `value` that is not a number raises, as in JAX."""
    td = {"Resize": {"apply": True, "height": 40, "width": 40},
          "CenterCrop": {"apply": True, "height": 38, "width": 38},
          "RandomCrop": {"apply": True, "height": 36, "width": 36,
                         "padding": 2},
          "RandomResizedCrop": {"apply": True, "size": 32,
                                "scale": [0.5, 1.0]},
          "VerticalFlip": {"apply": True, "p": 0.5},
          "HorizontalFlip": {"apply": True, "p": 0.5},
          "RandomRotation": {"apply": True, "angle": 20, "p": 0.5},
          "ColorJitter": {"apply": True, "brightness": 0.4, "contrast": 0.4,
                          "saturation": 0.2, "hue": 0.1, "p": 0.8},
          "RandomGrayscale": {"apply": True, "p": 0.2},
          "RandomGaussianBlur": {"apply": True, "p": 0.5, "radius_min": 0.1,
                                 "radius_max": 2.0},
          "RandomAffine": {"apply": True, "degrees": 10,
                           "translate": [0.1, 0.1], "scale": [0.9, 1.1],
                           "shear": 5, "p": 0.5},
          "RandomPerspective": {"apply": True, "distortion_scale": 0.3,
                                "p": 0.5},
          "RandomSolarize": {"apply": True, "threshold": 128, "p": 0.2},
          "AugMix": {"apply": True}, "RandAugment": {"apply": True},
          "AutoAugment": {"apply": True}, "TrivialAugment": {"apply": True},
          "RandomErasing": {"apply": True, "p": 0.5, "scale": [0.1, 0.2],
                            "ratio": [0.3, 3.3], "value": 0},
          "Normalize": True}
    assert set(td) - {"Normalize", "RandomErasing"} == set(tt.ORDER)
    mean, std = (0.5,) * 3, (0.25,) * 3
    ours = tt.build_transform(td, mean, std)
    ref = jt.build_transform(td, mean, std)
    assert [type(t).__name__ for t in ours.transforms] == \
        [type(t).__name__ for t in ref.transforms]
    assert len(ours.transforms) == len(tt.ORDER) + 2
    assert not hasattr(tt, "Unported") and not hasattr(tt, "UNPORTED")
    img = _image(43, 47, 9)
    for seed in range(4):
        got, want = _run_both(ours, ref, img, seed)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    td["RandomErasing"].update(p=1.0, value="random")
    with pytest.raises(ValueError, match="could not convert"):
        tt.build_transform(td, mean, std)(img, np.random.default_rng(0))


def _magnitudes(op):
    """Every (magnitude) TrivialAugment can hand `op`: each bin, both
    signs where signed; 0 for the ops without one."""
    mags, signed = jt.TrivialAugmentWide._OPS.get(op, (None, False))
    if mags is None:
        return [0.0]
    return [s * float(m) for m in mags for s in ((1, -1) if signed else (1,))]


@pytest.mark.parametrize("op", tt.OPS)
def test_apply_op_matches_at_every_bin(op):
    """Each op of `_apply_op` at every bin TrivialAugment draws, on a
    square image (Rotate +-90 is a transpose there) and odd non-square
    ones, through the native ops and their plain versions."""
    assert set(tt.OPS) == set(jt.TrivialAugmentWide._OPS) | {"Invert"}
    for hw in ((24, 24), (17, 29), (30, 11)):
        img = _image(*hw, 10)
        pil = Image.fromarray(img)
        for mag in _magnitudes(op):
            want = np.asarray(jt._apply_op(pil, op, mag, None))
            for plain in (False, True):
                if plain:
                    with tt.plain_ops():
                        got = tt.apply_op(img, op, mag)
                else:
                    got = tt.apply_op(img, op, mag)
                assert got.dtype == np.uint8
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{op} {mag} {hw} plain={plain}")


_NEW = {
    "RandomCrop": lambda m: m.RandomCrop((20, 24), padding=3),
    "RandomCrop-unpadded-larger": lambda m: m.RandomCrop(40),
    "VerticalFlip": lambda m: m.RandomVerticalFlip(0.5),
    "RandomRotation": lambda m: m.RandomRotation(45),
    "RandomGrayscale": lambda m: m.RandomGrayscale(0.5),
    "RandomGaussianBlur": lambda m: m.RandomGaussianBlur(0.7),
    "RandomGaussianBlur-p1": lambda m: m.RandomGaussianBlur(1.0, 0.1, 2.0),
    "RandomAffine": lambda m: m.RandomAffine(20, (0.1, 0.2), (0.8, 1.2), 10),
    "RandomAffine-rotation-only": lambda m: m.RandomAffine(30),
    "RandomPerspective": lambda m: m.RandomPerspective(0.5, 0.7),
    "RandomSolarize": lambda m: m.RandomSolarize(128, 0.5),
    "RandomSolarize-64": lambda m: m.RandomSolarize(64, 0.9),
    "AugMix": lambda m: m.AugMix(),
    "AugMix-depth2-alpha0.5": lambda m: m.AugMix(2, 2, 2, 0.5, False),
    "RandAugment": lambda m: m.RandAugment(),
    "RandAugment-3-15": lambda m: m.RandAugment(3, 15),
    "AutoAugment": lambda m: m.AutoAugment(),
    "TrivialAugment": lambda m: m.TrivialAugmentWide(),
}


@pytest.mark.parametrize("name", list(_NEW))
def test_transforms_match_jax(name):
    """uint8 out bit-equal to the JAX transform's and the same draws
    consumed, both arms, on square and non-square odd images."""
    ours, ref = _NEW[name](tt), _NEW[name](jt)
    for hw in ((25, 25), (31, 18)):
        img = _image(*hw, 11)
        for seed in range(8):
            for plain in (False, True):
                got, want = _run_both(ours, ref, img, seed, plain)
                assert got.dtype == np.uint8
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{hw} seed {seed} plain={plain}")


@pytest.mark.parametrize("value", [0, 0.5, (0.1, 0.2, 0.3), "random"])
def test_random_erasing_matches_and_raises_where_jax_raises(value):
    """On the normalised float array: the same boxes and fill; a value
    numpy cannot write into it raises ValueError at the same seeds."""
    arr = np.random.default_rng(1).standard_normal((21, 34, 3)).astype(
        np.float32)
    args = dict(p=0.6, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=value)
    ours, ref = tt.RandomErasing(**args), jt.RandomErasing(**args)
    raised = 0
    for seed in range(40):
        got = _run_or_raise(ours, arr, seed)
        want = _run_or_raise(ref, arr, seed)
        assert got[0] == want[0] and got[2] == want[2], seed
        if got[0] == "out":
            np.testing.assert_array_equal(got[1], want[1])
        else:
            raised += 1
            assert "JAX package" in got[1]
    assert (raised > 0) == isinstance(value, str)


@pytest.mark.parametrize("hw", [(24, 24), (19, 33), (5, 3), (1, 9)])
def test_gaussian_blur_native_plain_and_pillow_agree(hw):
    img = _image(*hw, 12)
    pil = Image.fromarray(img)
    for radius in (0.1, 0.37, 0.5, 1.0, 1.37, 2.0, 4.5, 20.0):
        want = np.asarray(pil.filter(ImageFilter.GaussianBlur(radius)))
        np.testing.assert_array_equal(native.gaussian_blur(img, radius),
                                      want, err_msg=str(radius))
        np.testing.assert_array_equal(tt.gaussian_blur_reference(img, radius),
                                      want, err_msg=str(radius))


@pytest.mark.parametrize("hw", [(24, 24), (19, 33), (2, 7)])
def test_bilinear_transform_native_plain_and_pillow_agree(hw):
    """Affine and perspective maps that leave the image on every side, at
    fractional and integer shifts."""
    h, w = hw
    img = _image(h, w, 13)
    pil = Image.fromarray(img)
    rng = np.random.default_rng(14)
    maps = [(1, 0.3, 0, 0, 1, 0), (1, 0, 0.31 * w, 0, 1, 0),
            (1, 0, -2.0, 0, 1, 3.0), (0.5, -0.2, w / 3, 0.1, 1.3, -h / 4)]
    maps += [tuple(rng.uniform(-1.5, 1.5, 6) * (1, 1, w / 3, 1, 1, h / 3))
             for _ in range(6)]
    for co in maps:
        want = np.asarray(pil.transform((w, h), Image.AFFINE, co,
                                        resample=Image.BILINEAR))
        np.testing.assert_array_equal(native.transform_bilinear(img, co),
                                      want, err_msg=str(co))
        np.testing.assert_array_equal(tt.transform_bilinear_reference(img, co),
                                      want, err_msg=str(co))
    for _ in range(6):
        co = tuple(rng.uniform(-1, 1, 8) * (0.3, 0.3, 3, 0.3, 0.3, 3, 0.003,
                                            0.003) + (1, 0, 0, 0, 1, 0, 0, 0))
        want = np.asarray(pil.transform((w, h), Image.PERSPECTIVE, co,
                                        resample=Image.BILINEAR))
        np.testing.assert_array_equal(
            native.transform_bilinear(img, co, perspective=True), want)
        np.testing.assert_array_equal(
            tt.transform_bilinear_reference(img, co, perspective=True), want)


def test_lookup_ops_match_pillow_on_few_valued_images():
    """equalize's table past 255 (clipped, as Pillow stores it), a step of
    0, one value; autocontrast of one value; on tiny images."""
    from PIL import ImageOps
    rng = np.random.default_rng(15)
    for _ in range(60):
        shape = (int(rng.integers(1, 6)), int(rng.integers(1, 6)), 3)
        img = (rng.integers(0, 4, shape) * int(rng.integers(1, 80))).astype(
            np.uint8)
        pil = Image.fromarray(img)
        np.testing.assert_array_equal(tt.equalize(img),
                                      np.asarray(ImageOps.equalize(pil)))
        np.testing.assert_array_equal(tt.autocontrast(img),
                                      np.asarray(ImageOps.autocontrast(pil)))
        np.testing.assert_array_equal(
            tt.smooth(img), np.asarray(pil.filter(ImageFilter.SMOOTH)))


# --------------------------------------------------------------------------- #
# the chip check's manifest
# --------------------------------------------------------------------------- #

MANIFEST = os.path.join(ROOT, "tests", "data", "transforms", "manifest.json")


def _manifest_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import make_transform_manifest
    finally:
        sys.path.pop(0)
    return make_transform_manifest


def test_transform_manifest_is_what_jax_computes_now():
    """tools/make_transform_manifest.py's cases cover every transform name
    and every op, and the committed sha256s are the JAX package's outputs
    now."""
    with open(MANIFEST) as f:
        got = json.load(f)
    assert got == _manifest_tool().manifest()
    names = {n for c in got["cases"] if "transform" in c
             for n in c["transform"]}
    assert set(tt.ORDER) | {"RandomErasing"} <= names
    assert {c["op"] for c in got["cases"] if "op" in c} == set(tt.OPS)
    assert {"square", "wide", "grey"} == {c["image"] for c in got["cases"]}


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
def test_port_gives_the_transform_manifest(plain):
    """The chip check's loop: the port's decodes of the fixtures, every
    case through the native ops or their plain versions, sha256 equal."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, bad, _ = smoke._transform_manifest_cases(
        ("plain" if plain else "native",))
    assert not bad, bad
