"""The declarative image transforms the shipped recipes name, without PIL.

Counterpart of `apla_tpu/data/transforms.py` on uint8 HWC numpy arrays
where the JAX package holds Pillow images: the same names, parameters and
order (`build_transform`: geometric -> pixel -> ToArray/Normalize), the same
draws from the caller's `np.random.Generator`, and Pillow's arithmetic:

- `Resize`, `RandomResizedCrop`: Pillow's BICUBIC resample
  (`detection_data.resize` -> `native.resample`, its fixed-point filter);
- `CenterCrop`: torchvision's zero pad below the size, then the centre;
- `ColorJitter`: `ImageEnhance.Brightness`, `Contrast` and `Color` are
  `Image.blend` (float32, truncated, clipped when extrapolating) against
  black, the grey mean (`int(mean(L) + 0.5)` over Pillow's fixed-point
  RGB -> L) and the image's own grey; the hue shift goes through Pillow's
  RGB <-> HSV conversion (`native.hue_shift`; `rgb_to_hsv`, `hsv_to_rgb`
  and `hue_shift_reference` are its plain numpy version);
- `NativeToArrayNormalize`: `native.normalize`, the C++ pass the JAX
  package takes.

The other transforms of the JAX module are not ported yet: building one
gives a placeholder that raises `NotImplementedError` when it runs
(ROADMAP A 5), so a recipe that names one builds, and fails only if that
pipeline is used (the raw and on-device paths never run it).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .. import native
from .detection_data import resize as _pil_resize

ROADMAP_DATA = "ROADMAP A 5: PIL-free transforms and real datasets"

# The names `build_transform` reads before Normalize, in its order
# (RandomErasing comes after Normalize), and those not ported yet.
ORDER = ("Resize", "CenterCrop", "RandomCrop", "RandomResizedCrop",
         "VerticalFlip", "HorizontalFlip", "RandomRotation", "ColorJitter",
         "RandomGrayscale", "RandomGaussianBlur", "RandomAffine",
         "RandomPerspective", "RandomSolarize", "AugMix", "RandAugment",
         "AutoAugment", "TrivialAugment")
UNPORTED = tuple(n for n in ORDER if n not in (
    "Resize", "CenterCrop", "RandomResizedCrop", "HorizontalFlip",
    "ColorJitter")) + ("RandomErasing",)


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pillow's `img.resize((width, height), Image.BICUBIC)`."""
    return _pil_resize(img, width, height, "bicubic")


class Transform:
    def __call__(self, img, rng: np.random.Generator):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, img, rng):
        for t in self.transforms:
            img = t(img, rng)
        return img

    def __repr__(self):
        return f"Compose([{', '.join(repr(t) for t in self.transforms)}])"


class RandomApply(Transform):
    def __init__(self, transform: Transform, p: float = 0.5):
        self.transform = transform
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return self.transform(img, rng)
        return img

    def __repr__(self):
        return f"RandomApply({self.transform!r}, p={self.p})"


class Unported(Transform):
    """A transform of the JAX module that is not ported yet."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, img, rng):
        raise NotImplementedError(
            f"transform {self.name!r} is not ported yet ({ROADMAP_DATA})")

    def __repr__(self):
        return f"Unported({self.name})"


class Resize(Transform):
    def __init__(self, size):
        self.size = size            # int (short side) or (h, w)

    def __call__(self, img, rng):
        h, w = img.shape[:2]
        if isinstance(self.size, int):
            scale = self.size / min(w, h)
            return resize_bicubic(img, max(1, round(h * scale)),
                                  max(1, round(w * scale)))
        return resize_bicubic(img, *self.size)


def center_crop(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """The centre [th, tw] of `img`, zero-padded around its centre first
    where it is smaller (torchvision's CenterCrop, no rescale)."""
    h, w = img.shape[:2]
    if h < th or w < tw:
        out = np.zeros((max(h, th), max(w, tw)) + img.shape[2:], img.dtype)
        top, left = (out.shape[0] - h) // 2, (out.shape[1] - w) // 2
        out[top:top + h, left:left + w] = img
        img, (h, w) = out, out.shape[:2]
    top, left = (h - th) // 2, (w - tw) // 2
    return img[top:top + th, left:left + tw]


class CenterCrop(Transform):
    def __init__(self, size):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)

    def __call__(self, img, rng):
        return center_crop(img, *self.size)


class RandomResizedCrop(Transform):
    """Ten tries at a box of area `scale` and log-uniform aspect `ratio`
    (draws: uniform, uniform, then integers, integers for a box that
    fits), else the centre box clamped to `ratio`; BICUBIC to `size`."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img, rng):
        h, w = img.shape[:2]
        area = w * h
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(rng.integers(0, w - cw + 1))
                top = int(rng.integers(0, h - ch + 1))
                return resize_bicubic(img[top:top + ch, left:left + cw],
                                      *self.size)
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        left, top = (w - cw) // 2, (h - ch) // 2
        return resize_bicubic(img[top:top + ch, left:left + cw], *self.size)


class RandomHorizontalFlip(Transform):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return np.ascontiguousarray(img[:, ::-1])
        return img


# --------------------------------------------------------------------------- #
# Pillow's pixel arithmetic
# --------------------------------------------------------------------------- #

def rgb_to_l(img: np.ndarray) -> np.ndarray:
    """Pillow's `convert("L")`: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    x = img.astype(np.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """Pillow's `Image.blend(im1, im2, alpha)`: in1 + alpha * (in2 - in1)
    in float32, truncated; clipped to [0, 255] outside alpha in [0, 1]."""
    a = np.float32(alpha)
    in1 = im1.astype(np.int32)
    v = in1.astype(np.float32) + a * (im2.astype(np.int32) - in1).astype(
        np.float32)
    if 0.0 <= a <= 1.0:
        return v.astype(np.uint8)
    return np.clip(v, 0, 255).astype(np.uint8)


def brightness(img, factor):
    """`ImageEnhance.Brightness(img).enhance(factor)`."""
    return blend(np.zeros_like(img), img, factor)


def contrast(img, factor):
    """`ImageEnhance.Contrast(img).enhance(factor)`: against the grey
    mean `int(mean(L) + 0.5)`, the mean summed as ImageStat sums it."""
    lum = rgb_to_l(img)
    mean = int(float(lum.sum(dtype=np.int64)) / lum.size + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def saturation(img, factor):
    """`ImageEnhance.Color(img).enhance(factor)`: against the image's
    own grey."""
    return blend(np.repeat(rgb_to_l(img)[..., None], 3, axis=-1), img,
                 factor)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Pillow's `convert("HSV")` (Convert.c `rgb2hsv_row`): float32
    ratios, the hue offsets and the wrap in double, truncated to bytes."""
    f32, f64 = np.float32, np.float64
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(f32)
    s = cr / np.where(maxc == 0, 1, maxc).astype(f32)
    rc = (maxc - r).astype(f32) / cr
    gc = (maxc - g).astype(f32) / cr
    bc = (maxc - b).astype(f32) / cr
    h = np.where(r == maxc, (bc - gc).astype(f64),
                 np.where(g == maxc,
                          (2.0 + rc.astype(f64)) - bc.astype(f64),
                          (4.0 + gc.astype(f64)) - rc.astype(f64)))
    h = h.astype(f32).astype(f64)
    h = np.fmod(h / 6.0 + 1.0, 1.0).astype(f32)
    uh = np.clip((h.astype(f64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(f64) * 255.0).astype(np.int64), 0, 255)
    out = np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc], -1)
    return out.astype(np.uint8)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C's `round` on non-negative doubles."""
    fl = np.floor(x)
    return np.where(x - fl >= 0.5, fl + 1.0, fl)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow's HSV -> `convert("RGB")` (Convert.c `hsv2rgb`)."""
    f32, f64 = np.float32, np.float64
    h = hsv[..., 0].astype(f64)
    s = hsv[..., 1]
    v = hsv[..., 2].astype(np.int64)
    i = np.floor(h * 6.0 / 255.0).astype(np.int64)
    f = (h * 6.0 / 255.0 - i.astype(f64)).astype(f32)
    fs = (s.astype(f64) / 255.0).astype(f32)
    vd = v.astype(f64)
    p = _round_half_away(vd * (1.0 - fs.astype(f64)))
    q = _round_half_away(vd * (1.0 - (fs * f).astype(f64)))
    t = _round_half_away(vd * (1.0 - fs.astype(f64)
                               * (1.0 - f.astype(f64))))
    up, uq, ut = (np.clip(x, 0, 255).astype(np.int64) for x in (p, q, t))
    sector = i % 6
    pick = {0: (v, ut, up), 1: (uq, v, up), 2: (up, v, ut),
            3: (up, uq, v), 4: (ut, up, v), 5: (v, up, uq)}
    out = np.zeros(hsv.shape, np.int64)
    for k, (a, b, c) in pick.items():
        sel = sector == k
        out[sel] = np.stack([a[sel], b[sel], c[sel]], -1)
    grey = s == 0
    out[grey] = np.repeat(v[grey][:, None], 3, axis=-1)
    return out.astype(np.uint8)


def hue_shift(img: np.ndarray, shift: float) -> np.ndarray:
    """The JAX package's `_hue_shift`: the HSV hue byte moved by
    int(shift * 255), modulo 256, in the host C++ library."""
    return native.hue_shift(img, int(shift * 255))


def hue_shift_reference(img: np.ndarray, shift: float) -> np.ndarray:
    """`hue_shift` in numpy."""
    hsv = rgb_to_hsv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
    return hsv_to_rgb(hsv.astype(np.uint8))


class ColorJitter(Transform):
    """Draws a factor for each enabled op (brightness, contrast, saturation
    from U(max(0, 1 - a), 1 + a), the hue shift from U(-hue, hue)), then a
    permutation of them, and applies them in that order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _factor(rng, amount):
        return rng.uniform(max(0.0, 1 - amount), 1 + amount)

    def __call__(self, img, rng):
        ops = []
        if self.brightness:
            f = self._factor(rng, self.brightness)
            ops.append(lambda im, f=f: brightness(im, f))
        if self.contrast:
            f = self._factor(rng, self.contrast)
            ops.append(lambda im, f=f: contrast(im, f))
        if self.saturation:
            f = self._factor(rng, self.saturation)
            ops.append(lambda im, f=f: saturation(im, f))
        if self.hue:
            shift = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, s=shift: hue_shift(im, s))
        for i in rng.permutation(len(ops)):
            img = ops[int(i)](img)
        return img


class ToArray(Transform):
    """uint8 HWC -> float32 HWC in [0, 1]."""

    def __call__(self, img, rng):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return arr[..., None] if arr.ndim == 2 else arr


class NativeToArrayNormalize(Transform):
    """uint8 HWC -> float32 HWC normalised, in one C++ pass
    (`native.normalize`)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, img, rng):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.dtype == np.uint8 and arr.shape[-1] == len(self.mean):
            return native.normalize(arr, self.mean, self.std)
        return (arr.astype(np.float32) / 255.0 - self.mean) / self.std


class Normalize(Transform):
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr, rng):
        return (arr - self.mean) / self.std


def build_transform(transform_dict: dict, mean, std) -> Compose:
    """A Compose from a recipe's transform dict, in the JAX package's
    order; a switched-on transform that is not ported yet becomes an
    `Unported` placeholder at its place."""
    td = transform_dict or {}

    def on(name):
        entry = td.get(name)
        return bool(entry) and (entry is True or bool(entry.get("apply")))

    tl: list[Transform] = []
    for name in ORDER:
        if not on(name):
            continue
        e = td[name]
        if name == "Resize":
            tl.append(Resize((e["height"], e["width"])))
        elif name == "CenterCrop":
            tl.append(CenterCrop((e["height"], e["width"])))
        elif name == "RandomResizedCrop":
            tl.append(RandomResizedCrop(
                e["size"], scale=tuple(e["scale"]),
                ratio=tuple(e.get("ratio", (3 / 4, 4 / 3)))))
        elif name == "HorizontalFlip":
            tl.append(RandomHorizontalFlip(p=e["p"]))
        elif name == "ColorJitter":
            tl.append(RandomApply(
                ColorJitter(e["brightness"], e["contrast"], e["saturation"],
                            e["hue"]), p=e["p"]))
        else:
            tl.append(Unported(name))
    if td.get("Normalize"):
        tl.append(NativeToArrayNormalize(mean, std))
    else:
        tl.append(ToArray())
    if on("RandomErasing"):
        tl.append(Unported("RandomErasing"))
    return Compose(tl)
