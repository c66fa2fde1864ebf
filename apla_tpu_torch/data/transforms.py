"""The declarative image transforms the recipes name, without PIL.

Counterpart of `apla_tpu/data/transforms.py` on uint8 HWC numpy arrays
where the JAX package holds Pillow images: every transform of that module
under the same name, with the same parameters and order (`build_transform`:
geometric -> pixel -> ToArray/Normalize -> RandomErasing), the same draws
from the caller's `np.random.Generator` (each comparison as the JAX module
writes it), and Pillow 12's arithmetic bit for bit:

- `Resize`, `RandomResizedCrop`: Pillow's BICUBIC resample
  (`detection_data.resize` -> `native.resample`, its fixed-point filter);
- `CenterCrop`: torchvision's zero pad below the size, then the centre;
  `RandomCrop`: `ImageOps.expand` with 0, and `Image.crop`'s zeros past the
  image;
- `ColorJitter` and the auto-augment ops' Brightness, Contrast and Color:
  `ImageEnhance`'s `Image.blend` (float32, truncated, clipped when
  extrapolating) against black, the grey mean (`int(mean(L) + 0.5)` over
  Pillow's fixed-point RGB -> L) and the image's own grey
  (`native.enhance`; `enhance_reference`); the hue shift through Pillow's
  RGB <-> HSV (`native.hue_shift`; `rgb_to_hsv`, `hsv_to_rgb` and
  `hue_shift_reference` are its plain numpy version);
  Sharpness against `ImageFilter.SMOOTH` (3 x 3, float32, rounded, the
  border copied);
- `RandomGrayscale`: `convert("L")` into three channels; `RandomSolarize`,
  Posterize, Invert, AutoContrast and Equalize: `ImageOps`' lookup tables;
- `RandomGaussianBlur`: `ImageFilter.GaussianBlur`, three extended box
  passes per axis (`native.gaussian_blur`; `gaussian_blur_reference`);
- `RandomRotation`, `RandomAffine`, `RandomPerspective` and the shears,
  translations and rotations of the auto-augment ops: `Image.transform`
  with BILINEAR, 0 outside the image (`native.transform_bilinear`;
  `transform_bilinear_reference`), behind `Image.rotate`'s fast paths (0,
  180, and 90 / 270 on a square image are copies and transposes) and its
  matrix rounded to 15 decimals;
- `NativeToArrayNormalize`: `native.normalize`, the C++ pass the JAX
  package takes.

`plain_ops()` runs every transform on the plain numpy versions of the host
C++ ops instead (the tests and the chip check hold the two arms equal).

Images are uint8 [H, W, 3] (RGB), [H, W] (L: `img_channels: 1`) or
[H, W, 4] (RGBA: `img_channels: 4`), as `np.asarray` of the Pillow image
in that mode.  L takes Pillow's arithmetic for one band: the resamples,
blur and transforms per band; Brightness and Contrast against black and
the image's mean; Color and the grayscale its identity; the hue shift
skipped (the JAX package shifts RGB only); ToArray gives [H, W, 1] and
Normalize broadcasts that against the three-entry mean to [H, W, 3], as
numpy does in the JAX package.  RGBA raises where the JAX package raises:
`ImageOps`' ops with Pillow's OSError, Normalize with numpy's ValueError
(four bands against three entries); before that its bands go through the
per-band ops (not Pillow's premultiplied resample and transform; no RGBA
output of the JAX transforms reaches a model), ImageEnhance with the
alpha kept.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np

from .. import native
from .detection_data import resize as _pil_resize
from .detection_data import resize_reference as _pil_resize_reference

# The names `build_transform` reads before Normalize, in its order
# (RandomErasing comes after Normalize).
ORDER = ("Resize", "CenterCrop", "RandomCrop", "RandomResizedCrop",
         "VerticalFlip", "HorizontalFlip", "RandomRotation", "ColorJitter",
         "RandomGrayscale", "RandomGaussianBlur", "RandomAffine",
         "RandomPerspective", "RandomSolarize", "AugMix", "RandAugment",
         "AutoAugment", "TrivialAugment")

_NATIVE = [True]


@contextlib.contextmanager
def plain_ops():
    """Within the block, the transforms run the plain numpy versions of the
    host C++ ops (resample, ImageEnhance's blends, hue shift, blur,
    bilinear transform, normalise) in this process."""
    before = _NATIVE[0]
    _NATIVE[0] = False
    try:
        yield
    finally:
        _NATIVE[0] = before


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pillow's `img.resize((width, height), Image.BICUBIC)`."""
    if _NATIVE[0]:
        return _pil_resize(img, width, height, "bicubic")
    return _pil_resize_reference(img, width, height, "bicubic")


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


# --------------------------------------------------------------------------- #
# geometry
# --------------------------------------------------------------------------- #

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


def crop(img: np.ndarray, left: int, top: int, width: int,
         height: int) -> np.ndarray:
    """Pillow's `img.crop((left, top, left + width, top + height))`: zeros
    where the box leaves the image."""
    h, w = img.shape[:2]
    if left >= 0 and top >= 0 and left + width <= w and top + height <= h:
        return img[top:top + height, left:left + width]
    out = np.zeros((height, width) + img.shape[2:], img.dtype)
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + height, h), min(left + width, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


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


class RandomCrop(Transform):
    """`padding` zeros around the image (`ImageOps.expand`), then a box of
    `size` at integers(0, w - tw + 1), integers(0, h - th + 1) (no draw
    when the image is the box's size)."""

    def __init__(self, size, padding: Optional[int] = None):
        self.size = size if isinstance(size, (tuple, list)) else (size, size)
        self.padding = padding

    def __call__(self, img, rng):
        if self.padding:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p)) + ((0, 0),) * (img.ndim - 2))
        th, tw = self.size
        h, w = img.shape[:2]
        if w == tw and h == th:
            return img
        left = int(rng.integers(0, max(w - tw, 0) + 1))
        top = int(rng.integers(0, max(h - th, 0) + 1))
        return crop(img, left, top, tw, th)


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


class RandomVerticalFlip(Transform):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return np.ascontiguousarray(img[::-1])
        return img


def transform_bilinear(img: np.ndarray, coeffs,
                       perspective: bool = False) -> np.ndarray:
    """Pillow's `img.transform(img.size, AFFINE | PERSPECTIVE, coeffs,
    resample=BILINEAR)` (`native.transform_bilinear`)."""
    if _NATIVE[0]:
        return native.transform_bilinear(img, coeffs, perspective)
    return transform_bilinear_reference(img, coeffs, perspective)


def transform_bilinear_reference(img: np.ndarray, coeffs,
                                 perspective: bool = False) -> np.ndarray:
    """`transform_bilinear` in numpy: Geometry.c's generic transform with
    its bilinear filter, in double, truncated to bytes."""
    if img.ndim == 2:
        return transform_bilinear_reference(img[..., None], coeffs,
                                            perspective)[..., 0]
    h, w = img.shape[:2]
    a = [float(v) for v in coeffs]
    yy, xx = np.mgrid[0:h, 0:w]
    xin, yin = xx + 0.5, yy + 0.5
    if perspective:
        xs = (a[0] * xin + a[1] * yin + a[2]) / (a[6] * xin + a[7] * yin + 1)
        ys = (a[3] * xin + a[4] * yin + a[5]) / (a[6] * xin + a[7] * yin + 1)
    else:
        xs = a[0] * xin + a[1] * yin + a[2]
        ys = a[3] * xin + a[4] * yin + a[5]
    inside = (xs >= 0.0) & (xs < w) & (ys >= 0.0) & (ys < h)
    xs = np.where(inside, xs, 0.5) - 0.5
    ys = np.where(inside, ys, 0.5) - 0.5
    x, y = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
    dx, dy = (xs - x)[..., None], (ys - y)[..., None]
    src = img.astype(np.int64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    y0 = np.clip(y, 0, h - 1)
    below = ((y + 1 >= 0) & (y + 1 < h))[..., None]
    y1 = np.clip(y + 1, 0, h - 1)
    v1 = src[y0, x0] + (src[y0, x1] - src[y0, x0]) * dx
    v2 = np.where(below, src[y1, x0] + (src[y1, x1] - src[y1, x0]) * dx, v1)
    out = (v1 + (v2 - v1) * dy).astype(np.uint8)
    out[~inside] = 0
    return out


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """Pillow's `img.rotate(angle, resample=BILINEAR)`: counter-clockwise
    about (w / 2, h / 2), the size kept; 0 and 180 (and 90 / 270 on a square
    image) are a copy and transposes."""
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    cx, cy = w / 2, h / 2
    t = -math.radians(angle)
    m = [round(math.cos(t), 15), round(math.sin(t), 15), 0.0,
         round(-math.sin(t), 15), round(math.cos(t), 15), 0.0]
    m[2], m[5] = (m[0] * -cx + m[1] * -cy + m[2],
                  m[3] * -cx + m[4] * -cy + m[5])
    m[2] += cx
    m[5] += cy
    return transform_bilinear(img, m)


class RandomRotation(Transform):
    def __init__(self, degrees):
        self.degrees = degrees if isinstance(degrees, (tuple, list)) \
            else (-degrees, degrees)

    def __call__(self, img, rng):
        return rotate(img, rng.uniform(*self.degrees))


class RandomAffine(Transform):
    """The JAX transform's draws (angle, then translate x and y, scale,
    shear where set) and its inverse-affine coefficients."""

    def __init__(self, degrees=0, translate=None, scale=None, shear=None):
        self.degrees = degrees if isinstance(degrees, (tuple, list)) \
            else (-degrees, degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear

    def __call__(self, img, rng):
        angle = math.radians(rng.uniform(*self.degrees))
        h, w = img.shape[:2]
        tx = ty = 0.0
        if self.translate:
            tx = rng.uniform(-self.translate[0], self.translate[0]) * w
            ty = rng.uniform(-self.translate[1], self.translate[1]) * h
        s = rng.uniform(*self.scale) if self.scale else 1.0
        shear = math.radians(rng.uniform(-self.shear, self.shear)) \
            if self.shear else 0.0
        cos_a, sin_a = math.cos(angle + shear), math.sin(angle + shear)
        a = cos_a / s
        b = sin_a / s
        cx, cy = w / 2, h / 2
        coeffs = (a, b, cx - a * (cx + tx) - b * (cy + ty),
                  -b, a, cy + b * (cx + tx) - a * (cy + ty))
        return transform_bilinear(img, coeffs)


class RandomPerspective(Transform):
    """Skips on `rng.random() >= p`; else each corner moved inwards by
    integers up to `distortion_scale` / 2 of the side, and the eight
    coefficients that map the output onto the input (`np.linalg.solve`)."""

    def __init__(self, distortion_scale=0.5, p=0.5):
        self.distortion_scale = distortion_scale
        self.p = p

    def __call__(self, img, rng):
        if rng.random() >= self.p:
            return img
        h, w = img.shape[:2]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)
        tl = (rng.integers(0, dx + 1), rng.integers(0, dy + 1))
        tr = (w - rng.integers(0, dx + 1), rng.integers(0, dy + 1))
        br = (w - rng.integers(0, dx + 1), h - rng.integers(0, dy + 1))
        bl = (rng.integers(0, dx + 1), h - rng.integers(0, dy + 1))
        coeffs = perspective_coeffs(
            [(0, 0), (w, 0), (w, h), (0, h)], [tl, tr, br, bl])
        return transform_bilinear(img, coeffs, perspective=True)


def perspective_coeffs(src, dst):
    """The eight PERSPECTIVE coefficients taking `dst` corners to `src`."""
    A = []
    for (x, y), (u, v) in zip(dst, src):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(src, dtype=np.float64).reshape(8)
    return tuple(np.linalg.solve(A, B))


# --------------------------------------------------------------------------- #
# Pillow's pixel arithmetic
# --------------------------------------------------------------------------- #

def rgb_to_l(img: np.ndarray) -> np.ndarray:
    """Pillow's `convert("L")`: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    x = img.astype(np.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def grayscale(img: np.ndarray) -> np.ndarray:
    """`ImageOps.grayscale(img).convert(img.mode)`: L unchanged, RGBA's
    grey with alpha 255."""
    if img.ndim == 2:
        return img.copy()
    grey = np.repeat(rgb_to_l(img)[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        return np.concatenate([grey, np.full_like(grey[..., :1], 255)], -1)
    return grey


def _rgba_refused(img: np.ndarray) -> None:
    """`ImageOps`' lookup-table ops on RGBA raise, as Pillow's do."""
    if img.ndim == 3 and img.shape[-1] == 4:
        raise OSError("not supported for mode RGBA")


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


def enhance(img: np.ndarray, kind: str, factor: float) -> np.ndarray:
    """`ImageEnhance.Brightness | Contrast | Color(img).enhance(factor)`
    (`kind` "brightness", "contrast", "color"; `native.enhance`).  L goes
    through its grey RGB (whose luma is the level itself: the same mean,
    and Color's blend of the image with itself); RGBA blends its colour
    and keeps its alpha, as ImageEnhance puts the alpha back."""
    if img.ndim == 2:
        rgb = np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(enhance(rgb, kind, factor)[..., 0])
    if img.shape[-1] == 4:
        return np.concatenate([enhance(np.ascontiguousarray(img[..., :3]),
                                       kind, factor), img[..., 3:]], -1)
    if _NATIVE[0]:
        return native.enhance(img, kind, factor)
    return enhance_reference(img, kind, factor)


def enhance_reference(img: np.ndarray, kind: str, factor: float):
    """`enhance` in numpy: `blend` against black (brightness), the grey
    mean `int(mean(L) + 0.5)`, the mean summed as ImageStat sums it
    (contrast), or the image's own grey (color)."""
    if kind == "brightness":
        return blend(np.zeros_like(img), img, factor)
    if kind == "contrast":
        lum = rgb_to_l(img)
        mean = int(float(lum.sum(dtype=np.int64)) / lum.size + 0.5)
        return blend(np.full_like(img, mean), img, factor)
    if kind == "color":
        return blend(grayscale(img), img, factor)
    raise ValueError(kind)


def brightness(img, factor):
    """`ImageEnhance.Brightness(img).enhance(factor)`."""
    return enhance(img, "brightness", factor)


def contrast(img, factor):
    """`ImageEnhance.Contrast(img).enhance(factor)`."""
    return enhance(img, "contrast", factor)


def saturation(img, factor):
    """`ImageEnhance.Color(img).enhance(factor)`."""
    return enhance(img, "color", factor)


def smooth(img: np.ndarray) -> np.ndarray:
    """`img.filter(ImageFilter.SMOOTH)`: the 3 x 3 kernel (1 1 1, 1 5 1,
    1 1 1) / 13 in float32, a row of three taps at a time from the row
    below up, rounded and clipped; the border pixels copied (the image
    copied whole below 3 x 3)."""
    h, w = img.shape[:2]
    out = img.copy()
    if h < 3 or w < 3:
        return out
    f = np.float32
    k = [f(v) / f(13) for v in (1, 1, 1, 1, 5, 1, 1, 1, 1)]
    src = img.astype(f)

    def row(r, kk):
        return (r[:, :-2] * kk[0] + r[:, 1:-1] * kk[1]) + r[:, 2:] * kk[2]
    ss = f(0) + row(src[2:], k[0:3])
    ss = ss + row(src[1:-1], k[3:6])
    ss = ss + row(src[:-2], k[6:9])
    v = np.where(ss <= 0, f(0), np.where(ss >= 255, f(255), ss + f(0.5)))
    out[1:-1, 1:-1] = v.astype(np.uint8)
    return out


def sharpness(img, factor):
    """`ImageEnhance.Sharpness(img).enhance(factor)`: against SMOOTH (the
    alpha of RGBA kept)."""
    out = blend(smooth(img), img, factor)
    if img.ndim == 3 and img.shape[-1] == 4:
        out[..., 3] = img[..., 3]
    return out


def _lut(img: np.ndarray, lut) -> np.ndarray:
    """`img.point(lut)`: one table for every channel, entries clipped to
    bytes as Pillow stores them."""
    return np.clip(np.asarray(lut), 0, 255).astype(np.uint8)[img]


def solarize(img: np.ndarray, threshold: int = 128) -> np.ndarray:
    """`ImageOps.solarize`: i below `threshold` kept, else 255 - i."""
    _rgba_refused(img)
    i = np.arange(256)
    return _lut(img, np.where(i < threshold, i, 255 - i))


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """`ImageOps.posterize`: the top `bits` bits of each value."""
    _rgba_refused(img)
    return _lut(img, np.arange(256) & ~(2 ** (8 - bits) - 1))


def invert(img: np.ndarray) -> np.ndarray:
    """`ImageOps.invert`."""
    _rgba_refused(img)
    return 255 - img


def autocontrast(img: np.ndarray) -> np.ndarray:
    """`ImageOps.autocontrast` (no cutoff): each channel's lowest and
    highest value stretched to 0 and 255, int(ix * scale + offset)
    clamped; a channel of one value kept."""
    _rgba_refused(img)
    if img.ndim == 2:
        return autocontrast(img[..., None])[..., 0]
    out = np.empty_like(img)
    for b in range(img.shape[-1]):
        h = np.bincount(img[..., b].ravel(), minlength=256)
        nz = np.flatnonzero(h)
        lo, hi = int(nz[0]), int(nz[-1])
        if hi <= lo:
            lut = np.arange(256)
        else:
            scale = 255.0 / (hi - lo)
            offset = -lo * scale
            lut = np.clip(np.trunc(np.arange(256) * scale + offset), 0, 255)
        out[..., b] = _lut(img[..., b], lut)
    return out


def equalize(img: np.ndarray) -> np.ndarray:
    """`ImageOps.equalize`: per channel, `step` = (pixels less the last
    value's count) // 255 and the table (step // 2 + the count below i) //
    step; a channel with one value or a step of 0 kept."""
    _rgba_refused(img)
    if img.ndim == 2:
        return equalize(img[..., None])[..., 0]
    out = np.empty_like(img)
    for b in range(img.shape[-1]):
        h = np.bincount(img[..., b].ravel(), minlength=256).astype(np.int64)
        histo = h[h > 0]
        step = 0
        if len(histo) > 1:
            step = (int(histo.sum()) - int(histo[-1])) // 255
        if not step:
            lut = np.arange(256)
        else:
            below = np.concatenate([[0], np.cumsum(h)[:-1]])
            lut = (step // 2 + below) // step
        out[..., b] = _lut(img[..., b], lut)
    return out


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
    int(shift * 255), modulo 256, in the host C++ library; an image that
    is not RGB unchanged."""
    if img.ndim != 3 or img.shape[-1] != 3:
        return img
    if _NATIVE[0]:
        return native.hue_shift(img, int(shift * 255))
    return hue_shift_reference(img, shift)


def hue_shift_reference(img: np.ndarray, shift: float) -> np.ndarray:
    """`hue_shift` in numpy."""
    hsv = rgb_to_hsv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
    return hsv_to_rgb(hsv.astype(np.uint8))


def _blur_box_radius(radius: float, passes: int = 3) -> np.float32:
    """BoxBlur.c's box radius for a Gaussian's `radius`: float32, its
    sqrt and floor in double."""
    f = np.float32
    r = f(radius)
    sigma2 = f(r * r / f(passes))
    big_l = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(math.floor((float(big_l) - 1.0) / 2.0))
    a = f(f(2) * small_l + f(1)) * f(small_l * f(small_l + f(1))
                                     - f(3) * sigma2)
    a = f(a / f(f(6) * f(sigma2 - f(small_l + f(1)) * f(small_l + f(1)))))
    return f(small_l + a)


def _box_pass(x: np.ndarray, fradius: np.float32) -> np.ndarray:
    """One extended box pass along the last axis of uint8 `x`."""
    radius = int(fradius)
    ww = int(np.float32(np.float32(1 << 24)
                        / np.float32(fradius * np.float32(2) + np.float32(1))))
    fw = ((1 << 24) - (radius * 2 + 1) * ww) // 2
    n = x.shape[-1]
    idx = np.arange(n)
    xi = x.astype(np.int64)
    acc = np.zeros_like(xi)
    for d in range(-radius, radius + 1):
        acc += xi[..., np.clip(idx + d, 0, n - 1)]
    far = xi[..., np.clip(idx - radius - 1, 0, n - 1)] \
        + xi[..., np.clip(idx + radius + 1, 0, n - 1)]
    bulk = (acc * ww + far * fw) & 0xFFFFFFFF
    return (((bulk + (1 << 23)) & 0xFFFFFFFF) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """`img.filter(ImageFilter.GaussianBlur(radius))`
    (`native.gaussian_blur`)."""
    if _NATIVE[0]:
        return native.gaussian_blur(img, radius)
    return gaussian_blur_reference(img, radius)


def gaussian_blur_reference(img: np.ndarray, radius: float) -> np.ndarray:
    """`gaussian_blur` in numpy: three box passes along the rows, then
    three along the columns."""
    if img.ndim == 2:
        return gaussian_blur_reference(img[..., None], radius)[..., 0]
    fr = _blur_box_radius(radius)
    if fr == 0:
        return img.copy()
    t = np.moveaxis(img, 1, -1)
    for _ in range(3):
        t = _box_pass(t, fr)
    t = np.moveaxis(np.moveaxis(t, -1, 1), 0, -1)
    for _ in range(3):
        t = _box_pass(t, fr)
    return np.ascontiguousarray(np.moveaxis(t, -1, 0))


# --------------------------------------------------------------------------- #
# colour transforms
# --------------------------------------------------------------------------- #

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


class RandomGrayscale(Transform):
    def __init__(self, p=0.1):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return grayscale(img)
        return img


class RandomGaussianBlur(Transform):
    """Skips on `rng.random() > p` (so p = 1 still draws); the radius from
    U(radius_min, radius_max)."""

    def __init__(self, p=0.5, radius_min=0.1, radius_max=2.0):
        self.p = p
        self.radius_min = radius_min
        self.radius_max = radius_max

    def __call__(self, img, rng):
        if rng.random() > self.p:
            return img
        return gaussian_blur(img, rng.uniform(self.radius_min,
                                              self.radius_max))


class RandomSolarize(Transform):
    def __init__(self, threshold=128, p=0.5):
        self.threshold = threshold
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return solarize(img, self.threshold)
        return img


# --------------------------------------------------------------------------- #
# auto-augmentation policies (on uint8, before ToArray)
# --------------------------------------------------------------------------- #

def apply_op(img: np.ndarray, op: str, magnitude: float) -> np.ndarray:
    """The JAX module's `_apply_op` (its `rng` argument unused there)."""
    h, w = img.shape[:2]
    if op == "ShearX":
        return transform_bilinear(img, (1, magnitude, 0, 0, 1, 0))
    if op == "ShearY":
        return transform_bilinear(img, (1, 0, 0, magnitude, 1, 0))
    if op == "TranslateX":
        return transform_bilinear(img, (1, 0, magnitude * w, 0, 1, 0))
    if op == "TranslateY":
        return transform_bilinear(img, (1, 0, 0, 0, 1, magnitude * h))
    if op == "Rotate":
        return rotate(img, magnitude)
    if op == "Brightness":
        return brightness(img, 1.0 + magnitude)
    if op == "Color":
        return saturation(img, 1.0 + magnitude)
    if op == "Contrast":
        return contrast(img, 1.0 + magnitude)
    if op == "Sharpness":
        return sharpness(img, 1.0 + magnitude)
    if op == "Posterize":
        return posterize(img, int(magnitude))
    if op == "Solarize":
        return solarize(img, int(magnitude))
    if op == "AutoContrast":
        return autocontrast(img)
    if op == "Equalize":
        return equalize(img)
    if op == "Invert":
        return invert(img)
    if op == "Identity":
        return img
    raise ValueError(op)


OPS = ("Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
       "Brightness", "Color", "Contrast", "Sharpness", "Posterize",
       "Solarize", "AutoContrast", "Equalize", "Invert")

RA_OPS = {
    # op: (magnitudes over 31 bins, signed)
    "Identity": (None, False),
    "ShearX": (np.linspace(0.0, 0.3, 31), True),
    "ShearY": (np.linspace(0.0, 0.3, 31), True),
    "TranslateX": (np.linspace(0.0, 150.0 / 331.0, 31), True),
    "TranslateY": (np.linspace(0.0, 150.0 / 331.0, 31), True),
    "Rotate": (np.linspace(0.0, 30.0, 31), True),
    "Brightness": (np.linspace(0.0, 0.9, 31), True),
    "Color": (np.linspace(0.0, 0.9, 31), True),
    "Contrast": (np.linspace(0.0, 0.9, 31), True),
    "Sharpness": (np.linspace(0.0, 0.9, 31), True),
    "Posterize": (8 - (np.arange(31) / ((31 - 1) / 4)).round(), False),
    "Solarize": (np.linspace(255.0, 0.0, 31), False),
    "AutoContrast": (None, False),
    "Equalize": (None, False),
}


class RandAugment(Transform):
    """`num_ops` ops drawn from RA_OPS, each at bin `magnitude`, signed
    ops negated on `rng.random() < 0.5`."""

    def __init__(self, num_ops=2, magnitude=9):
        self.num_ops = num_ops
        self.magnitude = magnitude

    def __call__(self, img, rng):
        names = list(RA_OPS)
        for _ in range(self.num_ops):
            op = names[int(rng.integers(0, len(names)))]
            mags, signed = RA_OPS[op]
            mag = 0.0
            if mags is not None:
                mag = float(mags[min(self.magnitude, len(mags) - 1)])
                if signed and rng.random() < 0.5:
                    mag = -mag
            img = apply_op(img, op, mag)
        return img


class TrivialAugmentWide(Transform):
    """One op of `OPS_WIDE` at a drawn bin, signed ops negated on
    `rng.random() < 0.5`."""

    OPS_WIDE = {
        "Identity": (None, False),
        "ShearX": (np.linspace(0.0, 0.99, 31), True),
        "ShearY": (np.linspace(0.0, 0.99, 31), True),
        "TranslateX": (np.linspace(0.0, 32.0 / 224.0, 31), True),
        "TranslateY": (np.linspace(0.0, 32.0 / 224.0, 31), True),
        "Rotate": (np.linspace(0.0, 135.0, 31), True),
        "Brightness": (np.linspace(0.0, 0.99, 31), True),
        "Color": (np.linspace(0.0, 0.99, 31), True),
        "Contrast": (np.linspace(0.0, 0.99, 31), True),
        "Sharpness": (np.linspace(0.0, 0.99, 31), True),
        "Posterize": (8 - (np.arange(31) / ((31 - 1) / 6)).round(), False),
        "Solarize": (np.linspace(255.0, 0.0, 31), False),
        "AutoContrast": (None, False),
        "Equalize": (None, False),
    }

    def __call__(self, img, rng):
        names = list(self.OPS_WIDE)
        op = names[int(rng.integers(0, len(names)))]
        mags, signed = self.OPS_WIDE[op]
        mag = 0.0
        if mags is not None:
            mag = float(mags[int(rng.integers(0, len(mags)))])
            if signed and rng.random() < 0.5:
                mag = -mag
        return apply_op(img, op, mag)


class AutoAugment(Transform):
    """The JAX module's ImageNet policy table: a sub-policy drawn, each of
    its two ops applied on `rng.random() < p` at bin min(int(m * 30 / 9),
    30) of RA_OPS."""

    POLICY = [
        (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
        (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 0)),
        (("Equalize", 0.8, 0), ("Equalize", 0.6, 0)),
        (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
        (("Equalize", 0.4, 0), ("Solarize", 0.2, 4)),
        (("Equalize", 0.4, 0), ("Rotate", 0.8, 8)),
        (("Solarize", 0.6, 3), ("Equalize", 0.6, 0)),
        (("Posterize", 0.8, 5), ("Equalize", 1.0, 0)),
        (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
        (("Equalize", 0.6, 0), ("Posterize", 0.4, 6)),
        (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
        (("Rotate", 0.4, 9), ("Equalize", 0.6, 0)),
        (("Equalize", 0.0, 0), ("Equalize", 0.8, 0)),
        (("Invert", 0.6, 0), ("Equalize", 1.0, 0)),
        (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
        (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
        (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
        (("Sharpness", 0.4, 7), ("Invert", 0.6, 0)),
        (("ShearX", 0.6, 5), ("Equalize", 1.0, 0)),
        (("Color", 0.4, 0), ("Equalize", 0.6, 0)),
        (("Equalize", 0.4, 0), ("Solarize", 0.2, 4)),
        (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 0)),
        (("Invert", 0.6, 0), ("Equalize", 1.0, 0)),
        (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
        (("Equalize", 0.8, 0), ("Equalize", 0.6, 0)),
    ]

    def __call__(self, img, rng):
        sub = self.POLICY[int(rng.integers(0, len(self.POLICY)))]
        for op, p, mag_idx in sub:
            if rng.random() < p:
                mags, signed = RA_OPS.get(op, (None, False))
                if op == "Invert":
                    mags, signed = None, False
                mag = 0.0
                if mags is not None:
                    mag = float(mags[min(int(mag_idx * 30 / 9), 30)])
                    if signed and rng.random() < 0.5:
                        mag = -mag
                img = apply_op(img, op, mag)
        return img


class AugMix(Transform):
    """Dirichlet weights and a Beta mix from the caller's generator, then
    `mixture_width` chains of 1-3 (or `chain_depth`) ops; the chains summed
    into a float32 mix, blended with the image in float32, clipped and
    truncated to bytes."""

    OPS_BASE = ["AutoContrast", "Equalize", "Posterize", "Rotate", "Solarize",
                "ShearX", "ShearY", "TranslateX", "TranslateY"]
    OPS_EXTRA = ["Brightness", "Color", "Contrast", "Sharpness"]

    def __init__(self, severity=3, mixture_width=3, chain_depth=-1, alpha=1.0,
                 all_ops=True):
        self.severity = severity
        self.mixture_width = mixture_width
        self.chain_depth = chain_depth
        self.alpha = alpha
        self.ops = self.OPS_BASE + (self.OPS_EXTRA if all_ops else [])

    def _mag(self, op, rng):
        mags, signed = RA_OPS.get(op, (None, False))
        if mags is None:
            return 0.0
        idx = min(self.severity * 3, len(mags) - 1)
        mag = float(mags[int(rng.integers(0, idx + 1))]) if idx > 0 else 0.0
        if signed and rng.random() < 0.5:
            mag = -mag
        return mag

    def __call__(self, img, rng):
        ws = rng.dirichlet([self.alpha] * self.mixture_width)
        m = rng.beta(self.alpha, self.alpha)
        base = img.astype(np.float32)
        mix = np.zeros_like(base)
        for i in range(self.mixture_width):
            depth = self.chain_depth if self.chain_depth > 0 \
                else int(rng.integers(1, 4))
            aug = img
            for _ in range(depth):
                op = self.ops[int(rng.integers(0, len(self.ops)))]
                aug = apply_op(aug, op, self._mag(op, rng))
            # the float64 weight times the chain, summed into float32
            np.add(mix, np.float64(ws[i]) * aug.astype(np.float64), out=mix,
                   casting="same_kind")
        out = np.float32(1 - m) * base + np.float32(m) * mix
        return np.clip(out, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# to float
# --------------------------------------------------------------------------- #

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
            if _NATIVE[0]:
                return native.normalize(arr, self.mean, self.std)
            return native.normalize_reference(arr, self.mean, self.std)
        return (arr.astype(np.float32) / 255.0 - self.mean) / self.std


class Normalize(Transform):
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr, rng):
        return (arr - self.mean) / self.std


class RandomErasing(Transform):
    """On the float HWC array after Normalize: skips on `rng.random() >=
    p`; else up to ten tries at a box of area `scale` and log-uniform
    aspect `ratio` that fits strictly inside, filled with `value`.

    `value` is written into the float array as the JAX module writes it,
    so a value numpy cannot read as a number (MAE's "random", which the
    ImageNet recipe names) raises ValueError at the first erase drawn, as
    it does there."""

    def __init__(self, p=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0):
        self.p = p
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, arr, rng):
        if rng.random() >= self.p:
            return arr
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                arr = arr.copy()
                try:
                    arr[top:top + eh, left:left + ew] = self.value
                except ValueError as e:
                    raise ValueError(
                        f"RandomErasing value {self.value!r}: {e} (the JAX "
                        f"package writes `value` into the float array, so a "
                        f"value that is not a number raises at the first "
                        f"erase drawn; the port keeps that reading)"
                    ) from None
                return arr
        return arr


# --------------------------------------------------------------------------- #
# declarative factory
# --------------------------------------------------------------------------- #

def _build(name: str, e: dict) -> Transform:
    if name == "Resize":
        return Resize((e["height"], e["width"]))
    if name == "CenterCrop":
        return CenterCrop((e["height"], e["width"]))
    if name == "RandomCrop":
        pad = e.get("padding", 0)
        return RandomCrop((e["height"], e["width"]),
                          padding=pad if pad and pad > 0 else None)
    if name == "RandomResizedCrop":
        return RandomResizedCrop(e["size"], scale=tuple(e["scale"]),
                                 ratio=tuple(e.get("ratio", (3 / 4, 4 / 3))))
    if name == "VerticalFlip":
        return RandomVerticalFlip(p=e["p"])
    if name == "HorizontalFlip":
        return RandomHorizontalFlip(p=e["p"])
    if name == "RandomRotation":
        return RandomApply(RandomRotation(e["angle"]), p=e["p"])
    if name == "ColorJitter":
        return RandomApply(ColorJitter(e["brightness"], e["contrast"],
                                       e["saturation"], e["hue"]), p=e["p"])
    if name == "RandomGrayscale":
        return RandomGrayscale(p=e["p"])
    if name == "RandomGaussianBlur":
        return RandomGaussianBlur(p=e["p"], radius_min=e["radius_min"],
                                  radius_max=e["radius_max"])
    if name == "RandomAffine":
        return RandomApply(RandomAffine(e["degrees"], e.get("translate"),
                                        e.get("scale"), e.get("shear")),
                           p=e["p"])
    if name == "RandomPerspective":
        return RandomPerspective(e["distortion_scale"], p=e["p"])
    if name == "RandomSolarize":
        return RandomSolarize(threshold=e["threshold"], p=e["p"])
    if name == "AugMix":
        return AugMix(severity=e.get("severity", 3),
                      mixture_width=e.get("mixture_width", 3),
                      chain_depth=e.get("chain_depth", -1),
                      alpha=e.get("alpha", 1.0),
                      all_ops=e.get("all_ops", True))
    if name == "RandAugment":
        return RandAugment(num_ops=e.get("num_ops", 2),
                           magnitude=e.get("magnitude", 9))
    if name == "AutoAugment":
        return AutoAugment()
    if name == "TrivialAugment":
        return TrivialAugmentWide()
    raise ValueError(name)


def build_transform(transform_dict: dict, mean, std) -> Compose:
    """A Compose from a recipe's transform dict, in the JAX package's
    order: the switched-on transforms of ORDER, ToArray (+ Normalize, one
    C++ pass), then RandomErasing."""
    td = transform_dict or {}

    def on(name):
        entry = td.get(name)
        return bool(entry) and (entry is True or bool(entry.get("apply")))

    tl: list[Transform] = [_build(name, td[name]) for name in ORDER
                           if on(name)]
    if td.get("Normalize"):
        tl.append(NativeToArrayNormalize(mean, std))
    else:
        tl.append(ToArray())
    if on("RandomErasing"):
        e = td["RandomErasing"]
        tl.append(RandomErasing(p=e["p"], scale=tuple(e["scale"]),
                                ratio=tuple(e["ratio"]), value=e["value"]))
    return Compose(tl)
