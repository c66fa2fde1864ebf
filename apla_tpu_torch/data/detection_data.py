"""COCO-format detection dataset and collate (the detection side-car's data
path), without PIL.

Counterpart of `apla_tpu/data/detection_data.py` (boxes): a COCO
`instances_*.json` reader that emits fixed-size padded ground truth, boxes
[M, 4] xyxy in resized coordinates and labels [M] with -1 padding.  The
card's machine has no Pillow, so images are decoded here, by their content
whatever the file's name (`read_image`, as Pillow's `Image.open` goes by
the content): PNG (8-bit grey, grey + alpha, RGB, RGBA or palette; the
five scanline filters; no interlacing) with `zlib` and numpy, JPEG through
the port's own decoder (`apla_tpu_torch.native`), each converted to RGB as
Pillow's `convert("RGB")` does, and resized as Pillow's `Image.resize(size,
BILINEAR)` does (`resize`; BICUBIC too, for `serve predict`'s image files
and the classification transforms): the filter's support grows with the
reduction factor, in Pillow's fixed-point arithmetic.
`write_png` is the matching encoder (used to write synthetic sets).

Not ported yet: the other image formats, and the instance masks
(`rle_to_mask`, `polygons_to_mask`, `with_masks=True`); asking for either
raises, naming its ROADMAP item.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib

import numpy as np

from .. import native

FORMATS_TODO = ("only PNG and JPEG images are decoded without PIL: ROADMAP A "
                "'PIL-free transforms and real datasets'")
MASKS_TODO = ("instance masks (RLE and polygon rasterising without PIL) are "
              "not ported yet: ROADMAP A 'Detection mask branch'")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # PNG colour type -> samples


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None, Sub, Up, Average, Paeth)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:            # Sub: running sum per byte of a pixel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif f == 2:            # Up
            cur = (line + prev) & 0xFF
        elif f in (3, 4):       # Average, Paeth: left to right
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                if f == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), \
                        np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG filter type {f} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str, raw: bool = False) -> np.ndarray:
    """An 8-bit PNG file -> [H, W, 3] uint8 RGB (grey replicated, alpha
    dropped, palette looked up: Pillow's `convert("RGB")`).

    `raw`: the stored samples instead, [H, W, channels] uint8 (a palette
    image's indices, a grey image's levels), as `np.asarray` of the
    unconverted Pillow image gives them; label maps are read so."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, path, raw)


def read_image(path: str) -> np.ndarray:
    """An image file -> [H, W, 3] uint8 RGB, decoded by its content as
    Pillow's `Image.open(path).convert("RGB")` decodes it: a PNG stream
    (`decode_png`) or a JPEG stream (`native.decode_jpeg`: grey expanded,
    CMYK and YCCK converted as Pillow converts them), whatever the name.
    Any other content, or a stream the decoder refuses, raises naming the
    file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        try:
            return native.decode_jpeg(data)
        except native.JpegError as e:
            raise ValueError(f"{path}: JPEG stream not decoded: {e}") \
                from None
    return decode_png(data, path)


def decode_png(data: bytes, path: str, raw: bool = False) -> np.ndarray:
    """`read_png` on the bytes of `path` (named in the errors)."""
    if data[:8] != _PNG_SIG:
        raise NotImplementedError(f"{path}: {FORMATS_TODO}")
    pos, idat, plte = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; only 8-bit non-interlaced PNGs are "
            f"decoded ({FORMATS_TODO})")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    px = px.reshape(h, w, ch)
    if raw:
        return px
    if ctype == 3:
        return plte[px[..., 0]]
    if ch in (1, 2):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG, or [H, W] uint8 -> an 8-bit
    grey one (filter Sub on every row)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    ch = 1 if rgb.ndim == 2 else 3
    rows = rgb.reshape(h, w * ch).astype(np.int16)
    sub = np.concatenate([rows[:, :ch], rows[:, ch:] - rows[:, :-ch]],
                         axis=1)
    raw = np.concatenate([np.ones((h, 1), np.uint8),
                          (sub & 0xFF).astype(np.uint8)], axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             2 if ch == 3 else 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


_PRECISION_BITS = 32 - 8 - 2      # Pillow's fixed point for 8-bit images


def _triangle(x):
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _cubic(x, a=-0.5):
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# Pillow's resampling filters: (function, support)
FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


def _coeffs(in_size: int, out_size: int, resample: str):
    """Pillow's `precompute_coeffs` with the `resample` filter, then
    `normalize_coeffs_8bpc`: -> (first tap [out], fixed-point weights
    [out, ksize] int64, zero past each row's tap count)."""
    fn, base_support = FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(ws)
        for x, wgt in enumerate(ws):
            v = (wgt / ww if ww != 0.0 else wgt) * (1 << _PRECISION_BITS)
            kk[xx, x] = int(-0.5 + v) if v < 0 else int(0.5 + v)
        xmins[xx] = xmin
    return xmins, kk


def _resample(img: np.ndarray, out_size: int, axis: int,
              resample: str) -> np.ndarray:
    """One separable pass of Pillow's 8-bit resample along `axis`."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size, resample)
    taps = np.minimum(xmins[:, None] + np.arange(kk.shape[1])[None],
                      in_size - 1)                        # [out, ksize]
    src = np.take(img.astype(np.int64), taps, axis=axis)  # ..., out, k, ...
    wshape = [1] * src.ndim
    wshape[axis], wshape[axis + 1] = kk.shape
    acc = (src * kk.reshape(wshape)).sum(axis=axis + 1) \
        + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, width: int, height: int,
           resample: str = "bilinear") -> np.ndarray:
    """[H, W, C] uint8 -> [height, width, C] uint8, as Pillow's
    `Image.resize((width, height), Image.BILINEAR or BICUBIC)`, in the
    host C++ library (`native.resample`; `resize_reference` is its plain
    numpy version)."""
    return native.resample(img, height, width, resample)


def resize_reference(img: np.ndarray, width: int, height: int,
                     resample: str = "bilinear") -> np.ndarray:
    """`resize` in numpy: a copy when the size is unchanged, otherwise a
    horizontal then a vertical pass, each only where that side changes."""
    out = np.array(img, np.uint8, copy=True)
    if out.shape[1] != width:
        out = _resample(out, width, 1, resample)
    if out.shape[0] != height:
        out = _resample(out, height, 0, resample)
    return out


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, ...] -> [height, width, ...], as Pillow's `Image.resize((width,
    height), Image.NEAREST)`: output pixel x reads input column
    int(x0 + x * s) with s = W / width and x0 = s / 2, the position summed
    step by step in double precision as Pillow's `ImagingScaleAffine`
    does; rows likewise.  A copy when the size is unchanged."""
    def taps(n_in, n_out):
        s = n_in / n_out
        pos, out = s * 0.5, np.empty(n_out, np.int64)
        for i in range(n_out):
            out[i] = min(int(pos), n_in - 1)
            pos += s
        return out

    out = np.array(img, copy=True)
    if out.shape[1] != width:
        out = out[:, taps(out.shape[1], width)]
    if out.shape[0] != height:
        out = out[taps(out.shape[0], height)]
    return out


class CocoDetection:
    """Reads a COCO `instances_*.json` + image dir.  Samples:
    {'image': HWC float32 (resized, normalized), 'boxes': [M,4] (resized
    coords), 'labels': [M], 'n_boxes': int}."""

    mean = (0.485, 0.456, 0.406)
    std = (0.229, 0.224, 0.225)

    def __init__(self, img_dir: str, ann_file: str, img_size: int = 224,
                 max_boxes: int = 32, with_masks: bool = False,
                 mask_stride: int = 4):
        if with_masks:
            raise NotImplementedError(MASKS_TODO)
        self.img_dir = img_dir
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.mask_stride = mask_stride
        with open(ann_file) as f:
            coco = json.load(f)
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.cat_to_label = {c: i for i, c in enumerate(cat_ids)}
        self.n_classes = len(cat_ids)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd"):
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.images)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx, rng=None):
        img_id = self.ids[idx]
        info = self.images[img_id]
        img = read_image(os.path.join(self.img_dir, info["file_name"]))
        h0, w0 = img.shape[:2]
        img = resize(img, self.img_size, self.img_size)
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - self.mean) / self.std

        sx = self.img_size / w0
        sy = self.img_size / h0
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.full((self.max_boxes,), -1, np.int32)
        anns = self.anns_by_image.get(img_id, [])[:self.max_boxes]
        for i, ann in enumerate(anns):
            x, y, bw, bh = ann["bbox"]  # COCO xywh
            boxes[i] = [x * sx, y * sy, (x + bw) * sx, (y + bh) * sy]
            labels[i] = self.cat_to_label[ann["category_id"]]
        return {"image": arr.astype(np.float32), "boxes": boxes,
                "labels": labels, "n_boxes": len(anns)}


def detection_collate(samples, rng=None, batch_key=None):
    del rng, batch_key
    return {
        "image": np.stack([s["image"] for s in samples]),
        "boxes": np.stack([s["boxes"] for s in samples]),
        "labels": np.stack([s["labels"] for s in samples]),
    }
