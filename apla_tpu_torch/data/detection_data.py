"""COCO-format detection dataset and collate (the detection side-car's data
path), without PIL.

Counterpart of `apla_tpu/data/detection_data.py` (boxes): a COCO
`instances_*.json` reader that emits fixed-size padded ground truth, boxes
[M, 4] xyxy in resized coordinates and labels [M] with -1 padding.  The
card's machine has no Pillow, so images are decoded here, by their content
whatever the file's name (`read_image`, as Pillow's `Image.open` goes by
the content): PNG (every colour type and bit depth, Adam7, the five
scanline filters) and JPEG through the port's own decoders
(`apla_tpu_torch.native`; `decode_png` is the PNG decoder's plain numpy
version), BMP, GIF and TIFF through `data.image_formats`, each converted
as Pillow's `convert("RGB")` (or "L", "RGBA") does, and resized as
Pillow's `Image.resize(size,
BILINEAR)` does (`resize`; BICUBIC too, for `serve predict`'s image files
and the classification transforms): the filter's support grows with the
reduction factor, in Pillow's fixed-point arithmetic.
`write_png` is the matching encoder (used to write synthetic sets).

Instance masks (`with_masks=True`, the mask branch of `segdet det
--masks`): each annotation's segmentation rasterised onto the mask grid
(img_size / mask_stride) as the JAX reader does it: COCO RLE, uncompressed
or compressed (`rle_to_mask`, column-major runs) sampled at the nearest
source pixel, polygons through `polygons_to_mask`, which gives Pillow's
`ImageDraw.polygon(pts, fill=1, outline=1)` pixels without Pillow (the
vertices truncated to ints, then Pillow's scanline fill of `Draw.c`), and
the filled box where the segmentation is missing or empty.

Not ported yet: the image formats past these five (`FORMATS_TODO`);
asking for one raises, naming its ROADMAP item.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib

import numpy as np

from .. import native
from ..native import formats as nf
from . import image_formats

FORMATS_TODO = ("images other than PNG, JPEG, BMP, GIF and TIFF (WebP, PPM, "
                "TGA, ICO, JPEG 2000 ...) are not decoded without PIL: "
                "ROADMAP A 5 'PIL-free transforms and real datasets'")

_PNG_SIG = native.PNG_SIGNATURE


def _unfilter(raw: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None, Sub, Up, Average, Paeth) of
    `rows` rows of `stride` bytes, each after its filter byte; `bpp`: the
    bytes of a pixel, at least 1."""
    data = np.frombuffer(raw, np.uint8, rows * (stride + 1)).reshape(
        rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(rows):
        f, line = data[y, 0], data[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:            # Sub: running sum per byte of a pixel
            pad = np.zeros(-stride % bpp, np.int32)
            cur = (np.cumsum(np.concatenate([line, pad]).reshape(-1, bpp),
                             axis=0).reshape(-1)[:stride]) & 0xFF
        elif f == 2:            # Up
            cur = (line + prev) & 0xFF
        elif f in (3, 4):       # Average, Paeth: left to right
            vals, up = line.tolist(), prev.tolist()
            for x in range(stride):
                left = vals[x - bpp] if x >= bpp else 0
                if f == 3:
                    pred = (left + up[x]) >> 1
                else:
                    up_left = up[x - bpp] if x >= bpp else 0
                    p = left + up[x] - up_left
                    pa, pb, pc = abs(p - left), abs(p - up[x]), \
                        abs(p - up_left)
                    pred = left if pa <= pb and pa <= pc else \
                        (up[x] if pb <= pc else up_left)
                vals[x] = (vals[x] + pred) & 0xFF
            cur = np.asarray(vals, np.int32)
        else:
            raise native.PngError(f"PNG filter type {f} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, channels] int64
    (MSB first below 8 bits, big-endian at 16)."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows[:, :2 * width * channels].astype(np.int64).reshape(
            h, -1, 2)
        flat = pairs[..., 0] << 8 | pairs[..., 1]
    elif depth == 8:
        flat = rows[:, :width * channels].astype(np.int64)
    else:
        bits = np.unpackbits(rows, axis=1)[:, :width * channels * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        flat = (bits.reshape(h, -1, depth).astype(np.int64) * weights).sum(
            -1)
    return flat.reshape(h, width, channels)


def read_png(path: str, raw: bool = False) -> np.ndarray:
    """A PNG file -> [H, W, 3] uint8 RGB, as Pillow's `Image.open(path)
    .convert("RGB")` (`native.decode_png`).

    `raw`: the samples of the mode Pillow opens the file in instead, [H, W,
    bands] (a palette image's indices, a grey image's levels; bool for
    1-bit grey, uint16 for 16-bit grey), as `np.asarray` of the unconverted
    Pillow image gives them; label maps are read so.  A stream that is not
    a PNG raises NotImplementedError, one the decoder refuses ValueError,
    each naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode_png_native(data, path, raw)


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    """An image file -> uint8 [H, W, 3] RGB (`mode` "L": [H, W], "RGBA":
    [H, W, 4]), decoded by its content as Pillow's `Image.open(path)
    .convert(mode)` decodes it, whatever the name: PNG
    (`native.decode_png`), JPEG (`native.decode_jpeg`: grey expanded, CMYK
    and YCCK converted as Pillow converts them), BMP, GIF and TIFF
    (`data.image_formats`).  Other content raises NotImplementedError
    citing ROADMAP A 5; a stream a decoder refuses ValueError; each names
    the file."""
    with open(path, "rb") as f:
        data = f.read()
    kind = nf.sniff(data)
    try:
        return image_formats.decode_image(data, mode)
    except nf.Unsupported as e:
        raise NotImplementedError(f"{path}: {e}") from None
    except (native.JpegError, native.PngError, nf.ImageFormatError) as e:
        raise ValueError(f"{path}: {(kind or '').upper()} stream not "
                         f"decoded: {e}") from None


def _decode_png_native(data: bytes, path: str, raw: bool = False):
    if data[:8] != _PNG_SIG:
        raise NotImplementedError(f"{path}: {FORMATS_TODO}")
    try:
        return native.decode_png(data, raw)
    except native.PngError as e:
        raise ValueError(f"{path}: PNG stream not decoded: {e}") from None


def decode_png(data: bytes, path: str, raw: bool = False) -> np.ndarray:
    """`read_png` on the bytes of `path` (named in the errors) in numpy:
    the plain version that the tests hold `native.decode_png` to.  The
    chunks are read and inflated by `native.png_stream`; the passes are
    unfiltered, unpacked, put in place and converted here."""
    if data[:8] != _PNG_SIG:
        raise NotImplementedError(f"{path}: {FORMATS_TODO}")
    try:
        s = native.png_stream(data)
        h, w, depth, ctype = s["height"], s["width"], s["depth"], s["ctype"]
        ch = native.PNG_CHANNELS[ctype]
        bits = ch * depth
        px = np.zeros((h, w, ch), np.int64)
        pos = 0
        for x0, y0, dx, dy, pw, ph in native.png_passes(w, h,
                                                        s["interlace"]):
            stride = (pw * bits + 7) // 8
            rows = _unfilter(s["data"][pos:], ph, stride, max(1, bits // 8))
            pos += ph * (stride + 1)
            px[y0::dy, x0::dx] = _unpack(rows, pw, ch, depth)
    except native.PngError as e:
        raise ValueError(f"{path}: PNG stream not decoded: {e}") from None
    # the samples of Pillow's mode
    mode = s["mode"]
    if ctype == 0 and depth in (2, 4):
        px = px * (0x55 if depth == 2 else 0x11)
    elif depth == 16 and ctype == 4:            # "RGBA" from LA;16B
        px = (px >> 8)[..., [0, 0, 0, 1]]
    elif depth == 16 and ctype != 0:
        px = px >> 8
    if raw:
        dtype = {"1": bool, "I;16": np.uint16}.get(mode, np.uint8)
        return px.astype(dtype)
    if mode == "1":
        grey = px[..., 0] * 255
    elif mode == "I;16":
        grey = np.minimum(px[..., 0], 255)
    elif mode == "P":
        pal = np.zeros((256, 3), np.uint8)       # black past the entries
        pal[:len(s["palette"])] = s["palette"]
        return pal[px[..., 0]]
    elif mode in ("L", "LA"):
        grey = px[..., 0]
    else:
        return px[..., :3].astype(np.uint8)
    return np.repeat(grey[..., None], 3, axis=-1).astype(np.uint8)


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
        self.img_dir = img_dir
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.with_masks = with_masks
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
        out = {"image": arr.astype(np.float32), "boxes": boxes,
               "labels": labels, "n_boxes": len(anns)}
        if self.with_masks:
            hm = self.img_size // self.mask_stride
            masks = np.zeros((self.max_boxes, hm, hm), np.uint8)
            for i, ann in enumerate(anns):
                masks[i] = self._gt_mask(ann, (h0, w0), hm)
            out["masks"] = masks
        return out

    def _gt_mask(self, ann, src_hw, hm):
        """One annotation's segmentation on the [hm, hm] mask grid; a
        missing or empty segmentation falls back to the filled box."""
        h0, w0 = src_hw
        seg = ann.get("segmentation")
        if isinstance(seg, dict):  # RLE (uncompressed list or compressed str)
            full = rle_to_mask(seg)
            ys = (np.arange(hm) + 0.5) * full.shape[0] / hm
            xs = (np.arange(hm) + 0.5) * full.shape[1] / hm
            return full[ys.astype(int)[:, None], xs.astype(int)[None, :]]
        if isinstance(seg, list) and seg and isinstance(seg[0], (list, tuple)):
            return polygons_to_mask(seg, hm, hm, sx=hm / w0, sy=hm / h0)
        # box fallback (also what mmdet does for degenerate segmentations)
        x, y, bw, bh = ann["bbox"]
        m = np.zeros((hm, hm), np.uint8)
        x0 = int(np.floor(x / w0 * hm))
        y0 = int(np.floor(y / h0 * hm))
        x1 = int(np.ceil((x + bw) / w0 * hm))
        y1 = int(np.ceil((y + bh) / h0 * hm))
        m[max(y0, 0):y1, max(x0, 0):x1] = 1
        return m


def detection_collate(samples, rng=None, batch_key=None):
    del rng, batch_key
    out = {
        "image": np.stack([s["image"] for s in samples]),
        "boxes": np.stack([s["boxes"] for s in samples]),
        "labels": np.stack([s["labels"] for s in samples]),
    }
    if "masks" in samples[0]:
        out["masks"] = np.stack([s["masks"] for s in samples])
    return out


# ------------------------------------------------------------------ #
# instance masks: COCO RLE and polygons
# ------------------------------------------------------------------ #

def _rle_counts_from_string(s: str):
    """COCO's compressed-RLE characters -> the counts list (pycocotools'
    rleFrString: 5-bit groups, 0x20 = more, sign-extended on 0x10 in the
    last group, each count past the second a delta on counts[-2])."""
    counts = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle) -> np.ndarray:
    """COCO RLE ({'counts': list|str, 'size': [h, w]}) -> [h, w] uint8.
    Counts are column-major (Fortran) runs alternating 0/1, starting at 0."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _rle_counts_from_string(counts)
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((w, h)).T


_F32 = np.float32


def _c_int(v: float) -> int:
    """C's (int) cast of a double on x86-64 (`cvttpd2dq`): toward zero,
    INT_MIN for what int32 cannot hold."""
    if not math.isfinite(v) or not -2 ** 31 < v < 2 ** 31:
        return -2 ** 31
    return int(v)


def _roundf(v) -> float:
    """C's roundf: halves away from zero."""
    v = float(v)
    return math.floor(v + 0.5) if v >= 0 else -math.floor(-v + 0.5)


def _round_up(v) -> int:        # Draw.c ROUND_UP: floor(v + 0.5), mirrored
    return int(_roundf(v))


def _round_down(v) -> int:      # Draw.c ROUND_DOWN: ceil(v - 0.5), mirrored
    v = float(v)
    return int(math.ceil(v - 0.5)) if v >= 0 else -int(math.ceil(-v - 0.5))


class _Edge:
    """Draw.c's Edge: the int end points, their bounds and the float32
    slope dx/dy."""

    __slots__ = ("x0", "y0", "xmin", "xmax", "ymin", "ymax", "dx")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0 = x0, y0
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = _F32(0) if y0 == y1 else _F32(_F32(x1 - x0)
                                                / _F32(y1 - y0))

    def x_at(self, y: int):
        """The edge's x on row y, in float32 as Draw.c computes it."""
        return _F32(_F32(_F32(y - self.y0) * self.dx) + _F32(self.x0))


def _hline(img, x0: int, y: int, x1: int) -> None:
    """Draw.c's hline8: row y from x0 to x1 inclusive, clipped."""
    h, w = img.shape
    if not 0 <= y < h or x0 >= w or x1 < 0:
        return
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if x0 <= x1:
        img[y, x0:x1 + 1] = 1


def _polygon_edges(xy):
    """ImagingDrawPolygon's edge list of int vertices `xy`: a horizontal
    edge that continues the previous horizontal edge in the same direction
    extends it, and the ring closes unless its ends coincide."""
    edges = []
    for i in range(len(xy) - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i and y0 == xy[i - 1][1]:
            px = xy[i - 1][0]
            if x1 > x0 > px:
                edges[-1].xmax = x1
                continue
            if x1 < x0 < px:
                edges[-1].xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xy[-1] != xy[0]:
        edges.append(_Edge(*xy[-1], *xy[0]))
    return edges


def _fill_polygon(img, edges) -> None:
    """Pillow 12's scanline fill (`polygon_generic` of Draw.c, 8-bit
    images): horizontal edges are drawn as lines first; on each row the
    crossings of the other edges are sorted and filled in pairs from
    ROUND_UP to ROUND_DOWN.  An edge ending on the row counts twice unless
    the row is the last one; at an edge's end point a second edge meeting
    it there (rounded x equal, both sloped) may move the crossing next to
    where the two edges are on the neighbouring row, so that thin corners
    stay connected."""
    h = img.shape[0]
    ymin, ymax = h - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            _hline(img, e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    last = min(ymax, h)
    for y in range(max(ymin, 0), last + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            x = cur.x_at(y)
            xx.append(x)
            if y == cur.ymax and y < last:
                xx.append(x)
                continue
            if y not in (cur.ymin, cur.ymax) or cur.dx == 0:
                continue
            y_adj = y - 1 if y == cur.ymax else y + 1
            for other in table[:i]:
                if y not in (other.ymin, other.ymax) or other.dx == 0 \
                        or _roundf(other.x_at(y)) != _roundf(x) \
                        or not other.ymin <= y_adj <= other.ymax:
                    continue
                a, b = cur.x_at(y_adj), other.x_at(y_adj)
                if x > a + 1 and x > b + 1:
                    xx[-1] = _F32(_roundf(max(a, b)) + 1)
                elif a - 1 > x and b - 1 > x:
                    xx[-1] = _F32(_roundf(min(a, b)) - 1)
                break
        xx.sort()
        for j in range(1, len(xx), 2):
            _hline(img, _round_up(xx[j - 1]), y, _round_down(xx[j]))


def polygons_to_mask(polys, out_h: int, out_w: int, sx: float = 1.0,
                     sy: float = 1.0) -> np.ndarray:
    """COCO polygons ([[x0, y0, x1, y1, ...], ...], source-image coords,
    scaled by (sx, sy)) -> [out_h, out_w] uint8, each ring filled as
    Pillow's `ImageDraw.polygon(pts, outline=1, fill=1)` fills it; rings of
    fewer than 3 points are skipped."""
    img = np.zeros((out_h, out_w), np.uint8)
    for poly in polys:
        xy = [(_c_int(poly[i] * sx), _c_int(poly[i + 1] * sy))
              for i in range(0, len(poly) - 1, 2)]
        if len(xy) >= 3:
            _fill_polygon(img, _polygon_edges(xy))
    return img
