#!/usr/bin/env python3
"""Write the PNG fixtures of the port's decoder tests and their manifest.

    python3 tools/make_png_fixtures.py [--out tests/data/png] [--check]

Writes small PNG files from seeded synthetic content, one for each case
the decoder must meet: every colour type at every bit depth the format
allows (grey 1, 2, 4, 8, 16; RGB 8, 16; palette 1, 2, 4, 8; grey + alpha
8, 16; RGBA 8, 16), Adam7 interlacing (at sizes where some passes are
empty), each of the five scanline filters on every row and Pillow's
adaptive choice, a palette shorter than the indices that point past it,
transparency chunks (tRNS), several IDAT chunks, and a 224 x 224 RGB image
as the recipes read it.  Pillow writes the files it can write (grey 1, 8,
16, palette, LA, RGB and RGBA at 8 bits: adaptive filters); `encode_png`
below writes the others (2- and 4-bit grey, 16-bit colour, Adam7, one
filter throughout), since Pillow's encoder has no option for them.

Then `manifest.json`: each file's size and mode and the sha256 of the
decodes the port must give, as Pillow 12.1 and the JAX package compute
them:

- `full`: `BaseSet.load_image` of the JAX package (Pillow's
  `Image.open(...).convert("RGB")`);
- `raw`: `np.asarray(Image.open(...))`, the stored samples as the label
  maps are read (`raw_shape`, `raw_dtype`; a bool array hashed as uint8
  0 / 1: Pillow's bools may hold 255);
- `raw224`: `BaseSet.__getitem__` in raw mode at `raw_size` 224 (Pillow
  and BICUBIC).

Needs Pillow and the JAX package's data modules (`apla_tpu.data`), so it
runs where the CPU tests run.  `--check` writes nothing and exits 1 if the
files or the manifest differ from what it would write.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_SIZE = 224
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# (x0, y0, dx, dy) of the seven Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, row bytes] uint8 (MSB first below 8 bits,
    big-endian at 16)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    pad = -n % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint32)], 1)
    flat = flat.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1, dtype=np.uint32)
    return (flat << shifts).sum(-1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray,
                bpp: int) -> np.ndarray:
    x = row.astype(np.int32)
    up = prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, up_left)}[kind]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Each row with its filter byte: `filters` is an int (every row), a
    sequence (row i takes filters[i % len]) or "adaptive" (the least sum
    of |signed residuals|, libpng's heuristic)."""
    out = []
    prev = np.zeros(rows.shape[1], np.uint8)
    for i, row in enumerate(rows):
        if filters == "adaptive":
            cands = [_filter_row(k, row, prev, bpp) for k in range(5)]
            cost = [np.abs(c.astype(np.int8).astype(np.int32)).sum()
                    for c in cands]
            kind = int(np.argmin(cost))
            res = cands[kind]
        else:
            kind = filters if isinstance(filters, int) else \
                filters[i % len(filters)]
            res = _filter_row(kind, row, prev, bpp)
        out.append(bytes([kind]) + res.tobytes())
        prev = row
    return b"".join(out)


def encode_png(samples: np.ndarray, depth: int, ctype: int, *,
               palette=None, trns: bytes | None = None,
               interlace: bool = False, filters=(0, 1, 2, 3, 4),
               idat_chunks: int = 1, level: int = 6) -> bytes:
    """[H, W] or [H, W, C] samples (palette indices for colour type 3),
    each below 2**depth -> a PNG stream: `palette` [n, 3] uint8 (PLTE),
    `trns` the tRNS body, Adam7 when `interlace`, the scanline `filters`
    (see `_filtered`), the zlib stream cut into `idat_chunks` IDATs."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    assert c == CHANNELS[ctype], (c, ctype)
    bpp = max(1, c * depth // 8)
    if interlace:
        parts = []
        for x0, y0, dx, dy in ADAM7:
            sub = s[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                parts.append(_filtered(_pack(sub, depth), bpp, filters))
        raw = b"".join(parts)
    else:
        raw = _filtered(_pack(s, depth), bpp, filters)
    body = zlib.compress(raw, level)
    cut = [len(body) * i // idat_chunks for i in range(idat_chunks + 1)]
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cut[:-1], cut[1:]):
        out += _chunk(b"IDAT", body[a:b])
    return out + _chunk(b"IEND", b"")


def _content(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients, a disc and noise, [h, w, 3] float in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x / max(w - 1, 1), y / max(h - 1, 1),
                    0.5 + 0.4 * np.sin((x + y) / 7.0)], -1)
    cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), 0.3 * min(h, w)
    img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 1, 3)
    return np.clip(img + rng.normal(0, 0.04, img.shape), 0, 1)


def _levels(h, w, seed, depth, channels):
    img = _content(h, w, seed)
    if channels == 1:
        img = img.mean(-1, keepdims=True)
    elif channels == 2:
        img = np.concatenate([img.mean(-1, keepdims=True), img[..., :1]], -1)
    elif channels == 4:
        img = np.concatenate([img, img[..., 1:2] * 0.5 + 0.25], -1)
    top = (1 << depth) - 1
    return np.round(img * top).astype(np.uint16 if depth == 16 else np.uint8)


def _pillow(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _palette(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3),
                                                dtype=np.uint8)


def fixtures() -> dict[str, bytes]:
    """name -> file bytes."""
    from PIL import Image
    out = {}
    grey8 = _levels(37, 45, 1, 8, 1)[..., 0]
    out["grey8_pillow.png"] = _pillow(Image.fromarray(grey8))
    out["grey1_pillow.png"] = _pillow(Image.fromarray(grey8 > 127))
    out["grey16_pillow.png"] = _pillow(Image.fromarray(
        _levels(23, 31, 2, 16, 1)[..., 0]))
    rgb = (_content(50, 61, 3) * 255).round().astype(np.uint8)
    out["rgb8_pillow.png"] = _pillow(Image.fromarray(rgb))
    out["rgba8_pillow.png"] = _pillow(Image.fromarray(np.concatenate(
        [rgb, rgb[..., :1] // 2 + 60], -1)))
    out["la8_pillow.png"] = _pillow(Image.fromarray(rgb).convert("LA"))
    for colors, name in ((2, "p1"), (4, "p2"), (16, "p4"), (200, "p8")):
        out[f"{name}_pillow.png"] = _pillow(
            Image.fromarray(rgb).quantize(colors))
    # the recipes' size: smooth gradients with one noisy 64 x 64 patch
    # (noise all over would take 100 KB)
    y, x = np.mgrid[0:224, 0:224]
    big = np.stack([x / 223, y / 223, 0.5 + 0.4 * np.sin((x + y) / 7.0)], -1)
    big[80:144, 80:144] = _content(64, 64, 4)
    out["rgb_224.png"] = _pillow(Image.fromarray(
        (big * 255).round().astype(np.uint8)))
    # what Pillow's encoder does not write
    for depth in (1, 2, 4):
        out[f"grey{depth}_adam7.png"] = encode_png(
            _levels(19, 23, 10 + depth, depth, 1), depth, 0, interlace=True)
    out["grey4_sub.png"] = encode_png(_levels(9, 13, 5, 4, 1), 4, 0,
                                      filters=1)
    out["grey16_adam7_trns.png"] = encode_png(
        _levels(13, 11, 6, 16, 1), 16, 0, interlace=True,
        trns=struct.pack(">H", 300))
    out["rgb16_paeth.png"] = encode_png(_levels(17, 21, 7, 16, 3), 16, 2,
                                        filters=4)
    out["rgb16_adam7.png"] = encode_png(_levels(10, 9, 8, 16, 3), 16, 2,
                                        interlace=True)
    out["rgba16.png"] = encode_png(_levels(12, 14, 9, 16, 4), 16, 6,
                                   filters=(3, 4, 2))
    out["la16_adam7.png"] = encode_png(_levels(11, 15, 12, 16, 2), 16, 4,
                                       interlace=True)
    out["la8_avg.png"] = encode_png(_levels(14, 9, 13, 8, 2), 8, 4,
                                    filters=3)
    out["rgb8_adam7_1x1.png"] = encode_png(_levels(1, 1, 14, 8, 3), 8, 2,
                                           interlace=True)
    out["rgb8_adam7_3x5.png"] = encode_png(_levels(3, 5, 15, 8, 3), 8, 2,
                                           interlace=True, filters=2)
    out["rgba8_adam7.png"] = encode_png(_levels(21, 18, 16, 8, 4), 8, 6,
                                        interlace=True, filters="adaptive")
    for f in range(5):
        out[f"rgb8_filter{f}.png"] = encode_png(_levels(8, 11, 20 + f, 8, 3),
                                                8, 2, filters=f)
    rng = np.random.default_rng(30)
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        idx = rng.integers(0, n, (13, 17), dtype=np.uint8)
        out[f"p{depth}_adam7.png"] = encode_png(
            idx, depth, 3, palette=_palette(n, 31 + depth), interlace=True,
            trns=bytes(range(0, 250, 50))[:n])
    # 4-bit indices up to 15 over a palette of 5 colours
    out["p4_short_palette.png"] = encode_png(
        rng.integers(0, 16, (7, 9), dtype=np.uint8), 4, 3,
        palette=_palette(5, 40))
    out["rgb8_idat3.png"] = encode_png(_levels(16, 16, 41, 8, 3), 8, 2,
                                       idat_chunks=3, filters="adaptive")
    return out


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def manifest(directory: str) -> dict:
    """Pillow's and the JAX package's decodes of every fixture in
    `directory`."""
    from PIL import Image
    sys.path.insert(0, ROOT)
    from apla_tpu.data.datasets import BaseSet

    ds = BaseSet.__new__(BaseSet)
    ds.raw_mode, ds.raw_size = True, RAW_SIZE
    ds.resizing, ds.transform = None, None
    files = {}
    for name in sorted(os.listdir(directory)):
        if name == "manifest.json":
            continue
        path = os.path.join(directory, name)
        record = {"img_path": path, "label": 0}
        full = np.asarray(ds.load_image(record), np.uint8)
        ds.data = [record]
        with Image.open(path) as im:
            raw = np.asarray(im)
            mode = im.mode
        canon = raw.astype(np.uint8) if raw.dtype == bool else raw
        files[name] = {
            "height": int(full.shape[0]), "width": int(full.shape[1]),
            "mode": mode, "full": _sha(full), "raw": _sha(canon),
            "raw_shape": list(raw.shape), "raw_dtype": raw.dtype.str,
            "raw224": _sha(ds.__getitem__(0)["image"])}
    return {"raw_size": RAW_SIZE, "files": files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                   "png"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    want = fixtures()
    if args.check:
        same = all(
            os.path.exists(os.path.join(args.out, n))
            and open(os.path.join(args.out, n), "rb").read() == b
            for n, b in want.items())
        with open(os.path.join(args.out, "manifest.json")) as f:
            same = same and json.load(f) == manifest(args.out)
        print("fixtures and manifest up to date" if same else "stale")
        return 0 if same else 1
    os.makedirs(args.out, exist_ok=True)
    for name, data in want.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest(args.out), f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(b) for b in want.values())
    print(f"{len(want)} files, {total} bytes, in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
