#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's decoder tests and their manifest.

    python3 tools/make_jpeg_fixtures.py [--out tests/data/jpeg] [--check]

Writes twelve small image files with Pillow, from seeded synthetic content,
one for each case the decoder must meet: 4:4:4, 4:2:2 and 4:2:0 sampling,
a progressive frame, restart intervals, grey, CMYK (Adobe), odd sizes
(257 x 255), ImageNet's usual 500 x 375 and 333 x 500, one image past
1024 px, and a PNG stream under a `.JPEG` name (ImageNet's train split
holds one).  Then `manifest.json`: each file's size and the sha256 of the
two decodes the datasets use, as the JAX package computes them:

- `full`: `BaseSet.load_image` (Pillow's `Image.open(...).convert("RGB")`);
- `raw256`: `BaseSet.__getitem__` in raw mode at `raw_size` 256 (the
  native DCT-scaled decode + bilinear, or Pillow + BICUBIC for the files
  that path hands to Pillow), with `path` saying which.

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
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_SIZE = 256


def _content(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients, a few discs and mild noise: compresses small, and
    still fills the AC coefficients and every colour channel."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                    128 + 100 * np.sin((x + y) / 23.0)], -1)
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.1, 0.3) * min(h, w)
        disc = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[disc] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def fixtures() -> dict[str, bytes]:
    """name -> file bytes (names keep the case of the extension)."""
    out = {}
    rgb = Image.fromarray
    out["s444.jpg"] = _jpeg(rgb(_content(96, 120, 1)), quality=90,
                            subsampling=0)
    out["s422.jpg"] = _jpeg(rgb(_content(100, 130, 2)), quality=85,
                            subsampling=1)
    out["s420.jpg"] = _jpeg(rgb(_content(110, 90, 3)), quality=80,
                            subsampling=2)
    out["progressive.jpg"] = _jpeg(rgb(_content(120, 150, 4)), quality=85,
                                   progressive=True)
    out["restart.jpg"] = _jpeg(rgb(_content(90, 140, 5)), quality=80,
                               restart_marker_blocks=5)
    out["grey.jpg"] = _jpeg(Image.fromarray(_content(80, 100, 6)[..., 1]),
                            quality=85)
    cmyk = np.array(rgb(_content(72, 96, 7)).convert("CMYK"))
    cmyk[..., 3] = np.linspace(0, 180, 96, dtype=np.uint8)[None]
    out["cmyk.jpg"] = _jpeg(Image.fromarray(cmyk, "CMYK"), quality=85)
    out["odd_257x255.jpg"] = _jpeg(rgb(_content(255, 257, 8)), quality=75)
    out["n01_500x375.JPEG"] = _jpeg(rgb(_content(375, 500, 9)), quality=75)
    out["n02_333x500.JPEG"] = _jpeg(rgb(_content(500, 333, 10)), quality=75,
                                    progressive=True)
    out["large_1280x1024.jpg"] = _jpeg(rgb(_content(1024, 1280, 11)),
                                       quality=50)
    buf = io.BytesIO()
    rgb(_content(60, 80, 12)).save(buf, "PNG")
    out["png_named.JPEG"] = buf.getvalue()
    return out


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def manifest(directory: str) -> dict:
    """The JAX package's decodes of every fixture in `directory`."""
    sys.path.insert(0, ROOT)
    from apla_tpu.data.datasets import BaseSet
    from apla_tpu.native import decode_jpeg

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
        raw = ds.__getitem__(0)["image"]
        with open(path, "rb") as f:
            native = decode_jpeg(f.read(), out_size=RAW_SIZE)
        files[name] = {
            "height": int(full.shape[0]), "width": int(full.shape[1]),
            "full": _sha(full), "raw256": _sha(raw),
            "path": "native" if native is not None else "pillow"}
    return {"raw_size": RAW_SIZE, "files": files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                   "jpeg"))
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
