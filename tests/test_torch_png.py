"""The port's PNG decoder (`apla_tpu_torch.native.decode_png`: chunks and
zlib in Python, the scanlines in `native/png_dec.cpp`) against Pillow 12.1
and against its plain numpy version (`data.detection_data.decode_png`).

- The committed fixtures (`tests/data/png/`, written by
  `tools/make_png_fixtures.py`): the RGB decode bit-equal to the manifest
  (Pillow's `convert("RGB")`, the JAX package's `load_image`), to Pillow
  and to the numpy version; `raw=True` to `np.asarray` of the unconverted
  Pillow image (values, dtype, shape); the raw-mode sample at 224 to the
  JAX package's; the manifest and the files are what the script writes;
  the fixtures stay under 100 KB.
- Streams written here at every colour type and bit depth, interlaced and
  not, with every scanline filter: the same three-way equality.
- Refused streams raise (not a PNG, a wrong CRC, a cut-off chunk, a filter
  type past 4, image data that ends early or does not inflate, a bit depth
  the colour type does not allow, a palette image without PLTE, no IDAT),
  naming the file through `read_png` / `read_image`, never falling back;
  mutated streams decode or raise; a failed build raises; the source
  builds without warnings; a 224 x 224 RGB decode stays within 3x of
  Pillow's time.
"""

import io
import json
import os
import struct
import subprocess
import sys
import time
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from apla_tpu_torch import native
from apla_tpu_torch.data import detection_data as tdd
from apla_tpu_torch.data.datasets import BaseSet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "png")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_png_fixtures as mk  # noqa: E402

sys.path.pop(0)


def _names():
    return sorted(n for n in os.listdir(FIXTURES) if n != "manifest.json")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def _pillow(data, raw=False):
    with warnings.catch_warnings():
        # palette transparency given in bytes: Pillow warns, and converts
        warnings.simplefilter("ignore", UserWarning)
        im = Image.open(io.BytesIO(data))
        return np.asarray(im) if raw else np.asarray(im.convert("RGB"))


def _sha(arr):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _three_way(data, name=""):
    """Native == Pillow == numpy, RGB and raw."""
    got = native.decode_png(data)
    np.testing.assert_array_equal(got, _pillow(data), err_msg=name)
    np.testing.assert_array_equal(tdd.decode_png(data, name), got,
                                  err_msg=name)
    raw, ref = native.decode_png(data, raw=True), _pillow(data, raw=True)
    assert raw.dtype == ref.dtype, name
    np.testing.assert_array_equal(raw.reshape(ref.shape), ref, err_msg=name)
    plain = tdd.decode_png(data, name, raw=True)
    assert plain.dtype == raw.dtype
    np.testing.assert_array_equal(plain, raw, err_msg=name)
    return got, raw


@pytest.mark.parametrize("name", _names())
def test_fixture_decodes_match_manifest_pillow_and_numpy(name):
    want = _manifest()["files"][name]
    got, raw = _three_way(_read(name), name)
    assert got.shape == (want["height"], want["width"], 3)
    assert _sha(got) == want["full"]
    assert list(raw.reshape(want["raw_shape"]).shape) == want["raw_shape"]
    canon = raw.astype(np.uint8) if raw.dtype == bool else raw
    assert raw.dtype.str == want["raw_dtype"] and _sha(canon) == want["raw"]
    path = os.path.join(FIXTURES, name)
    np.testing.assert_array_equal(tdd.read_image(path), got)
    np.testing.assert_array_equal(tdd.read_png(path, raw=True), raw)
    # the raw-mode sample at 224: the full decode, then BICUBIC
    ds = BaseSet.__new__(BaseSet)
    ds.raw_size = _manifest()["raw_size"]
    assert _sha(ds.load_raw({"img_path": path})) == want["raw224"]


def test_manifest_is_what_pillow_and_jax_compute_now():
    assert _manifest() == mk.manifest(FIXTURES)     # reads the JAX package
    for name, data in mk.fixtures().items():
        assert _read(name) == data, name
    assert sorted(mk.fixtures()) == _names()


def test_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(FIXTURES, n))
                for n in os.listdir(FIXTURES))
    assert total < 100_000, total


# every (bit depth, colour type) that PNG allows
FORMATS = sorted(native.PNG_MODES)


def _samples(h, w, depth, ctype, seed):
    rng = np.random.default_rng(seed)
    ch = native.PNG_CHANNELS[ctype]
    top = 1 << depth
    # ramps with noise: the filters see both runs and jumps
    y, x = np.mgrid[0:h, 0:w]
    base = ((x * 3 + y * 5)[..., None] * (np.arange(ch) + 1)) % top
    noise = rng.integers(0, top, (h, w, ch))
    pick = rng.random((h, w, 1)) < 0.3
    return np.where(pick, noise, base).astype(
        np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth,ctype", FORMATS)
def test_every_format_matches_pillow_and_numpy(depth, ctype, interlace):
    for k, (h, w, filters) in enumerate((
            (13, 17, (0, 1, 2, 3, 4)), (9, 3, "adaptive"), (1, 1, 4),
            (8, 8, (4, 3, 2, 1, 0)), (23, 5, 3))):
        s = _samples(h, w, depth, ctype, 100 * depth + 10 * ctype + k)
        palette = trns = None
        if ctype == 3:
            n = (1 << depth) - (k % 2) * ((1 << depth) // 2)
            palette = np.random.default_rng(k).integers(0, 256, (max(n, 1),
                                                                 3))
            trns = bytes(range(0, 200, 40))[:max(n, 1)] if k == 3 else None
        data = mk.encode_png(s, depth, ctype, palette=palette, trns=trns,
                             interlace=interlace, filters=filters,
                             idat_chunks=1 + k % 3)
        _three_way(data, f"{depth}-bit type {ctype} {h}x{w} {filters}")


def _rgb_png(**kw):
    return mk.encode_png(_samples(6, 7, 8, 2, 1), 8, 2, **kw)


REFUSED = {
    "not_png": (b"GIF89a" + bytes(40), "not a PNG"),
    "bad_crc": (lambda d: d[:29] + bytes([d[29] ^ 1]) + d[30:],
                "wrong CRC"),
    "cut_chunk": (lambda d: d[:-20], "cut short"),
    "bad_filter": (lambda d: _refilter(d, 5), "filter type"),
    "ends_early": (lambda d: _recompress(d, lambda raw: raw[:-9]),
                   "ends early"),
    "not_zlib": (lambda d: _recompress(d, None), "does not inflate"),
    "bad_depth": (lambda d: _reheader(d, depth=16, ctype=3),
                  "bit depth 16 with colour type 3"),
    "no_plte": (lambda d: _reheader(d, ctype=3), "PLTE"),
    "no_idat": (lambda d: d[:33] + mk._chunk(b"IEND", b""), "no IDAT"),
    "ihdr_not_first": (lambda d: d[:8] + mk._chunk(b"tEXt", b"a\0b")
                       + d[8:], "first chunk"),
    "interlace_2": (lambda d: _reheader(d, interlace=2), "interlace"),
    "zero_width": (lambda d: _reheader(d, width=0), "0 x"),
}


def _ihdr(d):
    return list(struct.unpack(">IIBBBBB", d[16:29]))


def _reheader(d, width=None, depth=None, ctype=None, interlace=None):
    w, h, dep, ct, m, f, il = _ihdr(d)
    body = struct.pack(">IIBBBBB", w if width is None else width, h,
                       dep if depth is None else depth,
                       ct if ctype is None else ctype, m, f,
                       il if interlace is None else interlace)
    return d[:8] + mk._chunk(b"IHDR", body) + d[33:]


def _idat(d):
    at = d.index(b"IDAT") - 4
    n = int.from_bytes(d[at:at + 4], "big")
    return at, n


def _recompress(d, edit):
    at, n = _idat(d)
    raw = zlib.decompress(d[at + 8:at + 8 + n])
    body = zlib.compress(edit(raw)) if edit else b"\x00\x01" + raw[:40]
    return d[:at] + mk._chunk(b"IDAT", body) + d[at + 12 + n:]


def _refilter(d, kind):
    return _recompress(d, lambda raw: bytes([kind]) + raw[1:])


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_streams_raise(tmp_path, case):
    edit, match = REFUSED[case]
    data = edit(_rgb_png()) if callable(edit) else edit
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    if case == "not_png":
        with pytest.raises(native.PngError, match=match):
            native.decode_png(data)
        for read in (tdd.read_png, lambda p: tdd.decode_png(
                open(p, "rb").read(), p)):
            with pytest.raises(NotImplementedError, match="x.png"):
                read(path)
        # `read_image` goes by the content: a GIF signature with no image
        with pytest.raises(ValueError, match="x.png: GIF stream"):
            tdd.read_image(path)
        return
    with pytest.raises(native.PngError, match=match):
        native.decode_png(data)
    for read in (tdd.read_png, tdd.read_image, lambda p: tdd.decode_png(
            open(p, "rb").read(), p)):
        with pytest.raises(ValueError, match="x.png"):
            read(path)


def test_native_refusals_do_not_fall_back():
    """A stream the C++ refuses raises even where the numpy version would
    read it: the library's own checks (a filter type past 4 behind a
    chunk reader that lets it through)."""
    data = _refilter(_rgb_png(), 7)
    with pytest.raises(native.PngError, match="filter type past 4"):
        native.decode_png(data)
    with pytest.raises(ValueError, match="filter type"):
        tdd.decode_png(data, "x.png")


@pytest.mark.parametrize("name", ["rgb8_pillow.png", "p4_adam7.png",
                                  "grey16_adam7_trns.png", "la16_adam7.png"])
def test_mutated_streams_decode_or_raise(name):
    """Bytes of a fixture changed at seeded places past its IHDR (so no
    size grows), CRCs fixed up so the changes reach the decoder: every
    decode returns an image of the header's size or raises PngError."""
    data = _read(name)
    h, w = _ihdr(data)[1], _ihdr(data)[0]
    rng = np.random.default_rng(len(data))
    at, n = _idat(data)
    raw = zlib.decompress(data[at + 8:at + 8 + n])
    decoded = 0
    for trial in range(60):
        bad = bytearray(raw)
        for i in rng.choice(len(raw), 1 + trial % 5, replace=False):
            bad[i] = int(rng.integers(0, 256))
        bad = bytes(bad[:len(bad) - (trial % 7 == 6) * 17])
        stream = data[:at] + mk._chunk(b"IDAT", zlib.compress(bad)) \
            + data[at + 12 + n:]
        try:
            assert native.decode_png(stream).shape == (h, w, 3)
            native.decode_png(stream, raw=True)
            decoded += 1
        except native.PngError:
            pass
    assert decoded > 0


def test_build_failures_raise(tmp_path, monkeypatch):
    """No g++, or a compile that fails: the build raises (no fallback)."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_library("png_dec.cpp")
    monkeypatch.undo()
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library("png_dec.cpp")
    assert not any(tmp_path.rglob("*.so"))


def test_source_builds_without_warnings(tmp_path):
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-Wall", "-Wextra",
         os.path.join(os.path.dirname(native.__file__), "png_dec.cpp"),
         "-o", str(tmp_path / "x.so")], capture_output=True, text=True)
    assert proc.returncode == 0 and proc.stderr == "", proc.stderr


def test_decode_time_within_3x_of_pillow():
    """224 x 224 RGB, the recipes' size: best of several runs each."""
    data = _read("rgb_224.png")
    native.decode_png(data)                     # built and loaded

    def best(fn, n=30):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return min(times)
    ours = best(lambda: native.decode_png(data))
    pil = best(lambda: np.asarray(Image.open(io.BytesIO(data)).convert(
        "RGB")))
    assert ours < 3 * pil, (ours, pil)
