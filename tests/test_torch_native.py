"""The port's host image ops and JPEG decoder (`apla_tpu_torch.native`)
against the JAX package's (`apla_tpu.native`: the same C++ image ops, and
libjpeg through ctypes) and Pillow.

- The four image ops on seeded arrays: bit-equal to the JAX package's, and
  their plain numpy versions bit-equal too; Pillow's resample and HSV
  round trip, bit-equal to Pillow and to their numpy versions.
- The committed fixtures (`tests/data/jpeg/`, written by
  `tools/make_jpeg_fixtures.py`): the full-size decode bit-equal to
  Pillow's `convert("RGB")` and to the JAX package's native decode, the
  raw decode at 256 bit-equal to the JAX package's; the manifest equals
  what the JAX package computes now.
- JPEGs written here with Pillow at several sizes, qualities, samplings,
  progressive or not and with restart markers: the DCT-scaled decode at
  every scale 1/8 .. 8/8 (the targets pick each one) bit-equal to the JAX
  package's libjpeg decode, the full decode to Pillow's.
- Failures raise: a stream that is not a JPEG, a truncated header, no g++,
  a failed compile.
"""

import ctypes
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from apla_tpu import native as jnative
from apla_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _fixture_names():
    return sorted(n for n in os.listdir(FIXTURES) if n != "manifest.json")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("shape,out", [((37, 53, 3), (20, 70)),
                                       ((256, 256, 3), (224, 224)),
                                       ((9, 5, 3), (31, 17))])
def test_image_ops_match_jax_and_numpy(shape, out):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    want = jnative.resize_bilinear(img, *out)
    np.testing.assert_array_equal(native.resize_bilinear(img, *out), want)
    np.testing.assert_array_equal(native.resize_bilinear_reference(img, *out),
                                  want)
    want = jnative.normalize(img, MEAN, STD)
    np.testing.assert_array_equal(native.normalize(img, MEAN, STD), want)
    np.testing.assert_array_equal(native.normalize_reference(img, MEAN, STD),
                                  want)
    want = jnative.hflip(img)
    np.testing.assert_array_equal(native.hflip(img), want)
    np.testing.assert_array_equal(native.hflip_reference(img), want)
    h, w = shape[:2]
    box = (h // 5, w // 7, h - h // 5 - 1, w - w // 7 - 2)
    want = jnative.crop_resize_normalize(img, box, *out, MEAN, STD)
    np.testing.assert_array_equal(
        native.crop_resize_normalize(img, box, *out, MEAN, STD), want)
    np.testing.assert_array_equal(
        native.crop_resize_normalize_reference(img, box, *out, MEAN, STD),
        want)


@pytest.mark.parametrize("hw,out", [((375, 500), (256, 256)),
                                    ((256, 256), (224, 224)),
                                    ((30, 40), (61, 17)), ((9, 9), (9, 20)),
                                    ((100, 3), (7, 200))])
def test_pillow_resample_and_hue_match_numpy_and_pillow(hw, out):
    """The C++ copies of Pillow's arithmetic that the JAX package gets
    from Pillow: `resample` (BILINEAR, BICUBIC) and the HSV round trip
    of `hue_shift`, against their numpy versions and Pillow."""
    from apla_tpu_torch.data import detection_data as tdd
    from apla_tpu_torch.data import transforms as tt
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,),
                                                dtype=np.uint8)
    for name, flt in (("bilinear", Image.BILINEAR),
                      ("bicubic", Image.BICUBIC)):
        got = native.resample(img, *out, name)
        np.testing.assert_array_equal(
            got, tdd.resize_reference(img, out[1], out[0], name))
        np.testing.assert_array_equal(got, np.asarray(
            Image.fromarray(img).resize((out[1], out[0]), flt)))
    for shift in (-0.1, 0.0, 0.037, 0.5):
        np.testing.assert_array_equal(tt.hue_shift(img, shift),
                                      tt.hue_shift_reference(img, shift))


@pytest.mark.parametrize("name", _fixture_names())
def test_fixture_decodes_match_pillow_and_jax(name):
    data = _read(name)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    if data[:2] != b"\xff\xd8":          # the PNG under a JPEG name
        with pytest.raises(native.JpegError, match="not a JPEG"):
            native.decode_jpeg(data)
        assert jnative.decode_jpeg(data, out_size=256) is None
        return
    full = native.decode_jpeg(data)
    np.testing.assert_array_equal(full, pil)
    ref_full = jnative.decode_jpeg(data)
    ref_raw = jnative.decode_jpeg(data, out_size=256)
    kind = native.jpeg_info(data)["kind"]
    if kind in (native.GRAY, native.YCBCR, native.RGB):
        np.testing.assert_array_equal(full, ref_full)
        np.testing.assert_array_equal(native.decode_jpeg_resize(data, 256,
                                                                256), ref_raw)
    else:                               # CMYK: libjpeg's RGB output refuses
        assert ref_full is None and ref_raw is None
        with pytest.raises(native.CmykJpeg):
            native.decode_jpeg_resize(data, 256, 256)


def test_manifest_is_what_jax_computes_now():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import make_jpeg_fixtures
    finally:
        sys.path.pop(0)
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        assert json.load(f) == make_jpeg_fixtures.manifest(FIXTURES)
    # the committed files are the ones the script writes
    for name, data in make_jpeg_fixtures.fixtures().items():
        assert _read(name) == data, name


def _jax_decode_resize(data, th, tw):
    """The JAX package's native `jpeg_decode_resize` at a [th, tw] target
    (its Python wrapper takes square targets only)."""
    out = np.empty((th, tw, 3), np.uint8)
    gh, gw = ctypes.c_int(), ctypes.c_int()
    buf = np.frombuffer(data, np.uint8)
    rc = jnative._load_jpeg().jpeg_decode_resize(
        buf, buf.size, th, tw, out, out.size, ctypes.byref(gh),
        ctypes.byref(gw))
    assert rc == 0
    return out


def _content(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x * 7 + y * 3) % 256], -1).astype(np.float32)
    return np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("h,w,kw", [
    (64, 64, dict(quality=95, subsampling=0)),
    (64, 64, dict(quality=40, subsampling=1)),
    (64, 64, dict(quality=75, subsampling=2)),
    (64, 64, dict(quality=75, subsampling=2, progressive=True)),
    (64, 64, dict(quality=60, subsampling=1, progressive=True)),
    (61, 67, dict(quality=85, subsampling=2, restart_marker_blocks=3)),
    (61, 67, dict(quality=85, subsampling=0, progressive=True,
                  restart_marker_rows=1)),
    (3, 2, dict(quality=90, subsampling=2)),
])
def test_pillow_written_jpegs_at_every_scale(h, w, kw):
    buf = io.BytesIO()
    Image.fromarray(_content(h, w, h * w)).save(buf, "JPEG", **kw)
    data = buf.getvalue()
    np.testing.assert_array_equal(
        native.decode_jpeg(data),
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    # a target of num/8 of the size picks DCT scale num/8 (an odd 1 px
    # more keeps the output resized)
    for num in range(1, 9):
        th, tw = max(1, h * num // 8), max(1, w * num // 8) + (num % 2)
        np.testing.assert_array_equal(native.decode_jpeg_resize(data, th, tw),
                                      _jax_decode_resize(data, th, tw),
                                      err_msg=f"num {num}")
        side = max(1, min(h, w) * num // 8)
        np.testing.assert_array_equal(
            native.decode_jpeg_resize(data, side, side),
            jnative.decode_jpeg(data, out_size=side), err_msg=f"num {num}")


def test_grey_jpeg_expands_to_rgb():
    buf = io.BytesIO()
    Image.fromarray(_content(40, 30, 1)[..., 0]).save(buf, "JPEG")
    data = buf.getvalue()
    got = native.decode_jpeg(data)
    assert got.shape == (40, 30, 3)
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    np.testing.assert_array_equal(native.decode_jpeg_resize(data, 24, 24),
                                  jnative.decode_jpeg(data, out_size=24))


def test_undecodable_streams_raise():
    with pytest.raises(native.JpegError, match="not a JPEG"):
        native.decode_jpeg(b"GIF89a" + bytes(20))
    with pytest.raises(native.JpegError):
        native.decode_jpeg(b"\xff\xd8\xff\xc0\x00\x11\x08")
    data = _read("s420.jpg")
    with pytest.raises(native.JpegError):
        native.decode_jpeg(data[:200])        # no scan data at all


def _segments(data):
    """(marker, start, end) of each marker segment before the first scan's
    entropy-coded data."""
    out, pos = [], 2
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, pos, end))
        if marker == 0xDA:
            return out
        pos = end


def _dht(cls_id, counts, symbols):
    body = bytes([cls_id]) + bytes(counts) + bytes(symbols)
    return b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body


def _counts(**at):
    """16 code counts, `l<n>=count` for the lengths given."""
    return [at.get(f"l{n}", 0) for n in range(1, 17)]


@pytest.mark.parametrize("table", [
    pytest.param(_dht(0x00, _counts(l1=3), [0, 1, 2]), id="three-1-bit"),
    pytest.param(_dht(0x00, _counts(l1=255), range(255)), id="255-1-bit"),
    pytest.param(_dht(0x10, _counts(l1=1, l2=2), [0, 1, 2]),
                 id="all-ones-2-bit"),
    pytest.param(_dht(0x10, _counts(l4=16), range(16)), id="run-past-4-bits"),
    # one code at each length 1-9, then two of 10 bits: past the 9-bit
    # lookup, in the slow search's lengths
    pytest.param(_dht(0x10, _counts(**{f"l{n}": 1 for n in range(1, 10)},
                                    l10=2), range(11)),
                 id="run-past-10-bits"),
    pytest.param(_dht(0x00, _counts(l2=3), [0, 1, 16]), id="dc-symbol-16"),
])
def test_bad_huffman_tables_raise(table):
    """libjpeg's table checks (jdhuff.c `jpeg_make_d_derived_tbl`): a table
    whose codes of a length do not fit in it, and a DC table with a
    symbol past 15, raise when a scan uses them, before any lookup is
    filled; a header read that only defines them reads the frame."""
    data = _read("s420.jpg")
    sos = [s for s in _segments(data) if s[0] == 0xDA][0][1]
    # the bad table replaces DC table 0 (AC table 0) just before the scan
    bad = data[:sos] + table + data[sos:]
    with pytest.raises(native.JpegError, match="bad Huffman table"):
        native.decode_jpeg(bad)
    with pytest.raises(native.JpegError, match="bad Huffman table"):
        native.decode_jpeg_resize(bad, 32, 32)
    # read before the frame header, then replaced by the file's own tables
    early = data[:2] + table + data[2:]
    assert native.jpeg_info(early)["width"] == native.jpeg_info(data)["width"]
    np.testing.assert_array_equal(native.decode_jpeg(early),
                                  native.decode_jpeg(data))


@pytest.mark.parametrize("edit,match", [
    (lambda d, s: d[:s[1] + 2] + b"\x00\x01" + d[s[1] + 4:], "length"),
    (lambda d, s: d[:s[1] + 2] + b"\x00\x00" + d[s[1] + 4:], "length"),
    (lambda d, s: d[:s[2] - 1], None),
], ids=["length-1", "length-0", "cut-off"])
def test_bad_segment_lengths_raise(edit, match):
    """A DHT, DQT or SOS segment whose length is too short or that the
    stream cuts off raises (libjpeg's JERR_BAD_LENGTH)."""
    data = _read("s420.jpg")
    for seg in _segments(data):
        if seg[0] in (0xC4, 0xDB, 0xDA, 0xC0):
            with pytest.raises(native.JpegError, match=match):
                native.decode_jpeg(edit(data, seg))


@pytest.mark.parametrize("name", ["s420.jpg", "s422.jpg", "progressive.jpg",
                                  "restart.jpg", "grey.jpg", "cmyk.jpg"])
def test_mutated_streams_decode_or_raise(name):
    """Bytes of a fixture changed at seeded places (the frame header
    kept, so that no size grows): every decode either returns an image of
    the frame's size or raises JpegError."""
    data = _read(name)
    sof = [s for s in _segments(data) if s[0] in (0xC0, 0xC1, 0xC2)][0]
    where = np.array([i for i in range(2, len(data))
                      if not sof[1] <= i < sof[2]])
    rng = np.random.default_rng(len(data))
    h, w = native.jpeg_info(data)["height"], native.jpeg_info(data)["width"]
    decoded = 0
    for trial in range(40):
        bad = bytearray(data)
        for i in rng.choice(where, 1 + trial % 4, replace=False):
            bad[i] = int(rng.integers(0, 256))
        bad = bytes(bad)
        try:
            assert native.decode_jpeg(bad).shape == (h, w, 3)
            decoded += 1
        except native.JpegError:
            pass
        try:
            assert native.decode_jpeg_resize(bad, 24, 20).shape == (24, 20, 3)
        except native.JpegError:
            pass
    assert decoded > 0           # most changes land in the scan data


def test_build_failures_raise(tmp_path, monkeypatch):
    """No g++, or a compile that fails: the build raises (no fallback)."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_library("image_ops.cpp")
    monkeypatch.undo()
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-DNOT_A_FLAG=", "-fno-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library("image_ops.cpp")
    assert not any(tmp_path.rglob("*.so"))


def test_sources_build_without_warnings(tmp_path):
    for src in ("image_ops.cpp", "jpeg_dec.cpp"):
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-Wall", "-Wextra",
             os.path.join(os.path.dirname(native.__file__), src), "-o",
             str(tmp_path / "x.so")], capture_output=True, text=True)
        assert proc.returncode == 0 and proc.stderr == "", proc.stderr
