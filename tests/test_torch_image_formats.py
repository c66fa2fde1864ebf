"""The port's BMP, GIF and TIFF decoders (`native/{bmp,gif,tiff}_dec.cpp`,
`native/formats.py`, their plain numpy versions in
`data/image_formats.py`) against Pillow 12.1 and the JAX package.

- Every fixture under `tests/data/{bmp,gif,tiff}` (written by
  `tools/make_image_fixtures.py`): the native decode and the plain one in
  Pillow's open mode, then `convert` to RGB, L and RGBA, each sha256 equal
  to the manifest's (Pillow's `Image.open(...).convert(mode)`); the JAX
  package's raw mode at 224 (`raw224`) through the port's `BaseSet`;
  `read_image` of each under a `.jpg` name.
- The manifests are what Pillow and the JAX package compute now.
- The streams the decoders refuse (JPEG-in-TIFF, CCITT, LogLuv, YCbCr,
  CMYK) raise `Unsupported` naming the tag and citing ROADMAP A 5, and
  `read_image` NotImplementedError; content of no format raises so too.
- Truncated and corrupt streams: seeded mutations of every fixture (bytes
  set or flipped, the stream cut) decode or raise ValueError in both arms,
  never crash, and where both decode they agree.  (`tools/fuzz_image_dec.py`
  runs the same under ASan and UBSan.)
"""

import hashlib
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

from apla_tpu_torch.data import datasets as tdata
from apla_tpu_torch.data import detection_data as tdd
from apla_tpu_torch.data import image_formats as imf
from apla_tpu_torch.native import formats as nf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
KINDS = ("bmp", "gif", "tiff")


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _manifest(kind):
    with open(os.path.join(DATA, kind, "manifest.json")) as f:
        return json.load(f)["files"]


def _cases(refused=False):
    return [(k, n) for k in KINDS for n, rec in sorted(_manifest(k).items())
            if ("refused" in rec) == refused]


def _read(kind, name):
    with open(os.path.join(DATA, kind, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind,name", _cases(),
                         ids=[f"{k}/{n}" for k, n in _cases()])
def test_fixture_decodes_to_pillows_bits(kind, name):
    rec = _manifest(kind)[name]
    data = _read(kind, name)
    native = imf.open_image(data)
    plain = imf.open_image(data, native_ops=False)
    assert native.mode == plain.mode == rec["mode"]
    np.testing.assert_array_equal(native.px, plain.px)
    assert native.px.shape[:2] == (rec["height"], rec["width"])
    for key, mode in (("rgb", "RGB"), ("l", "L"), ("rgba", "RGBA")):
        assert _sha(imf.convert(native, mode)) == rec[key], mode
        assert _sha(imf.decode_image(data, mode)) == rec[key], mode


@pytest.mark.parametrize("kind", KINDS)
def test_raw224_and_any_name(kind, tmp_path):
    """The JAX package's raw mode at 224 through the port's `BaseSet`, on
    each fixture under a `.jpg` name (the reader goes by the content)."""
    ds = tdata.BaseSet.__new__(tdata.BaseSet)
    ds.raw_mode, ds.raw_size, ds.img_channels = True, 224, 3
    for name, rec in _manifest(kind).items():
        if "refused" in rec:
            continue
        path = tmp_path / (name.rsplit(".", 1)[0] + ".jpg")
        shutil.copy(os.path.join(DATA, kind, name), path)
        got = ds.load_raw({"img_path": str(path), "label": 0})
        assert _sha(got) == rec["raw224"], name
        assert _sha(tdd.read_image(str(path))) == rec["rgb"], name


def test_manifests_are_what_pillow_and_jax_compute_now():
    spec = importlib.util.spec_from_file_location(
        "make_image_fixtures", os.path.join(ROOT, "tools",
                                            "make_image_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for kind, make in tool.FIXTURES.items():
        want = make()
        d = os.path.join(DATA, kind)
        assert sorted(os.listdir(d)) == sorted([*want, "manifest.json"])
        for name, data in want.items():
            assert _read(kind, name) == data, name
        assert _manifest(kind) == tool.manifest(d)["files"]


@pytest.mark.parametrize("kind,name", _cases(refused=True),
                         ids=[n for _, n in _cases(refused=True)])
def test_refused_streams_cite_a5(kind, name, tmp_path):
    rec = _manifest(kind)[name]["refused"]
    data = _read(kind, name)
    for native_ops in (True, False):
        with pytest.raises(nf.Unsupported, match="ROADMAP A 5") as e:
            imf.open_image(data, native_ops)
        assert f"compression {rec['compression']}" in str(e.value) or \
            f"photometric {rec['photometric']}" in str(e.value)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match="x.jpg.*ROADMAP A 5"):
        tdd.read_image(str(path))


def test_other_content_cites_a5(tmp_path):
    path = tmp_path / "y.JPEG"
    path.write_bytes(b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(40))
    with pytest.raises(NotImplementedError, match="y.JPEG.*ROADMAP A 5"):
        tdd.read_image(str(path))
    assert "PIL-free transforms" in tdd.FORMATS_TODO


def _mutations(data, rng, n):
    for _ in range(n):
        d = bytearray(data)
        kind = rng.integers(0, 3)
        if kind == 0:
            d = d[:int(rng.integers(8, len(d)))]
        for _ in range(int(rng.integers(1, 7))):
            i = int(rng.integers(0, len(d)))
            if kind == 1:
                d[i] = int(rng.integers(0, 256))
            else:
                d[i] ^= 1 << int(rng.integers(0, 8))
        yield bytes(d)


@pytest.mark.parametrize("kind", KINDS)
def test_mutated_streams_decode_or_raise(kind):
    rng = np.random.default_rng(["bmp", "gif", "tiff"].index(kind))
    decoded = refused = 0
    for name, rec in _manifest(kind).items():
        if "refused" in rec or "_224" in name or "table_full" in name:
            continue
        for d in _mutations(_read(kind, name), rng, 12):
            got = []
            for native_ops in (True, False):
                try:
                    got.append(imf.open_image(d, native_ops))
                except ValueError:
                    got.append(None)
            if got[0] is None or got[1] is None:
                assert got[0] is None and got[1] is None, name
                refused += 1
                continue
            decoded += 1
            assert got[0].mode == got[1].mode
            np.testing.assert_array_equal(got[0].px, got[1].px, err_msg=name)
    assert decoded and refused
