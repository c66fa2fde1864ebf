"""Host image ops of the input pipeline, in C++ built at first use.

The port's own copies of the JAX package's host kernels
(`apla_tpu/native/`): `image_ops.cpp` (bilinear resize, the fused crop ->
resize -> normalise, normalise, horizontal flip; and, where the JAX
package calls Pillow, Pillow's BILINEAR / BICUBIC resample and its RGB ->
HSV -> RGB round trip) and `jpeg_dec.cpp`, a
JPEG decoder of its own that gives libjpeg-turbo's bits (the card's machine
has no libjpeg): the full-size decode that Pillow's `Image.open(...)
.convert("RGB")` gives, and the DCT-scaled decode + bilinear resize of the
JAX package's `decode_jpeg(data, out_size)`; and `png_dec.cpp`, the
scanline half of a PNG decoder (filters, Adam7, every depth and colour
type, Pillow's conversions) behind `png_stream`'s chunk reading and
Python's zlib.

A library is built with `g++ -O3 -shared -fPIC -ffp-contract=off` (no
fused multiply-add on any host: the plain versions' arithmetic, operation
for operation) at its first call, never at
import, into `apla_tpu_torch/_build/<hash>/` (gitignored), keyed by a hash
of the source, the shared header and the flags.  A failed build or load
raises, and so does a file the decoder refuses: nothing falls back to
another implementation.  The ctypes calls release the GIL.

Each image op has its plain numpy version beside it (`*_reference`), the
same float32 arithmetic in the same order, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_ROOT = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
HEADERS = ("bilinear_u8.h", "formats_common.h")

# jpeg_probe's colour kinds; the first three are what libjpeg's RGB output
# takes (the JAX package's native decode), the last two go through Pillow
# there and through Pillow's conversion here
GRAY, YCBCR, RGB, CMYK, YCCK = range(5)


def library_path(source: str) -> Path:
    """Where the library for `native/<source>` lives once built."""
    h = hashlib.sha256((_HERE / source).read_bytes())
    for header in HEADERS:
        h.update((_HERE / header).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / (Path(source).stem + ".so")


def build_library(source: str) -> Path:
    """Compile `native/<source>` unless a build of this exact source
    exists; raises if there is no g++ or the compile fails."""
    out = library_path(source)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build the host "
                           f"image library {source}")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(_HERE / source), "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {source}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent builder never sees half
    return out


_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def image_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("image_ops.cpp")))
    lib.resize_bilinear_u8.argtypes = [_U8P, _I, _I, _I, _U8P, _I, _I]
    lib.crop_resize_normalize.argtypes = [_U8P, _I, _I, _I, _I, _I, _I, _I,
                                          _F32P, _I, _I, _F32P, _F32P]
    lib.normalize_u8.argtypes = [_U8P, _I, _I, _F32P, _F32P, _F32P]
    lib.hflip_u8.argtypes = [_U8P, _I, _I, _I]
    lib.resample_u8.argtypes = [_U8P, _I, _I, _I, _U8P, _I, _I, _I]
    lib.hue_shift_u8.argtypes = [_U8P, ctypes.c_long, _I]
    lib.gaussian_blur_u8.argtypes = [_U8P, _I, _I, _I, ctypes.c_float]
    lib.enhance_u8.argtypes = [_U8P, _U8P, ctypes.c_long, _I, ctypes.c_float]
    lib.transform_bilinear_u8.argtypes = [
        _U8P, _I, _I, _I, _U8P,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), _I]
    return lib


@functools.cache
def png_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("png_dec.cpp")))
    lib.png_error_message.restype = ctypes.c_char_p
    lib.png_decode.argtypes = [_U8P, ctypes.c_long, _I, _I, _I, _I, _I,
                               _U8P, _I, _I, ctypes.c_void_p, ctypes.c_long]
    lib.png_decode.restype = ctypes.c_int
    return lib


@functools.cache
def jpeg_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("jpeg_dec.cpp")))
    lib.jpeg_error_message.restype = ctypes.c_char_p
    lib.jpeg_probe.argtypes = [_U8P, ctypes.c_long, _IP, _IP, _IP, _IP, _IP]
    lib.jpeg_decode.argtypes = [_U8P, ctypes.c_long, _I, _U8P, ctypes.c_long,
                                _IP, _IP]
    lib.jpeg_decode_resize.argtypes = [_U8P, ctypes.c_long, _I, _I, _U8P,
                                       ctypes.c_long, _IP, _IP]
    for fn in (lib.jpeg_probe, lib.jpeg_decode, lib.jpeg_decode_resize):
        fn.restype = ctypes.c_int
    return lib


def _f32(v) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(v, np.float32))


def _hwc(img) -> tuple[np.ndarray, bool]:
    """uint8 HWC, or [H, W] (one band, Pillow's L) viewed as [H, W, 1]:
    -> (contiguous HWC, whether the input was 2-D)."""
    img = np.ascontiguousarray(img, np.uint8)
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def _band(out: np.ndarray, flat: bool) -> np.ndarray:
    return out[..., 0] if flat else out


# --------------------------------------------------------------------------- #
# image ops
# --------------------------------------------------------------------------- #

def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 HWC -> uint8 [dh, dw, C] (half-pixel centres, edge clamp)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    image_lib().resize_bilinear_u8(img, h, w, c, out, dh, dw)
    return out


def crop_resize_normalize(img: np.ndarray, box, dh: int, dw: int, mean,
                          std) -> np.ndarray:
    """Crop box (y, x, h, w) of uint8 HWC, bilinear to [dh, dw], then
    (v / 255 - mean) / std -> float32 HWC, in one pass."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    cy, cx, ch, cw = (int(v) for v in box)
    out = np.empty((dh, dw, c), np.float32)
    image_lib().crop_resize_normalize(img, h, w, c, cy, cx, ch, cw, out, dh,
                                      dw, _f32(mean), _f32(std))
    return out


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 HWC -> float32 HWC, (v / 255 - mean) / std."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((h, w, c), np.float32)
    image_lib().normalize_u8(img, h * w, c, _f32(mean), _f32(std), out)
    return out


def hflip(img: np.ndarray) -> np.ndarray:
    """uint8 HWC mirrored left-right (a new array)."""
    img = np.array(img, np.uint8, order="C", copy=True)
    h, w, c = img.shape
    image_lib().hflip_u8(img, h, w, c)
    return img


def resample(img: np.ndarray, dh: int, dw: int,
             filter: str = "bilinear") -> np.ndarray:
    """Pillow's `Image.resize((dw, dh), BILINEAR | BICUBIC)` on uint8 HWC
    or [H, W] (`filter` "bilinear" or "bicubic"); its plain numpy version is
    `data.detection_data.resize_reference`."""
    if filter not in ("bilinear", "bicubic"):
        raise ValueError(f"filter {filter!r}: 'bilinear' or 'bicubic'")
    img, flat = _hwc(img)
    h, w, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    image_lib().resample_u8(img, h, w, c, out, dh, dw,
                            int(filter == "bicubic"))
    return _band(out, flat)


def hue_shift(img: np.ndarray, shift: int) -> np.ndarray:
    """uint8 RGB HWC through Pillow's HSV, the hue byte moved by `shift`
    modulo 256, and back to RGB (a new array); its plain numpy version is
    `data.transforms.hue_shift_reference`."""
    out = np.array(img, np.uint8, order="C", copy=True)
    image_lib().hue_shift_u8(out, out.size // 3, int(shift))
    return out


ENHANCE_KINDS = ("brightness", "contrast", "color")


def enhance(img: np.ndarray, kind: str, factor: float) -> np.ndarray:
    """Pillow's `ImageEnhance.Brightness | Contrast | Color(img)
    .enhance(factor)` on uint8 RGB HWC (`kind` "brightness", "contrast"
    or "color"); its plain numpy version is
    `data.transforms.enhance_reference`."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"enhance takes uint8 RGB HWC, not {img.dtype} "
                         f"{img.shape}")
    img = np.ascontiguousarray(img)
    out = np.empty_like(img)
    image_lib().enhance_u8(img, out, img.size // 3, ENHANCE_KINDS.index(kind),
                           float(np.float32(factor)))
    return out


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """Pillow's `img.filter(ImageFilter.GaussianBlur(radius))` on uint8 HWC
    or [H, W] (a new array); its plain numpy version is
    `data.transforms.gaussian_blur_reference`."""
    img, flat = _hwc(img)
    out = img.copy()
    h, w, c = out.shape
    image_lib().gaussian_blur_u8(out, h, w, c, float(radius))
    return _band(out, flat)


def transform_bilinear(img: np.ndarray, coeffs,
                       perspective: bool = False) -> np.ndarray:
    """Pillow's `img.transform(img.size, AFFINE | PERSPECTIVE, coeffs,
    BILINEAR)` on uint8 HWC or [H, W]: `coeffs` the 6 (affine) or 8
    (perspective)
    output -> input coefficients; its plain numpy version is
    `data.transforms.transform_bilinear_reference`."""
    img, flat = _hwc(img)
    h, w, c = img.shape
    a = np.zeros(8, np.float64)
    n = 8 if perspective else 6
    a[:n] = [float(v) for v in list(coeffs)[:n]]
    out = np.empty_like(img)
    image_lib().transform_bilinear_u8(img, h, w, c, out, a, int(perspective))
    return _band(out, flat)


# The plain numpy versions: the C++'s float32 operations, one at a time
# and in its order (built with -ffp-contract=off: no multiply-add is
# fused).

def _bilinear_taps(n_in: int, n_out: int, scale, offset: int = 0):
    f = np.float32
    pos = (np.arange(n_out, dtype=f) + f(0.5)) * f(scale) - f(0.5) + f(offset)
    i0 = np.floor(pos).astype(np.int64)
    wgt = (pos - i0.astype(f)).astype(f)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return np.clip(i0, 0, n_in - 1), i1, wgt


def _bilinear_f32(img, ys, xs):
    y0, y1, wy = ys
    x0, x1, wx = xs
    f = np.float32
    src = img.astype(f)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top = src[y0][:, x0] * (f(1) - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (f(1) - wx) + src[y1][:, x1] * wx
    return top * (f(1) - wy) + bot * wy


def resize_bilinear_reference(img: np.ndarray, dh: int, dw: int):
    h, w = img.shape[:2]
    f = np.float32
    v = _bilinear_f32(img, _bilinear_taps(h, dh, f(h) / f(dh)),
                      _bilinear_taps(w, dw, f(w) / f(dw)))
    return np.minimum(np.maximum(v + f(0.5), f(0)), f(255)).astype(np.uint8)


def _norm_consts(mean, std):
    f = np.float32
    return _f32(mean) * f(255), f(1) / (f(255) * _f32(std))


def crop_resize_normalize_reference(img, box, dh, dw, mean, std):
    h, w = img.shape[:2]
    cy, cx, ch, cw = (int(v) for v in box)
    f = np.float32
    v = _bilinear_f32(img, _bilinear_taps(h, dh, f(ch) / f(dh), cy),
                      _bilinear_taps(w, dw, f(cw) / f(dw), cx))
    m255, inv = _norm_consts(mean, std)
    return (v - m255) * inv


def normalize_reference(img, mean, std):
    m255, inv = _norm_consts(mean, std)
    return (img.astype(np.float32) - m255) * inv


def hflip_reference(img):
    return np.ascontiguousarray(img[:, ::-1])


# --------------------------------------------------------------------------- #
# JPEG
# --------------------------------------------------------------------------- #

class JpegError(ValueError):
    """A stream the decoder refuses or cannot read."""


class CmykJpeg(JpegError):
    """A CMYK or YCCK stream given to `decode_jpeg_resize`: libjpeg's RGB
    output refuses those, so the JAX package's DCT-scaled decode does not
    take them (it reads them with Pillow); `decode_jpeg` does."""


def _buf(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


def _check(rc: int) -> None:
    if rc != 0:
        msg = jpeg_lib().jpeg_error_message().decode()
        raise (CmykJpeg if rc == 2 else JpegError)(msg)


def jpeg_info(data: bytes) -> dict:
    """The frame header: height, width, components, the colour kind
    (`GRAY` .. `YCCK`) and whether the frame is progressive."""
    v = [ctypes.c_int() for _ in range(5)]
    buf = _buf(data)
    _check(jpeg_lib().jpeg_probe(buf, buf.size, *(ctypes.byref(x) for x in v)))
    h, w, comps, kind, prog = (x.value for x in v)
    return {"height": h, "width": w, "components": comps, "kind": kind,
            "progressive": bool(prog)}


def decode_jpeg(data: bytes, scale_num: int = 8) -> np.ndarray:
    """A JPEG stream -> RGB uint8 HWC at scale `scale_num`/8 (8: full
    size, Pillow's `Image.open(...).convert("RGB")` bits)."""
    info = jpeg_info(data)
    oh = -(-info["height"] * scale_num // 8)
    ow = -(-info["width"] * scale_num // 8)
    out = np.empty((oh, ow, 3), np.uint8)
    gh, gw = ctypes.c_int(), ctypes.c_int()
    buf = _buf(data)
    _check(jpeg_lib().jpeg_decode(buf, buf.size, int(scale_num), out,
                                  out.size, ctypes.byref(gh),
                                  ctypes.byref(gw)))
    return out


def decode_jpeg_resize(data: bytes, height: int, width: int) -> np.ndarray:
    """A JPEG stream -> RGB uint8 [height, width, 3]: the JAX package's
    `decode_jpeg(data, out_size)` (the smallest DCT scale that covers the
    target, then the bilinear resize); raises `CmykJpeg` for the CMYK and
    YCCK streams that it leaves to Pillow."""
    out = np.empty((height, width, 3), np.uint8)
    gh, gw = ctypes.c_int(), ctypes.c_int()
    buf = _buf(data)
    _check(jpeg_lib().jpeg_decode_resize(buf, buf.size, int(height),
                                         int(width), out, out.size,
                                         ctypes.byref(gh), ctypes.byref(gw)))
    return out


# --------------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------------- #

class PngError(ValueError):
    """A PNG stream the decoder refuses or cannot read."""


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> the mode Pillow opens the file in
PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L",
             (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P",
             (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA",
             (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
MODE_BANDS = {"1": 1, "L": 1, "I;16": 1, "P": 1, "LA": 2, "RGB": 3,
              "RGBA": 4}
# (x0, y0, dx, dy) of the seven Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# Pillow's decompression-bomb limit (2 x `Image.MAX_IMAGE_PIXELS`): past
# it `Image.open` raises, and so does this reader
PNG_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def png_passes(width: int, height: int, interlace: bool):
    """[(x0, y0, dx, dy, pass width, pass height)] of the image's passes
    that hold pixels (one pass when not interlaced)."""
    out = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw = max(0, -(-(width - x0) // dx))
        ph = max(0, -(-(height - y0) // dy))
        if pw and ph:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def png_stream(data: bytes) -> dict:
    """Read a PNG stream's chunks and inflate its image data (Python's
    zlib): -> {'width', 'height', 'depth', 'ctype', 'interlace', 'mode'
    (Pillow's), 'palette' ([n, 3] uint8 or None), 'transparency' (tRNS as
    Pillow reads it, or None), 'data' (the scanlines, each with its filter
    byte, as many bytes as the image needs)}.

    Raises PngError for a stream that is not a PNG, a chunk cut short or
    with a wrong CRC, an IHDR that is not first or not valid (a bit depth
    the colour type does not allow, a method past 0, an interlace past 1,
    an empty or a larger image than Pillow opens), a palette image without
    a PLTE of 1-256 entries, no IDAT, image data that does not inflate or
    ends early."""
    if data[:8] != PNG_SIGNATURE:
        raise PngError("not a PNG stream")
    pos, idat, plte, head, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + n
        if n > 0x7FFFFFFF or end + 4 > len(data):
            raise PngError(f"chunk {kind!r} cut short")
        body = data[pos + 8:end]
        if zlib.crc32(data[pos + 4:end]) != int.from_bytes(
                data[end:end + 4], "big"):
            raise PngError(f"chunk {kind!r} with a wrong CRC")
        pos = end + 4
        if head is None and kind != b"IHDR":
            raise PngError("the first chunk is not IHDR")
        if kind == b"IHDR":
            if head is not None or n != 13:
                raise PngError("IHDR repeated or not 13 bytes")
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if head is None:
        raise PngError("no IHDR chunk")
    w, h, depth, ctype, method, filt, interlace = head
    if (depth, ctype) not in PNG_MODES:
        raise PngError(f"bit depth {depth} with colour type {ctype}")
    if method or filt or interlace > 1:
        raise PngError(f"compression method {method}, filter method {filt}"
                       f", interlace method {interlace}")
    if not w or not h or w * h > PNG_MAX_PIXELS:
        raise PngError(f"image of {w} x {h} pixels")
    palette = None
    if ctype == 3:
        if plte is None or not 1 <= len(plte) // 3 <= 256 or len(plte) % 3:
            raise PngError("a palette image without a PLTE of 1-256 entries")
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    if not idat:
        raise PngError("no IDAT chunk")
    bits = PNG_CHANNELS[ctype] * depth
    need = sum(ph * (1 + (pw * bits + 7) // 8)
               for *_, pw, ph in png_passes(w, h, interlace))
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise PngError(f"image data does not inflate: {e}") from None
    if len(raw) < need:
        raise PngError(f"image data ends early ({len(raw)} of {need} bytes)")
    mode = PNG_MODES[(depth, ctype)]
    return {"width": w, "height": h, "depth": depth, "ctype": ctype,
            "interlace": bool(interlace), "mode": mode,
            "palette": palette, "transparency": _png_transparency(mode,
                                                                  trns),
            "data": raw}


def _png_transparency(mode: str, trns: bytes | None):
    """A tRNS chunk as Pillow keeps it in `info["transparency"]`: a
    palette's alphas, a grey level, an (r, g, b) colour; None for the
    modes with an alpha band."""
    if trns is None:
        return None
    if mode == "P":
        return bytes(trns)
    if mode in ("1", "L", "I;16") and len(trns) >= 2:
        return struct.unpack(">H", trns[:2])[0]
    if mode == "RGB" and len(trns) >= 6:
        return struct.unpack(">3H", trns[:6])
    return None


def decode_png(data: bytes, raw: bool = False) -> np.ndarray:
    """A PNG stream -> RGB uint8 [H, W, 3], Pillow 12.1's `Image.open(...)
    .convert("RGB")` bits; `raw`: the samples of the mode Pillow opens it
    in, [H, W, bands] as `np.asarray` of that image gives them (bool for
    "1", uint16 for "I;16", else uint8).  The chunks are read and inflated
    by `png_stream`, the scanlines decoded by `png_dec.cpp`; its plain
    numpy version is `data.detection_data.decode_png`."""
    s = png_stream(data)
    h, w, mode = s["height"], s["width"], s["mode"]
    if raw:
        out = np.empty((h, w, MODE_BANDS[mode]),
                       np.uint16 if mode == "I;16" else np.uint8)
    else:
        out = np.empty((h, w, 3), np.uint8)
    plte = s["palette"] if s["palette"] is not None else np.zeros((1, 3),
                                                                 np.uint8)
    buf = _buf(s["data"])
    rc = png_lib().png_decode(
        buf, buf.size, w, h, s["depth"], s["ctype"], int(s["interlace"]),
        np.ascontiguousarray(plte), 0 if s["palette"] is None else len(plte),
        int(raw), out.ctypes.data, out.nbytes)
    if rc != 0:
        raise PngError(png_lib().png_error_message().decode())
    return out.view(bool) if raw and mode == "1" else out
