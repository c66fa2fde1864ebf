"""BMP, GIF and TIFF streams: the header parsing (Python) and the native
decoders of their pixel data (`bmp_dec.cpp`, `gif_dec.cpp`,
`tiff_dec.cpp`, built at first use as `png_dec.cpp` is).

Each format opens in the mode Pillow 12 opens it in (`Image.open`, frame
0 or IFD 0), and the decoders give that mode's samples; the conversion to
RGB, L or RGBA is `data.image_formats.convert`.  `*_stream(data)` reads a
stream's headers into a dict that both the native decoders here and their
plain numpy versions (`data.image_formats.decode_*_reference`) take.

- BMP (`BM`): core, info, V2-V5 headers; 1-, 4- and 8-bit palettes (a
  grey palette opens as "1" or "L", as Pillow's reader drops it), 16-bit
  555 and 565 bit fields, 24-bit, 32-bit BI_RGB (alpha ignored: "RGB")
  and the bit fields Pillow reads (an alpha mask: "RGBA"); bottom-up and
  top-down rows; RLE8 and RLE4 (Pillow's decoder, its quirks included).
- GIF (`GIF87a`, `GIF89a`): frame 0 on a canvas the size of the logical
  screen (grown to hold the frame), filled with the transparency index or
  0; global and local palettes (a grey-ramp palette opens as "L"), LZW
  with code-size changes and clear codes, interlacing, the transparency
  index.
- TIFF (`II*\\0`, `MM\\0*`): IFD 0, both byte orders, strips and tiles,
  compression none, PackBits, LZW and Deflate (8 and 32946; Python's
  zlib), horizontal predictor 2 (LZW and Deflate, as libtiff applies it),
  min-is-white and min-is-black at 1, 2, 4, 8 and 16 bits, grey + alpha,
  RGB at 8 and 16 bits, chunky and planar, with extra samples as Pillow
  maps them (unspecified: dropped; associated: un-premultiplied;
  unassociated: alpha), palette at 1, 2, 4 and 8 bits.

A stream past this scope (JPEG-in-TIFF, CCITT, LogLuv, YCbCr or CMYK
TIFF, another fill order or sample format) raises `Unsupported`, citing
ROADMAP A 5; a stream that is cut short or corrupt raises
`ImageFormatError` with the reason.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

A5 = "ROADMAP A 5 'PIL-free transforms and real datasets'"
# Pillow's decompression-bomb limit (2 x `Image.MAX_IMAGE_PIXELS`)
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


class ImageFormatError(ValueError):
    """A BMP, GIF or TIFF stream the decoder cannot read."""


class Unsupported(ImageFormatError):
    """A stream of a kind the decoders leave out (ROADMAP A 5)."""


def _refuse(what: str):
    raise Unsupported(f"{what} is not decoded ({A5})")


def _check_size(w: int, h: int):
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ImageFormatError(f"image of {w} x {h} pixels")


def sniff(data: bytes) -> str | None:
    """The format of a stream by its signature: "png", "jpeg", "bmp",
    "gif", "tiff" or None."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:2] == b"BM":
        return "bmp"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    return None


# --------------------------------------------------------------------------- #
# the unpacking of stored samples into Pillow's mode
# --------------------------------------------------------------------------- #

# An unpack layout (shared by BMP and TIFF), eight ints:
#   bits      bits of a stored sample (1, 2, 4, 8, 16), or 15 / 16 with
#             `packed` for BMP's 16-bit 555 / 565 pixels
#   spp       stored samples per pixel
#   bands     bands of the output mode
#   src       four 4-bit fields: the stored sample of each output band
#             (band b at bits 4b..4b+3; 15: that band is 255)
#   flags     1 min-is-white (invert), 2 scale 1-bit to 0 / 255 and 2- and
#             4-bit to 8 bits, 4 keep 16-bit samples (I;16), 8 big-endian
#             16-bit samples, 16 un-premultiply the colour by band 3
#             (Pillow's "RGBa"), 32 BMP 555 pixels, 64 BMP 565 pixels
KEEP16, BIG, UNPREMUL, P555, P565 = 4, 8, 16, 32, 64
INVERT, SCALE = 1, 2


def layout(bits, spp, bands, src, flags=0) -> np.ndarray:
    code = 0
    for b in range(4):
        code |= (src[b] if b < len(src) else 15) << (4 * b)
    return np.asarray([bits, spp, bands, code, flags, 0, 0, 0], np.int32)


def out_dtype(lay) -> type:
    return np.uint16 if lay[4] & KEEP16 else np.uint8


# --------------------------------------------------------------------------- #
# BMP
# --------------------------------------------------------------------------- #

_RAW, _RLE8, _RLE4, _FIELDS = 0, 1, 2, 3
# 32-bit bit-field masks (r, g, b, a) -> the bytes of a pixel, in file
# order, as Pillow's raw modes read them
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}


def _bytes_layout(raw: str, bands: int) -> np.ndarray:
    """A raw mode of whole bytes ("BGR", "BGRX", "ABGR", ...) -> layout."""
    src = [raw.index(c) for c in "RGBA"[:bands]]
    return layout(8, len(raw), bands, src)


def bmp_stream(data: bytes) -> dict:
    """A BMP stream's headers as Pillow's `BmpImageFile` reads them ->
    {'width', 'height', 'mode', 'layout', 'kind' (0 raw, 1 RLE8, 2 RLE4),
    'stride', 'bottom_up', 'pixels' (the bytes from the pixel offset),
    'parity' (the pixel offset's parity, which RLE's word alignment
    reads), 'palette' ([n, 3] uint8 or None)}."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ImageFormatError("not a BMP stream")
    offset = struct.unpack_from("<I", data, 10)[0]
    hsize = struct.unpack_from("<I", data, 14)[0]
    pos = 18
    head = data[pos:pos + hsize - 4]
    if hsize < 12 or len(head) < hsize - 4:
        raise ImageFormatError("BMP header cut short")
    pos += hsize - 4
    masks = None
    if hsize == 12:
        w, h, planes, bits = struct.unpack_from("<HHHH", head)
        comp, colors, pad, bottom_up = _RAW, 0, 3, True
    elif hsize in (40, 52, 56, 64, 108, 124):
        y_flip = head[7] == 0xFF
        w = struct.unpack_from("<I", head, 0)[0]
        h = struct.unpack_from("<I", head, 4)[0]
        if y_flip:
            h = 2 ** 32 - h
        planes, bits = struct.unpack_from("<HH", head, 8)
        comp = struct.unpack_from("<I", head, 12)[0]
        colors = struct.unpack_from("<I", head, 28)[0]
        pad, bottom_up = 4, not y_flip
        if comp == _FIELDS:
            if len(head) >= 48:
                n = 4 if len(head) >= 52 else 3
                masks = struct.unpack_from(f"<{n}I", head, 36)
            else:
                if len(data) < pos + 12:
                    raise ImageFormatError("BMP bit fields cut short")
                masks = struct.unpack_from("<3I", data, pos)
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise ImageFormatError(f"BMP header of {hsize} bytes")
    if w >= 2 ** 31 or h >= 2 ** 31:
        raise ImageFormatError(f"BMP of {w} x {h} pixels")
    _check_size(w, h)
    colors = colors or (1 << bits if bits < 32 else 0)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    palette = None
    raw = None
    if bits in (1, 4, 8):
        mode = "P"
        lay = layout(bits, 1, 1, [0])
    elif bits == 16:
        mode, raw = "RGB", "BGR;15"
    elif bits == 24:
        mode, raw = "RGB", "BGR"
    elif bits == 32:
        mode, raw = "RGB", "BGRX"
    else:
        raise ImageFormatError(f"BMP pixel depth {bits}")
    kind = _RAW
    if comp == _FIELDS:
        if bits == 32 and masks in _MASKS32:
            raw = _MASKS32[masks]
            mode = "RGBA" if "A" in raw else mode
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            raw = "BGR"
        elif bits == 16 and masks[:3] == (0xF800, 0x7E0, 0x1F):
            raw = "BGR;16"
        elif bits == 16 and masks[:3] == (0x7C00, 0x3E0, 0x1F):
            raw = "BGR;15"
        else:
            raise ImageFormatError("BMP bit fields layout not read by "
                                   "Pillow")
    elif comp in (_RLE8, _RLE4):
        kind = comp
    elif comp != _RAW:
        raise ImageFormatError(f"BMP compression {comp}")
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ImageFormatError(f"BMP palette of {colors} colours")
        pal = data[pos:pos + pad * colors]
        # a palette of greys in index order: Pillow drops it ("1" or "L")
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * pad:i * pad + 3] == bytes([v]) * 3
                   for i, v in enumerate(ramp))
        if grey and colors != 2 and bits < 8:
            # Pillow reads these rows as 8-bit grey, past the row's bytes
            _refuse(f"BMP {bits}-bit grey palette")
        if grey:
            mode = "1" if colors == 2 else "L"
            lay = layout(1, 1, 1, [0], SCALE) if mode == "1" else \
                layout(8, 1, 1, [0])
        else:
            n = len(pal) // pad
            if n == 0:
                raise ImageFormatError("BMP palette cut short")
            palette = np.frombuffer(pal[:n * pad], np.uint8).reshape(
                n, pad)[:, 2::-1].copy()
    if raw == "BGR;15":
        lay = layout(16, 1, 3, [0, 1, 2], P555)
    elif raw == "BGR;16":
        lay = layout(16, 1, 3, [0, 1, 2], P565)
    elif raw is not None:
        lay = _bytes_layout(raw, 4 if mode == "RGBA" else 3)
    if kind != _RAW and mode not in ("P", "L"):
        raise ImageFormatError(f"BMP RLE in mode {mode}")
    stride = ((w * bits + 31) >> 3) & ~3
    return {"width": w, "height": h, "mode": mode, "layout": lay,
            "kind": kind, "stride": stride, "bottom_up": bottom_up,
            "pixels": data[offset:], "parity": offset & 1,
            "palette": palette}


# --------------------------------------------------------------------------- #
# GIF
# --------------------------------------------------------------------------- #

def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p), 3))


def _sub_blocks(data: bytes, pos: int):
    """The data of the sub-blocks from `pos` up to the terminator or the
    end of the stream -> (bytes, position after them)."""
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        out.append(data[pos:pos + n])
        pos += n
    return b"".join(out), pos


def gif_stream(data: bytes) -> dict:
    """A GIF stream's frame 0 as Pillow's `GifImageFile` opens it ->
    {'width', 'height' (the canvas), 'box' (x0, y0, w, h of the frame),
    'interlace', 'min_code', 'lzw' (the image data's sub-blocks joined),
    'mode' ("P" or "L"), 'palette' ([n, 3] uint8 or None),
    'transparency' (the index or None)}."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ImageFormatError("not a GIF stream")
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    glob = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        p = data[pos:pos + n]
        pos += n
        if len(p) < n:
            raise ImageFormatError("GIF palette cut short")
        if _palette_needed(p):
            glob = p
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ImageFormatError("no image in the GIF stream")
        tag = data[pos]
        pos += 1
        if tag == 0x21:
            if pos >= len(data):
                raise ImageFormatError("GIF extension cut short")
            label = data[pos]
            pos += 1
            first = None
            if pos < len(data) and data[pos]:
                first = data[pos + 1:pos + 1 + data[pos]]
            if label == 0xF9 and first is not None and len(first) >= 4 \
                    and first[0] & 1:
                transparency = first[3]
            _, pos = _sub_blocks(data, pos)
        elif tag == 0x2C:
            if pos + 10 > len(data):
                raise ImageFormatError("GIF image descriptor cut short")
            x0, y0, fw, fh, fl = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            local = None
            if fl & 128:
                n = 3 << ((fl & 7) + 1)
                p = data[pos:pos + n]
                pos += n
                if len(p) < n:
                    raise ImageFormatError("GIF palette cut short")
                local = p if _palette_needed(p) else False
            if pos >= len(data):
                raise ImageFormatError("GIF image data cut short")
            min_code = data[pos]
            lzw, _ = _sub_blocks(data, pos + 1)
            break
        else:
            # Pillow skips a byte it does not know and reads on
            continue
    pal = local if local is not None else glob
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    _check_size(w, h)
    palette = None
    if pal:
        n = len(pal) // 3
        if n == 0:
            raise ImageFormatError("GIF palette cut short")
        palette = np.frombuffer(pal[:3 * n], np.uint8).reshape(n, 3).copy()
    if not 1 <= min_code <= 11:
        raise ImageFormatError(f"GIF LZW minimum code size {min_code}")
    return {"width": w, "height": h, "box": (x0, y0, fw, fh),
            "interlace": bool(fl & 64), "min_code": min_code, "lzw": lzw,
            "mode": "P" if palette is not None else "L",
            "palette": palette, "transparency": transparency}


def gif_rows(h: int, interlace: bool) -> list:
    """The frame rows in the order the data holds them."""
    if not interlace:
        return list(range(h))
    return [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
            for y in range(start, h, step)]


# --------------------------------------------------------------------------- #
# TIFF
# --------------------------------------------------------------------------- #

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i",
          16: "Q"}
# compression -> name; those past the decoders' scope are refused
TIFF_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                     32773: "PackBits"}
TIFF_REFUSED = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                6: "JPEG (old-style)", 7: "JPEG", 34676: "LogLuv (SGILog)",
                34677: "LogLuv (SGILog24)", 32809: "ThunderScan",
                34712: "JPEG 2000", 34925: "LZMA", 50000: "Zstandard",
                50001: "WebP"}
TIFF_PHOTOMETRIC_REFUSED = {4: "transparency mask", 5: "CMYK (separated)",
                            6: "YCbCr", 8: "CIE L*a*b*", 9: "ICC L*a*b*",
                            10: "ITU L*a*b*", 32844: "LogL",
                            32845: "LogLuv"}


def _ifd0(data: bytes):
    bo = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ImageFormatError("TIFF header cut short")
    pos = struct.unpack_from(bo + "I", data, 4)[0]
    if pos + 2 > len(data):
        raise ImageFormatError("TIFF IFD 0 past the end of the stream")
    n = struct.unpack_from(bo + "H", data, pos)[0]
    tags = {}
    for i in range(n):
        at = pos + 2 + 12 * i
        if at + 12 > len(data):
            raise ImageFormatError("TIFF IFD 0 cut short")
        tag, typ, count = struct.unpack_from(bo + "HHI", data, at)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(fmt) * count
        if size <= 4:
            where = at + 8
        else:
            where = struct.unpack_from(bo + "I", data, at + 8)[0]
        if where + size > len(data) or count > 1 << 24:
            raise ImageFormatError(f"TIFF tag {tag} past the end of the "
                                   f"stream")
        tags[tag] = struct.unpack_from(f"{bo}{count}{fmt}", data, where)
    return bo, tags


def tiff_stream(data: bytes) -> dict:
    """A TIFF stream's IFD 0 as Pillow's `TiffImageFile` opens it ->
    {'width', 'height', 'mode', 'layout' (the unpack of a pixel: for
    planar data, band b takes plane src[b]), 'planes' (1 chunky, else the
    samples), 'chunks' ([(x, y, w, h, plane, rows of data, bytes)]: each
    strip or tile, `rows` the rows its data holds), 'compression',
    'predictor', 'bits', 'spp' (samples per pixel in a chunk),
    'big_endian', 'palette'}."""
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ImageFormatError("not a TIFF stream")
    bo, tags = _ifd0(data)

    def one(tag, default=None):
        v = tags.get(tag)
        return default if not v else v[0]

    w, h = one(256), one(257)
    if w is None or h is None:
        raise ImageFormatError("TIFF without its dimensions")
    _check_size(w, h)
    comp = one(259, 1)
    if comp in TIFF_REFUSED:
        _refuse(f"TIFF compression {comp} ({TIFF_REFUSED[comp]})")
    if comp not in TIFF_COMPRESSIONS:
        _refuse(f"TIFF compression {comp}")
    photo = one(262, 0)
    if photo in TIFF_PHOTOMETRIC_REFUSED:
        _refuse(f"TIFF photometric {photo} "
                f"({TIFF_PHOTOMETRIC_REFUSED[photo]})")
    if photo not in (0, 1, 2, 3):
        _refuse(f"TIFF photometric {photo}")
    if one(266, 1) != 1:
        _refuse(f"TIFF fill order {one(266)}")
    sample_format = tags.get(339, (1,))
    if any(v != 1 for v in sample_format):
        _refuse(f"TIFF sample format {sample_format}")
    planar = one(284, 1)
    extra = tags.get(338, ())
    spp = one(277, 1)
    bps = tags.get(258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp or len(set(bps)) != 1:
        raise ImageFormatError(f"TIFF bits per sample {bps} for {spp} "
                               f"samples")
    bits = bps[0]
    big = bo == ">"
    palette = None
    flags = 0
    if photo in (0, 1):
        if spp == 1 and bits in (1, 2, 4, 8):
            mode = "1" if bits == 1 else "L"
            lay_bits, bands, src = bits, 1, [0]
            flags = SCALE | (INVERT if photo == 0 else 0)
        elif spp == 1 and bits == 16 and not (big and photo == 0):
            # Pillow opens 16-bit min-is-white (little-endian) as I;16,
            # not inverted, and has no mode for it big-endian
            mode = "I;16B" if big else "I;16"
            lay_bits, bands, src, flags = 16, 1, [0], KEEP16
        elif spp == 2 and bits == 8 and photo == 1 and extra == (2,):
            mode, lay_bits, bands, src = "LA", 8, 2, [0, 1]
        else:
            _refuse(f"TIFF grey of {spp} x {bits}-bit samples, extra "
                    f"samples {extra}")
    elif photo == 2:
        first = extra[0] if extra else None
        if bits not in (8, 16) or spp not in (3, 4) or \
                len(extra) > spp - 3 or first not in (None, 0, 1, 2) or \
                (bits == 16 and first == 1) or (spp == 4 and planar != 1):
            _refuse(f"TIFF RGB of {spp} x {bits}-bit samples, extra "
                    f"samples {extra}, planar configuration {planar}")
        if spp == 3 or first == 0:
            mode, bands, src = "RGB", 3, [0, 1, 2]
        else:
            mode, bands, src = "RGBA", 4, [0, 1, 2, 3]
            if first == 1:
                flags = UNPREMUL
        lay_bits = bits
    else:
        if spp != 1 or bits not in (1, 2, 4, 8):
            _refuse(f"TIFF palette of {spp} x {bits}-bit samples")
        cmap = tags.get(320)
        if not cmap or len(cmap) != 3 << bits:
            raise ImageFormatError("TIFF palette without a colour map of "
                                   "3 x 2^bits entries")
        c = np.asarray(cmap, np.int64).reshape(3, -1) // 256
        palette = c.T.astype(np.uint8)
        mode, lay_bits, bands, src = "P", bits, 1, [0]
    if bits == 16 and big:
        flags |= BIG
    chunky = planar == 1 or spp == 1
    cspp = spp if chunky else 1
    if 322 in tags:                     # tiles
        tw, th = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
        if not tw or not th or tw < 0 or th < 0:
            raise ImageFormatError("TIFF tiles without their size")
        across, down = -(-w // tw), -(-h // th)
        boxes = [(x * tw, y * th, tw, th, th)
                 for y in range(down) for x in range(across)]
    else:
        rps = one(278, h)
        rps = h if rps is None or rps <= 0 else min(rps, h)
        offsets, counts = tags.get(273), tags.get(279)
        boxes = [(0, y, w, min(rps, h - y), min(rps, h - y))
                 for y in range(0, h, rps)]
    if not offsets:
        raise ImageFormatError("TIFF without strip or tile offsets")
    planes = 1 if chunky else spp
    if counts is None:
        if comp != 1:
            raise ImageFormatError("TIFF compressed without byte counts")
        counts = [(b[2] * cspp * bits + 7) // 8 * b[4]
                  for b in boxes] * planes
    if len(offsets) < len(boxes) * planes or len(counts) < len(offsets):
        raise ImageFormatError(f"TIFF with {len(offsets)} strips or tiles "
                               f"for {len(boxes) * planes}")
    chunks = []
    for p in range(planes):
        for i, (x, y, cw, ch, rows) in enumerate(boxes):
            k = p * len(boxes) + i
            o, n = offsets[k], counts[k]
            if o >= len(data):
                raise ImageFormatError("TIFF strip or tile past the end of "
                                       "the stream")
            chunks.append((x, y, cw, ch, p, rows, data[o:o + n]))
    lay = layout(lay_bits, cspp, bands, src, flags)
    return {"width": w, "height": h, "mode": mode, "layout": lay,
            "planes": planes, "chunks": chunks,
            "compression": TIFF_COMPRESSIONS[comp],
            "predictor": one(317, 1) if comp in (5, 8, 32946) else 1,
            "bits": bits, "spp": cspp, "big_endian": big,
            "palette": palette}


def tiff_inflate(chunk: bytes, need: int) -> bytes:
    """A Deflate chunk through Python's zlib: at least `need` bytes or
    ImageFormatError."""
    try:
        raw = zlib.decompressobj().decompress(chunk, need)
    except zlib.error as e:
        raise ImageFormatError(f"TIFF Deflate data does not inflate: "
                               f"{e}") from None
    if len(raw) < need:
        raise ImageFormatError(f"TIFF Deflate data ends early ({len(raw)} "
                               f"of {need} bytes)")
    return raw


def chunk_row_bytes(cw: int, spp: int, bits: int) -> int:
    return (cw * spp * bits + 7) // 8


# --------------------------------------------------------------------------- #
# the native decoders
# --------------------------------------------------------------------------- #

_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I, _L, _V = ctypes.c_int, ctypes.c_long, ctypes.c_void_p


def _lib(source: str, setup):
    from . import build_library
    lib = ctypes.CDLL(str(build_library(source)))
    lib.format_error_message.restype = ctypes.c_char_p
    setup(lib)
    return lib


@functools.cache
def bmp_lib():
    def setup(lib):
        lib.bmp_decode.argtypes = [_U8P, _L, _I, _I, _I, _I32P, _I, _I, _I,
                                   _V, _L]
        lib.bmp_decode.restype = _I
    return _lib("bmp_dec.cpp", setup)


@functools.cache
def gif_lib():
    def setup(lib):
        lib.gif_decode.argtypes = [_U8P, _L, _I, _I, _I, _I, _U8P, _L]
        lib.gif_decode.restype = _L
    return _lib("gif_dec.cpp", setup)


@functools.cache
def tiff_lib():
    def setup(lib):
        lib.tiff_decompress.argtypes = [_I, _U8P, _L, _U8P, _L]
        lib.tiff_decompress.restype = _L
        lib.tiff_predict.argtypes = [_U8P, _I, _L, _I, _I, _I]
        lib.tiff_predict.restype = _I
        lib.tiff_place.argtypes = [_U8P, _I, _I, _L, _I, _I, _I, _I32P, _V,
                                   _I, _I]
        lib.tiff_place.restype = _I
    return _lib("tiff_dec.cpp", setup)


def _raise(lib, rc):
    if rc < 0:
        raise ImageFormatError(lib.format_error_message().decode())


def _buf(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)


def bmp_decode(s: dict) -> np.ndarray:
    """`bmp_stream`'s pixel data -> the samples of its mode [h, w, bands]
    (`bmp_dec.cpp`)."""
    lay = s["layout"]
    out = np.zeros((s["height"], s["width"], int(lay[2])), out_dtype(lay))
    lib = bmp_lib()
    buf = _buf(s["pixels"])
    _raise(lib, lib.bmp_decode(buf, len(s["pixels"]), s["width"],
                               s["height"], s["kind"], lay, s["stride"],
                               int(s["bottom_up"]), s["parity"],
                               out.ctypes.data, out.nbytes))
    return out


def gif_decode(s: dict) -> np.ndarray:
    """`gif_stream`'s frame 0 -> the indices of the canvas [h, w]
    (`gif_dec.cpp` decodes the frame; it is placed here)."""
    x0, y0, fw, fh = s["box"]
    frame = np.full((fh, fw), s["transparency"] or 0, np.uint8)
    lib = gif_lib()
    buf = _buf(s["lzw"])
    if fw and fh:
        _raise(lib, lib.gif_decode(buf, len(s["lzw"]), s["min_code"], fw,
                                   fh, int(s["interlace"]), frame,
                                   frame.size))
    return place_gif_frame(s, frame)


def place_gif_frame(s: dict, frame: np.ndarray) -> np.ndarray:
    """The canvas of frame 0: the transparency index (or 0) around the
    frame (and where its data ends early)."""
    x0, y0, fw, fh = s["box"]
    canvas = np.full((s["height"], s["width"]), s["transparency"] or 0,
                     np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    return canvas


def tiff_decode(s: dict) -> np.ndarray:
    """`tiff_stream`'s chunks -> the samples of its mode [h, w, bands]:
    each strip or tile decompressed (`tiff_dec.cpp`; Deflate through
    zlib), un-predicted and unpacked into place."""
    lay = s["layout"]
    out = np.zeros((s["height"], s["width"], int(lay[2])), out_dtype(lay))
    lib = tiff_lib()
    for x, y, cw, ch, plane, rows, data in s["chunks"]:
        rb = chunk_row_bytes(cw, s["spp"], s["bits"])
        need = rb * rows
        if s["compression"] == "Deflate":
            raw = np.frombuffer(tiff_inflate(data, need), np.uint8).copy()
        elif s["compression"] == "none":
            if len(data) < need:
                raise ImageFormatError(f"TIFF strip or tile of {len(data)} "
                                       f"bytes, {need} needed")
            raw = np.frombuffer(data, np.uint8).copy()
        else:
            raw = np.zeros(need, np.uint8)
            code = 5 if s["compression"] == "LZW" else 32773
            got = lib.tiff_decompress(code, _buf(data), len(data), raw, need)
            _raise(lib, got)
            if got < need:
                raise ImageFormatError(f"TIFF {s['compression']} data ends "
                                       f"early ({got} of {need} bytes)")
        if s["predictor"] == 2:
            _raise(lib, lib.tiff_predict(raw, rows, rb, s["spp"], s["bits"],
                                         int(s["big_endian"])))
        elif s["predictor"] != 1:
            _refuse(f"TIFF predictor {s['predictor']}")
        _raise(lib, lib.tiff_place(raw, cw, rows, rb, x, y, plane, lay,
                                   out.ctypes.data, s["width"],
                                   s["height"]))
    return out
