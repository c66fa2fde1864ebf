"""Image files decoded by their content into Pillow's modes, and Pillow's
conversions to RGB, L and RGBA, without PIL.

`open_image(data)` gives what Pillow 12's `Image.open` holds: the mode it
opens the stream in and that mode's samples (`Decoded`); `convert(img,
mode)` then gives `np.asarray(img.convert(mode))` for "RGB" ([H, W, 3]),
"L" ([H, W]) and "RGBA" ([H, W, 4]).  PNG and JPEG go through their own
decoders (`native.decode_png`, `native.decode_jpeg`); BMP, GIF and TIFF
through `native.formats`, whose plain numpy versions are the
`decode_*_reference` functions here (the same headers, `*_stream`, the
pixel data decoded in numpy).

The conversions are Convert.c's: L from RGB as (19595 R + 38470 G +
7471 B + 2^15) >> 16 (a palette's entries so, CMYK through RGB), "1" as
0 / 255, I;16 clipped at 255, alpha dropped or 255; a palette index past
the palette's entries black; a `transparency` (PNG's tRNS, GIF's index)
gives RGBA its alpha as `Image.convert` does: a palette's alphas, or for
1, L, I;16 and RGB alpha 0 where the converted RGB equals the colour
(each of its values masked to 8 bits, as `ImagingConvertTransparent`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..native import formats as nf
from ..native.formats import ImageFormatError, Unsupported


@dataclasses.dataclass
class Decoded:
    mode: str                   # Pillow's mode: 1 L LA P RGB RGBA I;16...
    px: np.ndarray              # [H, W, bands]; uint16 for I;16, "1" 0/255
    palette: np.ndarray | None = None       # [n, 3] uint8
    transparency: object = None             # int, (r, g, b) or alphas


def _luma(rgb: np.ndarray) -> np.ndarray:
    x = rgb.astype(np.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _to_rgb(img: Decoded) -> np.ndarray:
    px, mode = img.px, img.mode
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        n = min(len(img.palette), 256)
        pal[:n] = img.palette[:n]
        return pal[px[..., 0]]
    if mode in ("RGB", "RGBA"):
        return px[..., :3].astype(np.uint8)
    if mode.startswith("I"):
        grey = np.minimum(px[..., 0], 255).astype(np.uint8)
    else:                       # 1, L, LA
        grey = px[..., 0].astype(np.uint8)
    return np.repeat(grey[..., None], 3, axis=-1)


def convert(img: Decoded, mode: str) -> np.ndarray:
    """`np.asarray(img.convert(mode))` for `mode` "RGB", "L" or "RGBA"."""
    if mode not in ("RGB", "L", "RGBA"):
        raise ValueError(f"mode {mode!r}: 'RGB', 'L' or 'RGBA'")
    if mode == "L":
        if img.mode in ("1", "L", "LA"):
            return img.px[..., 0].astype(np.uint8)
        return _luma(_to_rgb(img))
    rgb = _to_rgb(img)
    if mode == "RGB":
        return rgb
    if img.mode in ("RGBA",):
        alpha = img.px[..., 3].astype(np.uint8)
    elif img.mode == "LA":
        alpha = img.px[..., 1].astype(np.uint8)
    elif img.mode == "P":
        alphas = np.full(256, 255, np.uint8)
        t = img.transparency
        if isinstance(t, (bytes, bytearray)):
            alphas[:min(len(t), 256)] = np.frombuffer(bytes(t[:256]),
                                                      np.uint8)
        elif isinstance(t, int) and 0 <= t < 256:
            alphas[t] = 0
        alpha = alphas[img.px[..., 0]]
    elif img.transparency is not None:
        t = img.transparency
        t = tuple(t) if isinstance(t, (tuple, list)) else (t, t, t)
        key = np.asarray([v & 255 for v in t], np.uint8)
        alpha = np.where((rgb == key).all(-1), 0, 255).astype(np.uint8)
    else:
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


# --------------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------------- #

def _png(data: bytes) -> Decoded:
    s = native.png_stream(data)
    px = native.decode_png(data, raw=True)
    if s["mode"] == "1":
        px = px.astype(np.uint8) * 255
    return Decoded(s["mode"], px, s["palette"], s["transparency"])


def _jpeg(data: bytes) -> Decoded:
    rgb = native.decode_jpeg(data)
    if native.jpeg_info(data)["kind"] == native.GRAY:
        return Decoded("L", rgb[..., :1].copy())
    # YCbCr, RGB, and CMYK / YCCK through Pillow's CMYK -> RGB (its L and
    # RGBA conversions of CMYK go through RGB too)
    return Decoded("RGB", rgb)


def open_image(data: bytes, native_ops: bool = True) -> Decoded:
    """A stream decoded by its content into Pillow's open mode; raises
    `Unsupported` (citing ROADMAP A 5) for content no decoder here reads,
    and ValueError (`native.PngError`, `native.JpegError`,
    `ImageFormatError`) for a stream a decoder refuses.  `native_ops`
    False: BMP, GIF and TIFF through the plain numpy versions."""
    kind = nf.sniff(data)
    if kind == "png":
        return _png(data)
    if kind == "jpeg":
        return _jpeg(data)
    if kind == "bmp":
        s = nf.bmp_stream(data)
        px = nf.bmp_decode(s) if native_ops else decode_bmp_reference(s)
        return Decoded(s["mode"], px, s["palette"])
    if kind == "gif":
        s = nf.gif_stream(data)
        idx = nf.gif_decode(s) if native_ops else decode_gif_reference(s)
        return Decoded(s["mode"], idx[..., None], s["palette"],
                       s["transparency"])
    if kind == "tiff":
        s = nf.tiff_stream(data)
        px = nf.tiff_decode(s) if native_ops else decode_tiff_reference(s)
        return Decoded(s["mode"], px, s["palette"])
    raise Unsupported(f"content that is not PNG, JPEG, BMP, GIF or TIFF "
                      f"is not decoded ({nf.A5})")


def decode_image(data: bytes, mode: str = "RGB",
                 native_ops: bool = True) -> np.ndarray:
    """`np.asarray(Image.open(stream).convert(mode))`."""
    if mode == "RGB" and nf.sniff(data) in ("png", "jpeg"):
        # the decoders' own RGB output: the same bits, one pass
        return native.decode_png(data) if data[:1] == b"\x89" else \
            native.decode_jpeg(data)
    return convert(open_image(data, native_ops), mode)


# --------------------------------------------------------------------------- #
# the plain numpy versions of the native decoders
# --------------------------------------------------------------------------- #

def _samples(rows: np.ndarray, n: int, bits: int, big: bool) -> np.ndarray:
    """Rows of bytes [h, stride] -> the first `n` samples of each row at
    `bits` bits (MSB first below 8; 16-bit in the byte order)."""
    h = rows.shape[0]
    if bits == 8:
        return rows[:, :n].astype(np.int64)
    if bits == 16:
        b = rows[:, :2 * n].astype(np.int64).reshape(h, n, 2)
        return (b[..., 0] << 8 | b[..., 1]) if big else \
            (b[..., 1] << 8 | b[..., 0])
    bitv = np.unpackbits(rows, axis=1)[:, :n * bits].reshape(h, n, bits)
    weights = 1 << np.arange(bits - 1, -1, -1)
    return (bitv.astype(np.int64) * weights).sum(-1)


def unpack_reference(rows: np.ndarray, width: int, lay) -> np.ndarray:
    """Rows of stored pixels [h, stride] -> [h, width, bands] samples of
    the layout's mode (`native.formats.layout`)."""
    bits, spp, bands, code, flags = (int(v) for v in lay[:5])
    h = rows.shape[0]
    big = bool(flags & nf.BIG)
    if flags & (nf.P555 | nf.P565):
        v = _samples(rows, width, 16, False)
        if flags & nf.P565:
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            out = [r * 255 // 31, g * 255 // 63, b * 255 // 31]
        else:
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            out = [r * 255 // 31, g * 255 // 31, b * 255 // 31]
        return np.stack(out, -1).astype(np.uint8)
    s = _samples(rows, width * spp, bits, big).reshape(h, width, spp)
    if bits == 16 and not flags & nf.KEEP16:
        s = s >> 8
    if flags & nf.SCALE and bits < 8:
        s = s * {1: 255, 2: 0x55, 4: 0x11}[bits]
        top = 255
    else:
        top = 65535 if flags & nf.KEEP16 else 255
    if flags & nf.INVERT:
        s = top - s
    out = np.empty((h, width, bands), np.int64)
    for b in range(bands):
        k = (code >> (4 * b)) & 15
        out[..., b] = 255 if k == 15 else s[..., k]
    if flags & nf.UNPREMUL:
        a = out[..., 3:4]
        rgb = np.where(a == 0, 0, np.where(
            a == 255, out[..., :3],
            np.minimum(out[..., :3] * 255 // np.maximum(a, 1), 255)))
        out[..., :3] = rgb
        out[..., 3:4] = np.where(a == 0, 0, a)
    return out.astype(np.uint16 if flags & nf.KEEP16 else np.uint8)


def _bmp_rle_reference(s: dict) -> np.ndarray:
    """Pillow's `BmpRleDecoder`: -> the indices, bytes in data order."""
    w, h = s["width"], s["height"]
    rle4 = s["kind"] == 2
    src = s["pixels"]
    pos, data, x = 0, bytearray(), 0
    parity = s["parity"]
    while len(data) < w * h:
        if pos + 2 > len(src):
            break
        n, byte = src[pos], src[pos + 1]
        pos += 2
        if n:
            if x + n > w:
                n = max(0, w - x)
            if rle4:
                pair = (byte >> 4, byte & 15)
                data += bytes(pair[i % 2] for i in range(n))
            else:
                data += bytes([byte]) * n
            x += n
        elif byte == 0:
            while len(data) % w:
                data.append(0)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > len(src):
                break
            pos += 2                    # Pillow reads two bytes, then two
            if pos + 2 > len(src):
                raise ImageFormatError("BMP RLE delta cut short")
            right, up = src[pos], src[pos + 1]
            pos += 2
            data += bytes(right + up * w)
            x = len(data) % w
        else:
            count = byte // 2 if rle4 else byte
            got = src[pos:pos + count]
            pos += len(got)
            if rle4:
                for v in got:
                    data += bytes([v >> 4, v & 15])
            else:
                data += got
            if len(got) < count:
                break
            x += byte
            if (pos + parity) % 2:
                pos += 1
    if len(data) < w * h:
        raise ImageFormatError(f"BMP RLE data gives {len(data)} of {w * h} "
                               f"pixels")
    rows = np.frombuffer(bytes(data[:w * h]), np.uint8).reshape(h, w)
    return rows[::-1] if s["bottom_up"] else rows


def decode_bmp_reference(s: dict) -> np.ndarray:
    """`native.formats.bmp_decode` in numpy."""
    w, h, lay = s["width"], s["height"], s["layout"]
    if s["kind"]:
        return _bmp_rle_reference(s)[..., None].copy()
    stride = s["stride"]
    row_bytes = (w * int(lay[0]) * int(lay[1]) + 7) // 8 \
        if not lay[4] & (nf.P555 | nf.P565) else 2 * w
    need = stride * (h - 1) + row_bytes
    if len(s["pixels"]) < need:
        raise ImageFormatError(f"BMP pixel data of {len(s['pixels'])} "
                               f"bytes, {need} needed")
    buf = np.frombuffer(s["pixels"][:need] + bytes(stride * h - need),
                        np.uint8).reshape(h, stride)
    if s["bottom_up"]:
        buf = buf[::-1]
    return unpack_reference(buf, w, lay)


class _LzwTable:
    def __init__(self, min_code: int):
        self.clear, self.end = 1 << min_code, (1 << min_code) + 1
        self.min_code = min_code
        self.reset()

    def reset(self):
        self.entries = [bytes([i]) for i in range(self.clear)] + [b"", b""]
        self.size = self.min_code + 1


def gif_lzw_reference(lzw: bytes, min_code: int, n: int) -> bytes:
    """GIF's LZW: the first `n` indices the codes give (fewer if the data
    or an end code stops them first); an invalid code raises."""
    t = _LzwTable(min_code)
    out = bytearray()
    prev = None
    acc = nbits = 0
    pos = 0
    while len(out) < n:
        while nbits < t.size and pos < len(lzw):
            acc |= lzw[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < t.size:
            break
        code = acc & ((1 << t.size) - 1)
        acc >>= t.size
        nbits -= t.size
        if code == t.clear:
            t.reset()
            prev = None
            continue
        if code == t.end:
            break
        if prev is None:
            if code >= t.clear:
                raise ImageFormatError(f"GIF LZW code {code} before any "
                                       f"string")
            entry = t.entries[code]
        elif code < len(t.entries) and code not in (t.clear, t.end):
            entry = t.entries[code]
            if len(t.entries) < 4096:
                t.entries.append(prev + entry[:1])
        elif code == len(t.entries) and len(t.entries) < 4096:
            entry = prev + prev[:1]
            t.entries.append(entry)
        else:
            raise ImageFormatError(f"GIF LZW code {code} past the table "
                                   f"({len(t.entries)} entries)")
        out += entry
        prev = entry
        if len(t.entries) == 1 << t.size and t.size < 12:
            t.size += 1
    return bytes(out[:n])


def decode_gif_reference(s: dict) -> np.ndarray:
    """`native.formats.gif_decode` in numpy (and Python's loops)."""
    x0, y0, fw, fh = s["box"]
    fill = s["transparency"] or 0
    frame = np.full((fh, fw), fill, np.uint8)
    if fw and fh:
        got = np.frombuffer(gif_lzw_reference(s["lzw"], s["min_code"],
                                              fw * fh), np.uint8)
        idx = np.full(fw * fh, fill, np.uint8)
        idx[:len(got)] = got
        frame[nf.gif_rows(fh, s["interlace"])] = idx.reshape(fh, fw)
    return nf.place_gif_frame(s, frame)


def packbits_reference(data: bytes, need: int) -> bytes:
    out = bytearray()
    pos = 0
    while len(out) < need and pos < len(data):
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos >= len(data):
                break
            out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out[:need])


def tiff_lzw_reference(data: bytes, need: int) -> bytes:
    """TIFF's LZW (MSB-first codes, the early code-size change)."""
    out = bytearray()
    entries = [bytes([i]) for i in range(256)] + [b"", b""]
    size, prev = 9, None
    acc = nbits = pos = 0
    while len(out) < need:
        while nbits < size and pos < len(data):
            acc = (acc << 8) | data[pos]
            nbits += 8
            pos += 1
        if nbits < size:
            break
        code = (acc >> (nbits - size)) & ((1 << size) - 1)
        nbits -= size
        acc &= (1 << nbits) - 1
        if code == 256:
            entries = entries[:258]
            size, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ImageFormatError(f"TIFF LZW code {code} before any "
                                       f"string")
            entry = entries[code]
        elif code < len(entries):
            entry = entries[code]
            if len(entries) < 4096:
                entries.append(prev + entry[:1])
        elif code == len(entries) and len(entries) < 4096:
            entry = prev + prev[:1]
            entries.append(entry)
        else:
            raise ImageFormatError(f"TIFF LZW code {code} past the table "
                                   f"({len(entries)} entries)")
        out += entry
        prev = entry
        if len(entries) + 1 >= 1 << size and size < 12:
            size += 1
    return bytes(out[:need])


def predict_reference(raw: np.ndarray, rows: int, rb: int, spp: int,
                      bits: int, big: bool) -> np.ndarray:
    """Undo horizontal differencing (predictor 2) on each row."""
    r = raw[:rows * rb].reshape(rows, rb)
    if bits == 8:
        v = r.reshape(rows, -1, spp).astype(np.int64)
        v = np.cumsum(v, axis=1) & 0xFF
        r = v.astype(np.uint8).reshape(rows, -1)
    elif bits == 16:
        n = rb // 2
        dt = ">u2" if big else "<u2"
        v = r[:, :2 * n].copy().view(dt).reshape(rows, -1, spp).astype(
            np.int64)
        v = np.cumsum(v, axis=1) & 0xFFFF
        r = np.concatenate([v.reshape(rows, -1).astype(dt).view(np.uint8),
                            r[:, 2 * n:]], axis=1)
    else:
        raise Unsupported(f"TIFF predictor 2 at {bits} bits is not decoded "
                          f"({nf.A5})")
    out = raw.copy()
    out[:rows * rb] = r.reshape(-1)
    return out


def decode_tiff_reference(s: dict) -> np.ndarray:
    """`native.formats.tiff_decode` in numpy."""
    lay = s["layout"]
    bands = int(lay[2])
    out = np.zeros((s["height"], s["width"], bands), nf.out_dtype(lay))
    planar = s["planes"] > 1
    for x, y, cw, ch, plane, rows, data in s["chunks"]:
        rb = nf.chunk_row_bytes(cw, s["spp"], s["bits"])
        need = rb * rows
        if s["compression"] == "Deflate":
            raw = nf.tiff_inflate(data, need)
        elif s["compression"] == "LZW":
            raw = tiff_lzw_reference(data, need)
        elif s["compression"] == "PackBits":
            raw = packbits_reference(data, need)
        else:
            raw = data[:need]
        if len(raw) < need:
            raise ImageFormatError(f"TIFF {s['compression']} data ends "
                                   f"early ({len(raw)} of {need} bytes)")
        raw = np.frombuffer(raw, np.uint8).copy()
        if s["predictor"] == 2:
            raw = predict_reference(raw, rows, rb, s["spp"], s["bits"],
                                    s["big_endian"])
        elif s["predictor"] != 1:
            raise Unsupported(f"TIFF predictor {s['predictor']} is not "
                              f"decoded ({nf.A5})")
        rowsv = raw[:need].reshape(rows, rb)
        h = min(ch, s["height"] - y, rows)
        w = min(cw, s["width"] - x)
        if h <= 0 or w <= 0:
            continue
        if planar:
            one = nf.layout(lay[0], 1, 1, [0], int(lay[4]) & ~nf.UNPREMUL)
            vals = unpack_reference(rowsv[:h], cw, one)[..., 0]
            code = int(lay[3])
            for b in range(bands):
                if (code >> (4 * b)) & 15 == plane:
                    out[y:y + h, x:x + w, b] = vals[:, :w]
        else:
            out[y:y + h, x:x + w] = unpack_reference(rowsv[:h], cw,
                                                     lay)[:, :w]
    return out
