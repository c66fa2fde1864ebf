#!/usr/bin/env python3
"""Write the BMP, GIF and TIFF fixtures of the port's decoder tests and
their manifest.

    python3 tools/make_image_fixtures.py [--out tests/data] [--check]

Writes small files from seeded synthetic content under
`tests/data/{bmp,gif,tiff}`, one for each case of the decoders' scope
(`apla_tpu_torch/native/formats.py`).  Pillow writes what it can (BMP 1,
8, 24 and 32 bit; GIF interlaced or not, L and P, with a transparency
index; TIFF `raw`, `packbits`, `tiff_lzw` and `tiff_deflate`); the
encoders below write the rest: BMP RLE8 and RLE4 (runs, absolute runs of
odd length, end of line, delta, end of bitmap), 16-bit 555 and 565,
core / V4 / V5 headers, top-down rows and the 32-bit bit fields with an
alpha mask; GIF87a, a local palette, a frame smaller than its screen at
an offset, 2-bit codes, and an image whose codes fill the LZW table (12
bits and clear codes); TIFF big-endian, tiles, planar RGB, predictor 2 at
8 and 16 bits, min-is-white at 1, 4 and 8 bits, 16-bit grey and RGB, RGB
with an associated and an unassociated alpha, a 4-bit palette and grey +
alpha.  Three 224 x 224 files (`*_224.*`, smooth content that compresses)
are what the card's check times.  Beside them, streams the decoders
refuse (`tiff/refused_*.tif`: JPEG-in-TIFF, CCITT, LogLuv, YCbCr, CMYK),
with the TIFF compression or photometric tag set and no valid data.

Then `manifest.json` in each directory: each decodable file's mode, size
and the sha256 of Pillow 12.1's `Image.open(...).convert("RGB")`, "L"
and "RGBA" (`rgb`, `l`, `rgba`), and of the JAX package's raw mode at 224
(`raw224`: `BaseSet.__getitem__` with `raw_size` 224); a refused file's
entry holds its refusal (`refused`: the tag).  Needs Pillow and the JAX
package's data modules, so it runs where the CPU tests run.  `--check`
writes nothing and exits 1 if a file or a manifest differs from what it
would write.
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


def _rng(seed):
    return np.random.default_rng(seed)


def _smooth(h, w, c, seed, noise=4):
    """Smooth content: gradients plus a little noise (compresses)."""
    rng = _rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(xx * (60 + 40 * k) // max(w, 1) + yy * (90 - 20 * k)
              // max(h, 1) + rng.integers(0, noise, (h, w))) % 256
             for k in range(c)]
    return np.stack(chans, -1).astype(np.uint8)


def _palette(n, seed):
    return _rng(seed).integers(0, 256, (n, 3), dtype=np.uint8)


# --------------------------------------------------------------------------- #
# BMP
# --------------------------------------------------------------------------- #

def _bmp(width, height, bits, pixels, palette=b"", header=40, comp=0,
         masks=None, colors=0, top_down=False):
    """A BMP file: file header, info header of `header` bytes (12 core,
    40 info, 108 V4, 124 V5), bit-field masks, palette, pixel data."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        h = -height if top_down else height
        info = struct.pack("<IiiHHIIiiII", header, width, h, 1, bits, comp,
                           len(pixels), 2835, 2835, colors, 0)
        extra = b""
        if masks is not None and header >= 52:
            extra = struct.pack("<4I", *(list(masks) + [0])[:4])
        info += extra + bytes(header - len(info) - len(extra))
        if masks is not None and header == 40:
            info += struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(palette)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    return head + info + palette + pixels


def _rows(data: np.ndarray, stride: int, top_down=False) -> bytes:
    h = data.shape[0]
    out = np.zeros((h, stride), np.uint8)
    out[:, :data.shape[1]] = data
    return (out if top_down else out[::-1]).tobytes()


def _pack_bits(idx: np.ndarray, bits: int) -> np.ndarray:
    h, w = idx.shape
    per = 8 // bits
    pad = -w % per
    flat = np.concatenate([idx, np.zeros((h, pad), idx.dtype)], 1).astype(
        np.uint32).reshape(h, -1, per)
    shifts = bits * np.arange(per - 1, -1, -1, dtype=np.uint32)
    return (flat << shifts).sum(-1).astype(np.uint8)


def _stride(w, bits):
    return ((w * bits + 31) >> 3) & ~3


def _bmp_pal(pal, pad=4):
    return b"".join(bytes([b, g, r]) + bytes(pad - 3) for r, g, b in pal)


def _rle8(idx: np.ndarray) -> bytes:
    """RLE8 of bottom-up rows: runs, absolute runs (odd lengths padded),
    end of line; a delta that skips two pixels on the last row; the end of
    bitmap."""
    out = bytearray()
    h, w = idx.shape
    for r, row in enumerate(idx[::-1]):
        x = 0
        if r == h - 1 and w > 6:
            out += bytes([row[0], row[0]])        # one pixel ...
            out += b"\x00\x02\x00\x00\x02\x00"    # ... Pillow's delta (+2)
            x = 3
        while x < w:
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, row[x]])
                x += n
            else:
                m = min(w - x, 7)
                out += bytes([0, m]) + bytes(row[x:x + m])
                if m % 2:
                    out += b"\x00"
                x += m
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def _rle4(idx: np.ndarray) -> bytes:
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            if x + 4 <= w and row[x] == row[x + 2] \
                    and row[x + 1] == row[x + 3]:
                n = 4
                while x + n < w and row[x + n] == row[x + n - 2] and n < 255:
                    n += 1
                out += bytes([n, (row[x] << 4) | row[x + 1]])
                x += n
            else:
                m = min(w - x, 5)           # odd: Pillow keeps m // 2 bytes
                vals = list(row[x:x + m]) + [0]
                data = bytes((vals[i] << 4) | vals[i + 1]
                             for i in range(0, m - 1, 2))
                if m < 3:
                    out += bytes([m, (vals[0] << 4) | vals[min(1, m - 1)]])
                else:
                    out += bytes([0, m]) + data
                    if len(data) % 2:
                        out += b"\x00"
                x += m
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def bmp_fixtures() -> dict:
    from PIL import Image
    out = {}

    def pil(arr, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "BMP", **kw)
        return buf.getvalue()

    rgb = _smooth(13, 19, 3, 1)
    out["rgb24_pillow.bmp"] = pil(rgb, "RGB")
    out["l8_pillow.bmp"] = pil(_smooth(11, 14, 1, 2)[..., 0], "L")
    bw = Image.fromarray(_rng(3).integers(0, 2, (9, 21), dtype=np.uint8)
                         * 255, "L").convert("1")
    buf = io.BytesIO()
    bw.save(buf, "BMP")
    out["bw1_pillow.bmp"] = buf.getvalue()
    p = Image.fromarray(_rng(4).integers(0, 7, (10, 12), dtype=np.uint8), "P")
    p.putpalette(_palette(7, 5).tobytes())
    buf = io.BytesIO()
    p.save(buf, "BMP")
    out["p8_pillow.bmp"] = buf.getvalue()
    out["rgba32_pillow.bmp"] = pil(_smooth(8, 9, 4, 6), "RGBA")
    # own encoder
    for bits, w, h, seed in ((1, 21, 7, 10), (4, 11, 9, 11), (8, 13, 6, 12)):
        n = 1 << bits
        idx = _rng(seed).integers(0, n, (h, w), dtype=np.uint8)
        pal = _palette(n, seed)
        out[f"p{bits}.bmp"] = _bmp(w, h, bits, _rows(_pack_bits(idx, bits)
                                                     if bits < 8 else idx,
                                                     _stride(w, bits)),
                                   _bmp_pal(pal))
    idx = _rng(13).integers(0, 200, (7, 10), dtype=np.uint8)
    out["p8_topdown_v5.bmp"] = _bmp(10, 7, 8, _rows(idx, 12, top_down=True),
                                    _bmp_pal(_palette(200, 13)), header=124,
                                    colors=200, top_down=True)
    grey = _smooth(6, 9, 1, 14)[..., 0]
    out["l8_topdown.bmp"] = _bmp(9, 6, 8, _rows(grey, 12, top_down=True),
                                 _bmp_pal([(i, i, i) for i in range(256)]),
                                 top_down=True)
    rgb = _smooth(7, 10, 3, 15)
    out["rgb24_core.bmp"] = _bmp(10, 7, 24, _rows(rgb[..., ::-1].reshape(
        7, -1), _stride(10, 24)), header=12)
    out["rgb24_v5.bmp"] = _bmp(10, 7, 24, _rows(rgb[..., ::-1].reshape(7, -1),
                                                _stride(10, 24)), header=124)
    v = _rng(16).integers(0, 1 << 16, (5, 11), dtype=np.uint32)
    px = np.stack([v & 255, v >> 8], -1).astype(np.uint8).reshape(5, -1)
    out["rgb16_555.bmp"] = _bmp(11, 5, 16, _rows(px, _stride(11, 16)))
    out["rgb16_565_fields.bmp"] = _bmp(11, 5, 16, _rows(px, _stride(11, 16)),
                                       comp=3, masks=(0xF800, 0x7E0, 0x1F))
    out["rgb16_555_fields_v4.bmp"] = _bmp(
        11, 5, 16, _rows(px, _stride(11, 16)), header=108, comp=3,
        masks=(0x7C00, 0x3E0, 0x1F, 0))
    q = _rng(17).integers(0, 256, (6, 8, 4), dtype=np.uint8)
    out["rgb32_rgb.bmp"] = _bmp(8, 6, 32, _rows(q.reshape(6, -1), 32))
    out["rgba32_fields_v4.bmp"] = _bmp(8, 6, 32, _rows(q.reshape(6, -1), 32),
                                       header=108, comp=3,
                                       masks=(0xFF0000, 0xFF00, 0xFF,
                                              0xFF000000))
    out["rgba32_abgr_v5.bmp"] = _bmp(8, 6, 32, _rows(q.reshape(6, -1), 32),
                                     header=124, comp=3,
                                     masks=(0xFF000000, 0xFF0000, 0xFF00,
                                            0xFF))
    out["rgb32_xbgr_fields.bmp"] = _bmp(8, 6, 32,
                                        _rows(q.reshape(6, -1), 32), comp=3,
                                        masks=(0xFF000000, 0xFF0000, 0xFF00))
    runs = np.repeat(_rng(18).integers(0, 9, (11, 5), dtype=np.uint8), 4,
                     axis=1)[:, :17]
    runs[3, 2:9] = np.arange(7)
    out["rle8.bmp"] = _bmp(17, 11, 8, _rle8(runs), _bmp_pal(_palette(9, 18)),
                           comp=1)
    r4 = np.repeat(_rng(19).integers(0, 16, (8, 6), dtype=np.uint8), 3,
                   axis=1)[:, :15]
    r4[2, :6] = [1, 2, 1, 2, 1, 2]
    out["rle4.bmp"] = _bmp(15, 8, 4, _rle4(r4), _bmp_pal(_palette(16, 19)),
                           comp=2)
    g224 = _smooth(224, 224, 1, 20, noise=1)[..., 0] // 4
    out["rle8_224.bmp"] = _bmp(224, 224, 8, _rle8(g224),
                               _bmp_pal(_palette(256, 20)), comp=1)
    return out


# --------------------------------------------------------------------------- #
# GIF
# --------------------------------------------------------------------------- #

def gif_lzw(idx: bytes, min_code: int) -> bytes:
    """GIF LZW (LSB-first codes; a clear code first and whenever the table
    is full)."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    out, acc, nbits = bytearray(), 0, 0

    def put(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table = {bytes([i]): i for i in range(clear)}
    nxt, size = end + 1, min_code + 1
    put(clear, size)
    cur = b""
    for v in idx:
        s = cur + bytes([v])
        if s in table:
            cur = s
            continue
        put(table[cur], size)
        table[s] = nxt
        nxt += 1
        if nxt > (1 << size) and size < 12:
            size += 1
        if nxt >= 4096:
            put(clear, size)
            table = {bytes([i]): i for i in range(clear)}
            nxt, size = end + 1, min_code + 1
        cur = bytes([v])
    if cur:
        put(table[cur], size)
    put(end, size)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _gif(screen, frame, idx, gpal=None, lpal=None, trans=None, interlace=False,
         min_code=8, version=b"GIF89a"):
    sw, sh = screen
    x0, y0 = frame
    h, w = idx.shape
    flags = 0
    gbytes = b""
    if gpal is not None:
        bits = max(1, int(np.ceil(np.log2(len(gpal)))))
        flags = 0x80 | (bits - 1)
        gbytes = np.resize(gpal, (1 << bits, 3)).astype(np.uint8).tobytes()
    out = version + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + gbytes
    if trans is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, trans]) + b"\x00"
    fl = 0x40 if interlace else 0
    lbytes = b""
    if lpal is not None:
        bits = max(1, int(np.ceil(np.log2(len(lpal)))))
        fl |= 0x80 | (bits - 1)
        lbytes = np.resize(lpal, (1 << bits, 3)).astype(np.uint8).tobytes()
    rows = [y for s, st in ((0, 8), (4, 8), (2, 4), (1, 2))
            for y in range(s, h, st)] if interlace else list(range(h))
    data = idx[rows].tobytes()
    out += b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, fl) + lbytes
    out += bytes([min_code]) + _blocks(gif_lzw(data, min_code)) + b"\x3b"
    return out


def gif_fixtures() -> dict:
    from PIL import Image
    out = {}
    idx = _rng(30).integers(0, 20, (12, 17), dtype=np.uint8)
    pal = _palette(32, 30)
    for il in (True, False):
        im = Image.fromarray(idx, "P")
        im.putpalette(pal.tobytes())
        buf = io.BytesIO()
        im.save(buf, "GIF", interlace=il)
        out[f"p_pillow{'_interlaced' if il else ''}.gif"] = buf.getvalue()
    im = Image.fromarray(idx, "P")
    im.putpalette(pal.tobytes())
    buf = io.BytesIO()
    im.save(buf, "GIF", transparency=3)
    out["p_pillow_transparency.gif"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(_smooth(9, 15, 1, 31)[..., 0], "L").save(buf, "GIF")
    out["l_pillow.gif"] = buf.getvalue()
    # own encoder
    small = _rng(32).integers(0, 4, (10, 13), dtype=np.uint8)
    out["p2_gif87a.gif"] = _gif((13, 10), (0, 0), small, gpal=_palette(4, 32),
                                min_code=2, version=b"GIF87a")
    out["p_local_interlaced.gif"] = _gif(
        (17, 12), (0, 0), idx, gpal=_palette(4, 33), lpal=pal,
        interlace=True)
    out["p_frame_offset.gif"] = _gif((23, 19), (5, 4), idx, gpal=pal)
    out["p_frame_offset_transparency.gif"] = _gif((23, 19), (3, 6), idx,
                                                  gpal=pal, trans=7)
    ramp = np.arange(256)[:, None].repeat(3, 1)
    grey = _smooth(11, 14, 1, 34)[..., 0]
    out["l_ramp_transparency.gif"] = _gif((14, 11), (0, 0), grey, gpal=ramp,
                                          trans=grey[0, 0])
    noise = _rng(35).integers(0, 256, (64, 80), dtype=np.uint8)
    out["p_table_full.gif"] = _gif((80, 64), (0, 0), noise,
                                   gpal=_palette(256, 35))
    g224 = (_smooth(224, 224, 1, 36, noise=1)[..., 0] // 8).astype(np.uint8)
    out["p_224.gif"] = _gif((224, 224), (0, 0), g224, gpal=_palette(32, 36))
    return out


# --------------------------------------------------------------------------- #
# TIFF
# --------------------------------------------------------------------------- #

def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        n = 1
        while i + n < len(data) and data[i + n] == data[i] and n < 128:
            n += 1
        if n >= 2:
            out += bytes([257 - n, data[i]])
            i += n
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes, a clear code first, the code width one
    code earlier than GIF's (libtiff's encoder)."""
    out, acc, nbits = bytearray(), 0, 0

    def put(code, size):
        nonlocal acc, nbits
        acc = (acc << size) | code
        nbits += size
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 255)
            nbits -= 8
        acc &= (1 << nbits) - 1

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, size = reset()
    put(256, size)
    cur = b""
    for v in data:
        s = cur + bytes([v])
        if s in table:
            cur = s
            continue
        put(table[cur], size)
        table[s] = nxt
        nxt += 1
        if nxt >= (1 << size) and size < 12:
            size += 1
        if nxt >= 4093:
            put(256, size)
            table, nxt, size = reset()
        cur = bytes([v])
    if cur:
        put(table[cur], size)
        if nxt + 1 >= (1 << size) and size < 12:
            size += 1
    put(257, size)
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def _predict(rows: np.ndarray, spp: int, bits: int, big: bool) -> bytes:
    h = rows.shape[0]
    if bits == 8:
        v = rows.reshape(h, -1, spp).astype(np.int64)
        d = np.concatenate([v[:, :1], np.diff(v, axis=1)], 1) & 255
        return d.astype(np.uint8).tobytes()
    dt = ">u2" if big else "<u2"
    v = rows.view(dt).reshape(h, -1, spp).astype(np.int64)
    d = np.concatenate([v[:, :1], np.diff(v, axis=1)], 1) & 0xFFFF
    return d.astype(dt).tobytes()


def _compress(raw: bytes, comp: int) -> bytes:
    if comp == 5:
        return tiff_lzw(raw)
    if comp in (8, 32946):
        return zlib.compress(raw, 9)
    if comp == 32773:
        return packbits(raw)
    return raw


def _tiff(samples: np.ndarray, bits: int, photo: int, comp=1, big=False,
          predictor=1, rps=None, tile=None, planar=1, extra=(), cmap=None):
    """A TIFF file of [h, w, spp] samples (bits 1-16, packed MSB first)."""
    h, w, spp = samples.shape
    bo = ">" if big else "<"
    dt = (">u2" if big else "<u2") if bits == 16 else np.uint8

    def pack(arr):                      # [rows, cols, c] -> [rows, bytes]
        r = arr.shape[0]
        flat = arr.reshape(r, -1)
        if bits == 16:
            return flat.astype(dt).view(np.uint8).reshape(r, -1)
        if bits == 8:
            return flat.astype(np.uint8)
        return _pack_bits(flat.astype(np.uint8), bits)

    planes = [samples] if planar == 1 else \
        [samples[..., k:k + 1] for k in range(spp)]
    cspp = spp if planar == 1 else 1
    chunks = []
    if tile:
        tw, th = tile
        for pl in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, cspp), samples.dtype)
                    part = pl[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(pack(t))
    else:
        rps = rps or h
        for pl in planes:
            for y in range(0, h, rps):
                chunks.append(pack(pl[y:y + rps]))
    data = []
    for c in chunks:
        raw = _predict(c, cspp, bits, big) if predictor == 2 else c.tobytes()
        data.append(_compress(raw, comp))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
            284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if cmap is not None:
        tags[320] = (3, [int(v) for v in cmap])
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
        tags[324] = (4, [0] * len(data))
        tags[325] = (4, [len(d) for d in data])
    else:
        tags[278] = (3, [rps])
        tags[273] = (4, [0] * len(data))
        tags[279] = (4, [len(d) for d in data])
    head = (b"MM\x00*" if big else b"II*\x00")
    ifd_at = 8
    n = len(tags)
    blob_at = ifd_at + 2 + 12 * n + 4
    blobs, entries = bytearray(), []
    fmt = {3: "H", 4: "I"}
    # the image data after the IFD's out-of-line values
    for tag in sorted(tags):
        typ, vals = tags[tag]
        size = struct.calcsize(fmt[typ]) * len(vals)
        entries.append([tag, typ, vals, size])
    offs_tag = 324 if tile else 273
    out_of_line = sum(e[3] + (e[3] & 1) for e in entries if e[3] > 4)
    data_at = blob_at + out_of_line
    pos = data_at
    starts = []
    for d in data:
        starts.append(pos)
        pos += len(d) + (len(d) & 1)
    for e in entries:
        if e[0] == offs_tag:
            e[2] = starts
    ifd = struct.pack(bo + "H", n)
    for tag, typ, vals, size in entries:
        body = struct.pack(f"{bo}{len(vals)}{fmt[typ]}", *vals)
        if size <= 4:
            ifd += struct.pack(bo + "HHI", tag, typ, len(vals)) + \
                body + bytes(4 - size)
        else:
            ifd += struct.pack(bo + "HHII", tag, typ, len(vals),
                               blob_at + len(blobs))
            blobs += body + bytes(size & 1)
    ifd += struct.pack(bo + "I", 0)
    out = head + struct.pack(bo + "I", ifd_at) + ifd + bytes(blobs)
    assert len(out) == data_at
    for d in data:
        out += d + bytes(len(d) & 1)
    return out


def tiff_fixtures() -> dict:
    from PIL import Image
    out = {}
    rgb = _smooth(12, 15, 3, 40)
    for comp in ("raw", "packbits", "tiff_lzw", "tiff_deflate"):
        buf = io.BytesIO()
        Image.fromarray(rgb, "RGB").save(buf, "TIFF", compression=comp)
        out[f"rgb8_pillow_{comp}.tif"] = buf.getvalue()
    for mode, arr in (("L", _smooth(9, 11, 1, 41)[..., 0]),
                      ("RGBA", _smooth(7, 9, 4, 42))):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "TIFF", compression="tiff_lzw")
        out[f"{mode.lower()}_pillow_lzw.tif"] = buf.getvalue()
    bw = Image.fromarray(_rng(43).integers(0, 2, (9, 19), dtype=np.uint8)
                         * 255, "L").convert("1")
    buf = io.BytesIO()
    bw.save(buf, "TIFF", compression="packbits")
    out["bw1_pillow_packbits.tif"] = buf.getvalue()
    p = Image.fromarray(_rng(44).integers(0, 9, (8, 10), dtype=np.uint8), "P")
    p.putpalette(_palette(9, 44).tobytes())
    buf = io.BytesIO()
    p.save(buf, "TIFF", compression="tiff_deflate")
    out["p8_pillow_deflate.tif"] = buf.getvalue()
    # own encoder
    g8 = _smooth(10, 13, 1, 45)
    out["l8_be_strips_lzw_pred.tif"] = _tiff(g8, 8, 1, comp=5, big=True,
                                             predictor=2, rps=3)
    out["l8_miniswhite_packbits.tif"] = _tiff(g8, 8, 0, comp=32773, rps=4)
    g4 = (_smooth(9, 11, 1, 46) % 16).astype(np.uint8)
    out["l4_miniswhite_be.tif"] = _tiff(g4, 4, 0, big=True)
    out["l2_deflate8.tif"] = _tiff(g4 % 4, 2, 1, comp=8)
    b1 = _rng(47).integers(0, 2, (8, 13, 1), dtype=np.uint8)
    out["bw1_miniswhite_lzw.tif"] = _tiff(b1, 1, 0, comp=5)
    g16 = _rng(48).integers(0, 1 << 16, (7, 9, 1)).astype(np.uint16)
    g16[0, :3, 0] = [0, 200, 255]
    out["i16_deflate_pred.tif"] = _tiff(g16, 16, 1, comp=32946, predictor=2)
    out["i16_be.tif"] = _tiff(g16, 16, 1, big=True, rps=2)
    out["i16_miniswhite.tif"] = _tiff(g16, 16, 0)
    rgb16 = _rng(49).integers(0, 1 << 16, (6, 8, 3)).astype(np.uint16)
    out["rgb16_lzw_pred.tif"] = _tiff(rgb16, 16, 2, comp=5, predictor=2)
    out["rgb16_be_planar_deflate.tif"] = _tiff(rgb16, 16, 2, comp=8,
                                               big=True, planar=2, rps=4)
    out["rgb8_planar.tif"] = _tiff(rgb, 8, 2, planar=2, rps=5)
    out["rgb8_planar_lzw.tif"] = _tiff(rgb, 8, 2, comp=5, planar=2)
    out["rgb8_tiles_deflate_pred.tif"] = _tiff(rgb, 8, 2, comp=8, predictor=2,
                                               tile=(16, 16))
    big_rgb = _smooth(37, 40, 3, 50)
    out["rgb8_tiles_be_packbits.tif"] = _tiff(big_rgb, 8, 2, comp=32773,
                                              big=True, tile=(16, 16))
    out["rgb8_tiles_raw.tif"] = _tiff(big_rgb, 8, 2, tile=(32, 16))
    rgba = _rng(51).integers(0, 256, (6, 7, 4), dtype=np.uint8)
    rgba[0, 0, 3] = 0
    rgba[0, 1, 3] = 255
    pre = rgba.copy()
    pre[..., :3] = (rgba[..., :3].astype(np.int64) * rgba[..., 3:4]
                    // 255).astype(np.uint8)
    out["rgba8_associated_lzw.tif"] = _tiff(pre, 8, 2, comp=5, extra=(1,))
    out["rgba8_unassociated.tif"] = _tiff(rgba, 8, 2, extra=(2,))
    out["rgbx8_unspecified_deflate.tif"] = _tiff(rgba, 8, 2, comp=8,
                                                 extra=(0,))
    idx = _rng(52).integers(0, 16, (7, 11, 1), dtype=np.uint8)
    cmap = _rng(52).integers(0, 1 << 16, 48)
    out["p4_lzw.tif"] = _tiff(idx, 4, 3, comp=5, cmap=cmap)
    la = _smooth(6, 9, 2, 53)
    out["la8_packbits.tif"] = _tiff(la, 8, 1, comp=32773, extra=(2,))
    out["rgb8_deflate_pred_224.tif"] = _tiff(
        _smooth(224, 224, 3, 54, noise=1), 8, 2, comp=8, predictor=2, rps=16)
    z = np.zeros((4, 4, 1), np.uint8)
    z3 = np.zeros((4, 4, 3), np.uint8)
    for name, comp, photo, arr in (("jpeg", 7, 2, z3), ("ojpeg", 6, 2, z3),
                                   ("ccitt_g4", 4, 0, z),
                                   ("logluv", 34676, 32845, z3),
                                   ("ycbcr", 1, 6, z3),
                                   ("cmyk", 1, 5,
                                    np.zeros((4, 4, 4), np.uint8))):
        out[f"refused_{name}.tif"] = _refused_tiff(arr, comp, photo)
    return out


def _refused_tiff(arr, comp, photo):
    """A TIFF whose compression or photometric tag the decoders refuse
    (the data is the uncompressed samples)."""
    data = _tiff(arr, 8 if comp != 4 else 1, photo if photo in (0, 1, 2)
                 else 2)
    return _set_tag(_set_tag(data, 259, comp), 262, photo)


def _set_tag(data: bytes, tag: int, value: int) -> bytes:
    n = struct.unpack_from("<H", data, 8)[0]
    out = bytearray(data)
    for i in range(n):
        at = 10 + 12 * i
        if struct.unpack_from("<H", data, at)[0] == tag:
            struct.pack_into("<H", out, at + 8, value)
    return bytes(out)


# --------------------------------------------------------------------------- #
# the manifest
# --------------------------------------------------------------------------- #

def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def manifest(directory: str) -> dict:
    """Pillow's and the JAX package's decodes of every fixture in
    `directory`."""
    from PIL import Image
    sys.path.insert(0, ROOT)
    from apla_tpu.data.datasets import BaseSet

    ds = BaseSet.__new__(BaseSet)
    ds.raw_mode, ds.raw_size, ds.img_channels = True, RAW_SIZE, 3
    ds.resizing, ds.transform = None, None
    files = {}
    for name in sorted(os.listdir(directory)):
        if name == "manifest.json":
            continue
        path = os.path.join(directory, name)
        if name.startswith("refused_"):
            with open(path, "rb") as f:
                data = f.read()
            files[name] = {"refused": {
                "compression": _get_tag(data, 259),
                "photometric": _get_tag(data, 262)}}
            continue
        rec = {}
        with Image.open(path) as im:
            rec.update(mode=im.mode, width=im.size[0], height=im.size[1])
            for key, mode in (("rgb", "RGB"), ("l", "L"), ("rgba", "RGBA")):
                rec[key] = _sha(np.asarray(im.convert(mode)))
        ds.data = [{"img_path": path, "label": 0}]
        rec["raw224"] = _sha(ds.__getitem__(0)["image"])
        files[name] = rec
    return {"raw_size": RAW_SIZE, "files": files}


def _get_tag(data: bytes, tag: int) -> int:
    n = struct.unpack_from("<H", data, 8)[0]
    for i in range(n):
        at = 10 + 12 * i
        if struct.unpack_from("<H", data, at)[0] == tag:
            return struct.unpack_from("<H", data, at + 8)[0]
    return -1


FIXTURES = {"bmp": bmp_fixtures, "gif": gif_fixtures, "tiff": tiff_fixtures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    same, total, count = True, 0, 0
    for kind, make in FIXTURES.items():
        d = os.path.join(args.out, kind)
        want = make()
        if args.check:
            same &= all(os.path.exists(os.path.join(d, n))
                        and open(os.path.join(d, n), "rb").read() == b
                        for n, b in want.items())
            same &= sorted(os.listdir(d)) == sorted([*want,
                                                     "manifest.json"])
            with open(os.path.join(d, "manifest.json")) as f:
                same &= json.load(f) == manifest(d)
            continue
        os.makedirs(d, exist_ok=True)
        for name, data in want.items():
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest(d), f, indent=1, sort_keys=True)
            f.write("\n")
        total += sum(len(b) for b in want.values())
        count += len(want)
    if args.check:
        print("fixtures and manifests up to date" if same else "stale")
        return 0 if same else 1
    print(f"{count} files, {total} bytes, under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
