// TIFF strip and tile decoder for the input pipeline: the data of IFD 0's
// strips or tiles to the samples of the mode Pillow 12 opens the file in.
//
// `formats.py:tiff_stream` reads the IFD (either byte order), decides the
// mode and the unpack layout as Pillow's `TiffImageFile` does, and cuts
// the strips or tiles; Deflate goes through Python's zlib.  This file:
//
// - tiff_decompress  PackBits (32773) and LZW (5: MSB-first codes of 9-12
//                    bits, clear 256, end 257, the width one code earlier
//                    than GIF's, as libtiff reads it) into `need` bytes;
//                    returns the bytes written (fewer when the data ends)
//                    or -1;
// - tiff_predict     undoes horizontal differencing (predictor 2) on each
//                    row, per sample, at 8 bits and at 16 (in the file's
//                    byte order);
// - tiff_place       unpacks a chunk's rows by the layout
//                    (`formats_common.h`) into the image at (x, y),
//                    clipped to the image; planar data (spp 1 in the
//                    chunk) goes to the output bands that take plane
//                    `plane`.
//
// Each returns -1 with `format_error_message()` saying why on a code past
// the LZW table, a row or chunk larger than its buffer, a layout out of
// range.
//
// Build: g++ -O3 -shared -fPIC tiff_dec.cpp -o tiff_dec.so

#include <algorithm>
#include <vector>

#include "formats_common.h"

namespace {

using fmt::fail;

long packbits(const uint8_t* d, long n, uint8_t* out, long need) {
    long pos = 0, o = 0;
    while (o < need && pos < n) {
        int c = d[pos++];
        if (c < 128) {
            long len = c + 1;
            if (pos + len > n) len = n - pos;
            if (o + len > need) len = need - o;
            std::memcpy(out + o, d + pos, len);
            o += len;
            pos += c + 1;
        } else if (c > 128) {
            if (pos >= n) break;
            long len = 257 - c;
            if (o + len > need) len = need - o;
            std::memset(out + o, d[pos++], len);
            o += len;
        }
    }
    return o;
}

long lzw(const uint8_t* d, long n, uint8_t* out, long need) {
    struct Entry { int prefix; uint8_t first, last; int len; };
    std::vector<Entry> tab(4096);
    std::vector<uint8_t> stack(4097);
    for (int i = 0; i < 256; ++i) tab[i] = {-1, (uint8_t)i, (uint8_t)i, 1};
    int next = 258, size = 9, prev = -1;
    uint64_t acc = 0;
    int nbits = 0;
    long pos = 0, o = 0;
    while (o < need) {
        while (nbits < size && pos < n) {
            acc = (acc << 8) | d[pos++];
            nbits += 8;
        }
        if (nbits < size) break;
        int code = (int)((acc >> (nbits - size)) & ((1u << size) - 1));
        nbits -= size;
        acc &= (nbits ? ((uint64_t)1 << nbits) - 1 : 0);
        if (code == 256) {
            next = 258;
            size = 9;
            prev = -1;
            continue;
        }
        if (code == 257) break;
        int cur;
        if (prev < 0) {
            if (code > 255) fail("TIFF LZW code before any string");
            cur = code;
        } else if (code < next) {
            cur = code;
            if (next < 4096) {
                tab[next] = {prev, tab[prev].first, tab[code].first,
                             tab[prev].len + 1};
                ++next;
            }
        } else if (code == next && next < 4096) {
            tab[next] = {prev, tab[prev].first, tab[prev].first,
                         tab[prev].len + 1};
            cur = next++;
        } else {
            fail("TIFF LZW code past the table");
        }
        int len = tab[cur].len, k = cur;
        for (int i = len - 1; i >= 0; --i) {
            stack[i] = tab[k].last;
            k = tab[k].prefix;
        }
        for (int i = 0; i < len && o < need; ++i) out[o++] = stack[i];
        prev = cur;
        if (next + 1 >= (1 << size) && size < 12) ++size;
    }
    return o;
}

}  // namespace

extern "C" long tiff_decompress(int compression, const uint8_t* data, long n,
                                uint8_t* out, long need) {
    long got = 0;
    int rc = fmt::guarded([&] {
        if (compression == 32773) got = packbits(data, n, out, need);
        else if (compression == 5) got = lzw(data, n, out, need);
        else fail("TIFF compression not decoded here");
    });
    return rc ? -1 : got;
}

extern "C" int tiff_predict(uint8_t* buf, int rows, long row_bytes, int spp,
                            int bits, int big) {
    return fmt::guarded([&] {
        if (spp < 1 || rows < 0 || row_bytes < 0) fail("invalid predictor "
                                                        "arguments");
        for (int r = 0; r < rows; ++r) {
            uint8_t* row = buf + (long)r * row_bytes;
            if (bits == 8) {
                for (long i = spp; i < row_bytes; ++i)
                    row[i] = (uint8_t)(row[i] + row[i - spp]);
            } else if (bits == 16) {
                long words = row_bytes / 2;
                auto get = [&](long i) -> uint32_t {
                    return big ? (uint32_t)row[2 * i] << 8 | row[2 * i + 1]
                               : (uint32_t)row[2 * i + 1] << 8 | row[2 * i];
                };
                for (long i = spp; i < words; ++i) {
                    uint32_t v = (get(i) + get(i - spp)) & 0xFFFF;
                    if (big) {
                        row[2 * i] = (uint8_t)(v >> 8);
                        row[2 * i + 1] = (uint8_t)v;
                    } else {
                        row[2 * i] = (uint8_t)v;
                        row[2 * i + 1] = (uint8_t)(v >> 8);
                    }
                }
            } else {
                fail("TIFF predictor 2 below 8 bits");
            }
        }
    });
}

extern "C" int tiff_place(const uint8_t* chunk, int cw, int rows,
                          long row_bytes, int x0, int y0, int plane,
                          const int32_t* layout, void* out, int width,
                          int height) {
    return fmt::guarded([&] {
        fmt::Layout lay(layout);
        if (cw <= 0 || rows < 0 || x0 < 0 || y0 < 0 || width <= 0 ||
            height <= 0)
            fail("invalid chunk placement");
        if (lay.flags & (fmt::kP555 | fmt::kP565))
            fail("invalid unpack layout");      // BMP's pixels, not TIFF's
        const bool planar = plane >= 0 && lay.spp == 1 && lay.bands > 1;
        fmt::Layout one = lay;
        if (planar) {
            one.bands = 1;
            one.code = 0;
            one.flags &= ~fmt::kUnpremul;
        }
        if (row_bytes < one.row_bytes(cw)) fail("TIFF chunk rows shorter "
                                                "than their pixels");
        const int h = std::min(rows, height - y0);
        const int w = std::min(cw, width - x0);
        if (h <= 0 || w <= 0) return;
        const int ob = lay.out_bytes();
        std::vector<uint8_t> tmp((size_t)cw * one.bands * ob);
        uint8_t* o = static_cast<uint8_t*>(out);
        for (int r = 0; r < h; ++r) {
            fmt::unpack_row(chunk + (long)r * row_bytes, cw, one, tmp.data());
            uint8_t* dst = o + ((long)(y0 + r) * width + x0) * lay.bands * ob;
            if (!planar) {
                std::memcpy(dst, tmp.data(), (size_t)w * lay.bands * ob);
                continue;
            }
            for (int b = 0; b < lay.bands; ++b) {
                if (lay.src(b) != plane) continue;
                for (int x = 0; x < w; ++x)
                    std::memcpy(dst + ((long)x * lay.bands + b) * ob,
                                tmp.data() + (long)x * ob, ob);
            }
        }
    });
}
