// GIF image decoder for the input pipeline: the LZW data of frame 0 to
// its palette indices.
//
// `formats.py:gif_stream` reads the screen, the palettes, the graphic
// control extension and the image descriptor, and joins the image data's
// sub-blocks; this file decodes the codes (LSB first, `min_code` + 1 bits
// after each clear code, one bit more once the table's next entry is
// 2^bits, up to 12; a full table of 4096 entries takes no more until the
// next clear code) and writes the indices row by row, in the interlaced
// order (rows 0, 8, ...; 4, 12, ...; 2, 6, ...; 1, 3, ...) when the frame
// is interlaced.  The codes stop at the end code, at the end of the data
// or when the frame is full; pixels they did not reach are left as the
// caller filled them.  The frame is placed on its canvas by formats.py.
//
// Entry point (C, bound by ctypes in formats.py):
//   gif_decode  returns the pixels written, or -1 with
//               `format_error_message()` saying why: a code before any
//               string, a code past the table, a minimum code size out of
//               range, an output buffer of the wrong size.
//
// Build: g++ -O3 -shared -fPIC gif_dec.cpp -o gif_dec.so

#include <vector>

#include "formats_common.h"

namespace {

using fmt::fail;

struct Entry {
    int prefix;      // previous entry, -1 for a root
    uint8_t first;   // the string's first byte
    uint8_t last;    // its last byte
    int len;
};

long decode(const uint8_t* d, long n, int min_code, int w, int h,
            bool interlace, uint8_t* out) {
    const int clear = 1 << min_code, end = clear + 1;
    std::vector<Entry> tab(4096);
    std::vector<uint8_t> stack(4097);
    for (int i = 0; i < clear; ++i) tab[i] = {-1, (uint8_t)i, (uint8_t)i, 1};
    int next = end + 1, size = min_code + 1, prev = -1;
    uint32_t acc = 0;
    int nbits = 0;
    long pos = 0, written = 0;
    const long total = (long)w * h;
    // the row order of the data
    std::vector<int> rows;
    rows.reserve(h);
    if (interlace) {
        const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
        for (int p = 0; p < 4; ++p)
            for (int y = start[p]; y < h; y += step[p]) rows.push_back(y);
    } else {
        for (int y = 0; y < h; ++y) rows.push_back(y);
    }
    auto emit = [&](uint8_t v) {
        if (written < total) {
            out[(long)rows[written / w] * w + written % w] = v;
            ++written;
        }
    };
    while (written < total) {
        while (nbits < size && pos < n) {
            acc |= (uint32_t)d[pos++] << nbits;
            nbits += 8;
        }
        if (nbits < size) break;
        int code = acc & ((1u << size) - 1);
        acc >>= size;
        nbits -= size;
        if (code == clear) {
            next = end + 1;
            size = min_code + 1;
            prev = -1;
            continue;
        }
        if (code == end) break;
        int cur;
        if (prev < 0) {
            if (code >= clear) fail("GIF LZW code before any string");
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
            fail("GIF LZW code past the table");
        }
        // the string of `cur`, last byte first
        int len = tab[cur].len, k = cur;
        for (int i = len - 1; i >= 0; --i) {
            stack[i] = tab[k].last;
            k = tab[k].prefix;
        }
        for (int i = 0; i < len && written < total; ++i) emit(stack[i]);
        prev = cur;
        if (next == (1 << size) && size < 12) ++size;
    }
    return written;
}

}  // namespace

extern "C" long gif_decode(const uint8_t* data, long n, int min_code, int w,
                           int h, int interlace, uint8_t* out, long out_n) {
    long written = 0;
    int rc = fmt::guarded([&] {
        if (min_code < 1 || min_code > 11)
            fail("GIF LZW minimum code size out of range");
        if (w <= 0 || h <= 0 || out_n != (long)w * h)
            fail("output buffer of the wrong size");
        written = decode(data, n, min_code, w, h, interlace, out);
    });
    return rc ? -1 : written;
}
