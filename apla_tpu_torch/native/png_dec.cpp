// PNG sample decoder for the input pipeline: the scanlines of an inflated
// PNG image stream to the pixels that Pillow gives.
//
// The JAX package reads PNG files with Pillow; the card's machine has no
// Pillow.  `__init__.py` reads the chunks and inflates the IDAT data with
// Python's zlib; this file undoes the rest:
//
// - the five scanline filters (None, Sub, Up, Average, Paeth), per pass;
// - Adam7 interlacing (seven passes, an empty pass has no rows at all);
// - every colour type at every depth the format allows: grey at 1, 2, 4,
//   8 and 16 bits, RGB at 8 and 16, palette at 1, 2, 4 and 8, grey +
//   alpha and RGBA at 8 and 16;
// - then one of two outputs:
//   * RGB uint8 [h, w, 3], as Pillow 12.1's `Image.open(...).convert
//     ("RGB")`: the samples go through the mode Pillow opens the file in
//     (grey 1 -> "1", 2 and 4 -> "L" scaled by 0x55 and 0x11, 16 ->
//     "I;16"; 16-bit colour -> the high byte of each sample; 16-bit grey
//     + alpha -> "RGBA"), then that mode's conversion (a bit -> 0 or 255,
//     I;16 clipped at 255, alpha dropped, a palette index past the PLTE
//     entries -> black);
//   * the samples of that mode, as `np.asarray` of the unconverted image
//     gives them (a palette image's indices, a bit as 0 or 1, I;16 as
//     uint16 in the host's byte order); label maps are read so.
//
// Entry point (C, bound by ctypes in __init__.py):
//   png_decode  returns 0, or 1 with `png_error_message()` saying why:
//               a filter type past 4, fewer bytes than the image needs,
//               an impossible header, an output buffer too small.
//
// Build: g++ -O3 -shared -fPIC png_dec.cpp -o png_dec.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

thread_local char g_error[256];

struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw DecodeError(what); }

// (x0, y0, dx, dy) of the seven Adam7 passes; one pass (0, 0, 1, 1) when
// the image is not interlaced
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

int channels_of(int ctype) {
    switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
    }
}

bool depth_allowed(int depth, int ctype) {
    switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2:
    case 4:
    case 6: return depth == 8 || depth == 16;
    default: return false;
    }
}

// Bands of the mode Pillow opens the file in, and the bytes of each
int raw_bands(int depth, int ctype) {
    if (ctype == 4 && depth == 16) return 4;    // "RGBA" from LA;16B
    return channels_of(ctype);
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

// Undo row `cur`'s filter against the previous row of its pass
void unfilter(int kind, uint8_t* cur, const uint8_t* prev, long n, int bpp) {
    switch (kind) {
    case 0: break;
    case 1:
        for (long i = bpp; i < n; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
    case 2:
        for (long i = 0; i < n; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
        break;
    case 3:
        for (long i = 0; i < n; ++i) {
            int left = i >= bpp ? cur[i - bpp] : 0;
            cur[i] = (uint8_t)(cur[i] + ((left + prev[i]) >> 1));
        }
        break;
    case 4:
        for (long i = 0; i < n; ++i) {
            int left = i >= bpp ? cur[i - bpp] : 0;
            int up_left = i >= bpp ? prev[i - bpp] : 0;
            cur[i] = (uint8_t)(cur[i] + paeth(left, prev[i], up_left));
        }
        break;
    default: fail("PNG filter type past 4");
    }
}

struct Image {
    int w, h, depth, ctype;
    const uint8_t* plte;
    int n_plte;
    bool raw;
    uint8_t* out;

    // sample c of pixel x in an unfiltered row, at full depth
    inline unsigned sample(const uint8_t* row, long x, int c, int ch) const {
        if (depth == 8) return row[x * ch + c];
        if (depth == 16) {
            const uint8_t* p = row + 2 * (x * ch + c);
            return (unsigned)p[0] << 8 | p[1];
        }
        long bit = (x * ch + c) * depth;       // ch == 1 below 8 bits
        int shift = 8 - depth - (int)(bit & 7);
        return (row[bit >> 3] >> shift) & ((1u << depth) - 1);
    }

    void put(const uint8_t* row, long x, long ox, long oy) const {
        const int ch = channels_of(ctype);
        const long at = oy * w + ox;
        if (raw) {
            const int bands = raw_bands(depth, ctype);
            uint8_t* o = out + at * bands * (ctype == 0 && depth == 16 ? 2 : 1);
            if (ctype == 0) {
                unsigned v = sample(row, x, 0, 1);
                if (depth == 16) {
                    uint16_t v16 = (uint16_t)v;
                    std::memcpy(o, &v16, 2);
                } else {
                    o[0] = (uint8_t)(depth == 2 ? v * 0x55
                                     : depth == 4 ? v * 0x11 : v);
                }
            } else if (ctype == 4 && depth == 16) {
                uint8_t l = (uint8_t)(sample(row, x, 0, 2) >> 8);
                o[0] = o[1] = o[2] = l;
                o[3] = (uint8_t)(sample(row, x, 1, 2) >> 8);
            } else {
                for (int c = 0; c < ch; ++c) {
                    unsigned v = sample(row, x, c, ch);
                    o[c] = (uint8_t)(depth == 16 ? v >> 8 : v);
                }
            }
            return;
        }
        uint8_t* o = out + at * 3;
        switch (ctype) {
        case 0: {
            unsigned v = sample(row, x, 0, 1);
            uint8_t g = depth == 1 ? (v ? 255 : 0)
                        : depth == 2 ? (uint8_t)(v * 0x55)
                        : depth == 4 ? (uint8_t)(v * 0x11)
                        : depth == 8 ? (uint8_t)v
                                     : (uint8_t)(v > 255 ? 255 : v);
            o[0] = o[1] = o[2] = g;
            break;
        }
        case 3: {
            unsigned i = sample(row, x, 0, 1);
            if ((int)i < n_plte) {
                o[0] = plte[3 * i];
                o[1] = plte[3 * i + 1];
                o[2] = plte[3 * i + 2];
            } else {
                o[0] = o[1] = o[2] = 0;
            }
            break;
        }
        case 4: {
            unsigned v = sample(row, x, 0, 2);
            o[0] = o[1] = o[2] = (uint8_t)(depth == 16 ? v >> 8 : v);
            break;
        }
        default:                               // RGB, RGBA
            for (int c = 0; c < 3; ++c) {
                unsigned v = sample(row, x, c, ch);
                o[c] = (uint8_t)(depth == 16 ? v >> 8 : v);
            }
        }
    }
};

void decode(const uint8_t* data, long len, const Image& im, bool interlace) {
    const int ch = channels_of(im.ctype);
    const int bits = ch * im.depth;                 // per pixel
    const int bpp = bits >= 8 ? bits / 8 : 1;
    long pos = 0;
    std::vector<uint8_t> prev, cur;
    const int passes = interlace ? 7 : 1;
    for (int p = 0; p < passes; ++p) {
        const int x0 = interlace ? kAdam7[p][0] : 0;
        const int y0 = interlace ? kAdam7[p][1] : 0;
        const int dx = interlace ? kAdam7[p][2] : 1;
        const int dy = interlace ? kAdam7[p][3] : 1;
        const long pw = im.w > x0 ? (im.w - x0 + dx - 1) / dx : 0;
        const long ph = im.h > y0 ? (im.h - y0 + dy - 1) / dy : 0;
        if (pw == 0 || ph == 0) continue;           // no rows, no filter bytes
        const long stride = (pw * bits + 7) / 8;
        prev.assign(stride, 0);
        cur.resize(stride);
        for (long r = 0; r < ph; ++r) {
            if (len - pos < stride + 1)
                fail("the image data ends before the last row");
            const int kind = data[pos];
            std::memcpy(cur.data(), data + pos + 1, stride);
            pos += stride + 1;
            unfilter(kind, cur.data(), prev.data(), stride, bpp);
            const long oy = y0 + r * dy;
            if (!interlace && im.depth == 8 && !im.raw &&
                (im.ctype == 2)) {                  // RGB8: the row as is
                std::memcpy(im.out + oy * im.w * 3, cur.data(), stride);
            } else {
                for (long c = 0; c < pw; ++c)
                    im.put(cur.data(), c, x0 + c * dx, oy);
            }
            prev.swap(cur);
        }
    }
}

int report(const char* what) {
    std::snprintf(g_error, sizeof(g_error), "%s", what);
    return 1;
}

}  // namespace

extern "C" {

const char* png_error_message() { return g_error; }

// `data`: the inflated image stream (each row's filter byte, then its
// bytes; Adam7's passes in turn); `plte`: n_plte RGB entries (colour type
// 3); `raw`: 0 for RGB uint8 [h, w, 3], 1 for the samples of Pillow's mode
// (see the top of the file); `out_cap`: the output's bytes.
int png_decode(const uint8_t* data, long len, int w, int h, int depth,
               int ctype, int interlace, const uint8_t* plte, int n_plte,
               int raw, uint8_t* out, long out_cap) {
    try {
        if (w <= 0 || h <= 0) fail("image width or height is 0");
        if ((long)w * h > (1L << 32)) fail("image past 2^32 pixels");
        if (!depth_allowed(depth, ctype))
            fail("bit depth and colour type that PNG does not allow");
        if (interlace != 0 && interlace != 1)
            fail("interlace method past 1");
        if (ctype == 3 && (n_plte < 1 || n_plte > 256 || !plte))
            fail("a palette image without 1-256 palette entries");
        long need = (long)w * h *
                    (raw ? raw_bands(depth, ctype) *
                               (ctype == 0 && depth == 16 ? 2 : 1)
                         : 3);
        if (need > out_cap) fail("output buffer too small");
        Image im{w, h, depth, ctype, plte, n_plte, raw != 0, out};
        decode(data, len, im, interlace == 1);
        return 0;
    } catch (const std::exception& e) {
        return report(e.what());
    }
}

}  // extern "C"
