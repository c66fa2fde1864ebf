// What the BMP, GIF and TIFF decoders share: the error message a failed
// call leaves, and the unpacking of stored pixels into the samples of
// Pillow's mode (`native/formats.py:layout`; its plain numpy version is
// `data/image_formats.py:unpack_reference`).
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>

namespace fmt {

inline thread_local char g_error[256];

struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] inline void fail(const char* what) { throw DecodeError(what); }

// The layout's flags (formats.py)
enum : int {
    kInvert = 1, kScale = 2, kKeep16 = 4, kBig = 8, kUnpremul = 16,
    kP555 = 32, kP565 = 64,
};

struct Layout {
    int bits, spp, bands, code, flags;
    explicit Layout(const int32_t* l)
        : bits(l[0]), spp(l[1]), bands(l[2]), code(l[3]), flags(l[4]) {
        if (!(bits == 1 || bits == 2 || bits == 4 || bits == 8 ||
              bits == 16) || spp < 1 || spp > 16 || bands < 1 || bands > 4)
            fail("invalid unpack layout");
        if ((flags & kUnpremul) && bands != 4) fail("invalid unpack layout");
        if ((flags & (kP555 | kP565)) && bands != 3)
            fail("invalid unpack layout");
    }
    int src(int b) const { return (code >> (4 * b)) & 15; }
    bool keep16() const { return flags & kKeep16; }
    int out_bytes() const { return keep16() ? 2 : 1; }
    // bytes that `width` stored pixels take
    long row_bytes(long width) const {
        if (flags & (kP555 | kP565)) return 2 * width;
        return (width * spp * bits + 7) / 8;
    }
};

// Sample `i` of a row at `bits` bits (MSB first below 8)
inline uint32_t sample(const uint8_t* row, long i, int bits, bool big) {
    switch (bits) {
    case 8: return row[i];
    case 16: return big ? (uint32_t)row[2 * i] << 8 | row[2 * i + 1]
                        : (uint32_t)row[2 * i + 1] << 8 | row[2 * i];
    default: {
        long bit = i * bits;
        int shift = 8 - bits - (int)(bit & 7);
        return (row[bit >> 3] >> shift) & ((1u << bits) - 1);
    }
    }
}

// One row of `width` stored pixels -> `out` (width x bands samples of
// `lay.out_bytes()` bytes each, the host's byte order at 16 bits).
inline void unpack_row(const uint8_t* row, long width, const Layout& lay,
                       uint8_t* out) {
    const bool big = lay.flags & kBig;
    if (lay.flags & (kP555 | kP565)) {
        for (long x = 0; x < width; ++x) {
            uint32_t v = (uint32_t)row[2 * x] | (uint32_t)row[2 * x + 1] << 8;
            uint32_t r, g, b;
            if (lay.flags & kP565) {
                r = ((v >> 11) & 31) * 255 / 31;
                g = ((v >> 5) & 63) * 255 / 63;
                b = (v & 31) * 255 / 31;
            } else {
                r = ((v >> 10) & 31) * 255 / 31;
                g = ((v >> 5) & 31) * 255 / 31;
                b = (v & 31) * 255 / 31;
            }
            out[3 * x] = (uint8_t)r;
            out[3 * x + 1] = (uint8_t)g;
            out[3 * x + 2] = (uint8_t)b;
        }
        return;
    }
    const uint32_t scale = (lay.flags & kScale) && lay.bits < 8
        ? (lay.bits == 1 ? 255 : lay.bits == 2 ? 0x55 : 0x11) : 1;
    const uint32_t top = (lay.flags & kScale) && lay.bits < 8 ? 255
        : lay.keep16() ? 65535 : 255;
    uint32_t s[16] = {};   // a band past the stored samples reads 0
    for (long x = 0; x < width; ++x) {
        for (int k = 0; k < lay.spp; ++k) {
            uint32_t v = sample(row, x * lay.spp + k, lay.bits, big);
            if (lay.bits == 16 && !lay.keep16()) v >>= 8;
            v *= scale;
            if (lay.flags & kInvert) v = top - v;
            s[k] = v;
        }
        uint32_t o[4] = {0, 0, 0, 255};
        for (int b = 0; b < lay.bands; ++b) {
            int k = lay.src(b);
            o[b] = k == 15 ? 255 : s[k];
        }
        if (lay.flags & kUnpremul) {
            uint32_t a = o[3];
            for (int b = 0; b < 3; ++b) {
                if (a == 0) o[b] = 0;
                else if (a != 255) {
                    uint32_t v = o[b] * 255 / a;
                    o[b] = v > 255 ? 255 : v;
                }
            }
        }
        if (lay.keep16()) {
            uint16_t* o16 = reinterpret_cast<uint16_t*>(out) + x * lay.bands;
            for (int b = 0; b < lay.bands; ++b) o16[b] = (uint16_t)o[b];
        } else {
            for (int b = 0; b < lay.bands; ++b)
                out[x * lay.bands + b] = (uint8_t)o[b];
        }
    }
}

// Runs `body`; 0, or -1 with the message in g_error
template <class F>
int guarded(F&& body) {
    try {
        body();
        return 0;
    } catch (const std::exception& e) {
        std::snprintf(g_error, sizeof g_error, "%s", e.what());
        return -1;
    }
}

}  // namespace fmt

extern "C" const char* format_error_message() { return fmt::g_error; }
