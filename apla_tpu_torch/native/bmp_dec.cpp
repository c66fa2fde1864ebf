// BMP pixel decoder for the input pipeline: the pixel data of a BMP
// stream to the samples of the mode Pillow 12 opens it in.
//
// `formats.py:bmp_stream` reads the headers, the palette and the bit
// fields into a layout (`formats_common.h`); this file decodes the pixel
// data from the stream's pixel offset:
//
// - uncompressed rows of `stride` bytes (a multiple of 4), bottom-up or
//   top-down, unpacked by the layout: palette indices at 1, 4 and 8 bits,
//   BGR, BGRX and the 32-bit bit-field byte orders, 555 and 565 pixels;
// - RLE8 and RLE4 as Pillow's `BmpRleDecoder` reads them: encoded runs
//   (clipped at the row's end), absolute runs (RLE4 keeps count / 2
//   bytes: an odd count loses its last pixel) aligned to a word of the
//   file, end of line (the row padded with 0), delta (Pillow reads two
//   bytes, then the two it uses), end of bitmap; the indices in data
//   order, bottom-up rows flipped.
//
// Entry point (C, bound by ctypes in formats.py):
//   bmp_decode  returns 0, or -1 with `format_error_message()` saying
//               why: pixel data cut short, RLE data that gives fewer
//               pixels than the image, an output buffer of the wrong size.
//
// Build: g++ -O3 -shared -fPIC bmp_dec.cpp -o bmp_dec.so

#include <vector>

#include "formats_common.h"

namespace {

using fmt::fail;

void decode_raw(const uint8_t* d, long n, int w, int h, const fmt::Layout& lay,
                long stride, bool bottom_up, uint8_t* out) {
    const long rb = lay.row_bytes(w);
    if (stride < rb) fail("BMP row stride shorter than its pixels");
    const long need = stride * (long)(h - 1) + rb;
    if (n < need) fail("BMP pixel data cut short");
    const long ob = (long)w * lay.bands * lay.out_bytes();
    for (int y = 0; y < h; ++y) {
        long src = bottom_up ? (long)(h - 1 - y) * stride : (long)y * stride;
        fmt::unpack_row(d + src, w, lay, out + y * ob);
    }
}

void decode_rle(const uint8_t* d, long n, int w, int h, bool rle4,
                bool bottom_up, int parity, uint8_t* out) {
    const long total = (long)w * h;
    std::vector<uint8_t> data;
    data.reserve(total);
    long pos = 0, x = 0;
    while ((long)data.size() < total) {
        if (pos + 2 > n) break;
        int count = d[pos], byte = d[pos + 1];
        pos += 2;
        if (count) {
            if (x + count > w) count = (int)(w - x > 0 ? w - x : 0);
            for (int i = 0; i < count; ++i)
                data.push_back(rle4 ? (i % 2 ? byte & 15 : byte >> 4)
                                    : byte);
            x += count;
        } else if (byte == 0) {
            while (data.size() % w) data.push_back(0);
            x = 0;
        } else if (byte == 1) {
            break;
        } else if (byte == 2) {
            if (pos + 2 > n) break;
            pos += 2;
            if (pos + 2 > n) fail("BMP RLE delta cut short");
            long right = d[pos], up = d[pos + 1];
            pos += 2;
            data.insert(data.end(), right + up * w, 0);
            x = (long)(data.size() % w);
        } else {
            long want = rle4 ? byte / 2 : byte;
            long got = pos + want <= n ? want : n - pos;
            for (long i = 0; i < got; ++i) {
                uint8_t v = d[pos + i];
                if (rle4) {
                    data.push_back(v >> 4);
                    data.push_back(v & 15);
                } else {
                    data.push_back(v);
                }
            }
            pos += got;
            if (got < want) break;
            x += byte;
            if ((pos + parity) % 2) pos += 1;
        }
    }
    if ((long)data.size() < total) fail("BMP RLE data gives fewer pixels "
                                        "than the image");
    for (int y = 0; y < h; ++y) {
        long src = bottom_up ? (long)(h - 1 - y) * w : (long)y * w;
        std::memcpy(out + (long)y * w, data.data() + src, w);
    }
}

}  // namespace

extern "C" int bmp_decode(const uint8_t* data, long n, int w, int h,
                          int kind, const int32_t* layout, int stride,
                          int bottom_up, int parity, void* out,
                          long out_n) {
    return fmt::guarded([&] {
        fmt::Layout lay(layout);
        if (w <= 0 || h <= 0) fail("BMP of no pixels");
        if (out_n != (long)w * h * lay.bands * lay.out_bytes())
            fail("output buffer of the wrong size");
        uint8_t* o = static_cast<uint8_t*>(out);
        if (kind == 0) {
            decode_raw(data, n, w, h, lay, stride, bottom_up, o);
        } else if (kind == 1 || kind == 2) {
            if (lay.bands != 1 || lay.keep16()) fail("BMP RLE of a colour "
                                                     "mode");
            decode_rle(data, n, w, h, kind == 2, bottom_up, parity, o);
        } else {
            fail("BMP compression kind past 2");
        }
    });
}
