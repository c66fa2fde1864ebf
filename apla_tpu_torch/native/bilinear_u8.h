// Shared bilinear uint8 HWC resize kernel, included by image_ops.cpp and
// jpeg_dec.cpp (compiled into separate .so files); ONE implementation so
// the resize numerics of the transform path and the JPEG decode path can
// never diverge.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>

static inline void bilinear_resize_u8(const uint8_t* src, int sh, int sw,
                                      int c, uint8_t* dst, int dh, int dw) {
    const float scale_y = (float)sh / dh;
    const float scale_x = (float)sw / dw;
    for (int y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * scale_y - 0.5f;
        int y0 = (int)std::floor(fy);
        float wy = fy - y0;
        int y1 = std::min(y0 + 1, sh - 1);
        y0 = std::max(y0, 0);
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * scale_x - 0.5f;
            int x0 = (int)std::floor(fx);
            float wx = fx - x0;
            int x1 = std::min(x0 + 1, sw - 1);
            x0 = std::max(x0, 0);
            const uint8_t* p00 = src + (y0 * sw + x0) * c;
            const uint8_t* p01 = src + (y0 * sw + x1) * c;
            const uint8_t* p10 = src + (y1 * sw + x0) * c;
            const uint8_t* p11 = src + (y1 * sw + x1) * c;
            uint8_t* out = dst + (y * dw + x) * c;
            for (int ch = 0; ch < c; ++ch) {
                float top = p00[ch] * (1 - wx) + p01[ch] * wx;
                float bot = p10[ch] * (1 - wx) + p11[ch] * wx;
                float v = top * (1 - wy) + bot * wy;
                out[ch] = (uint8_t)std::min(std::max(v + 0.5f, 0.0f),
                                            255.0f);
            }
        }
    }
}
