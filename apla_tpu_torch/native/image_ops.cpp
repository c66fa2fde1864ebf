// Host image kernels of the input pipeline, over uint8 HWC buffers: the
// bilinear resize, the fused crop -> resize -> normalise, the normalise
// alone and the horizontal flip (the same arithmetic as the JAX package's
// `apla_tpu/native/image_ops.cpp`, so the two give the same bits); and
// Pillow's own arithmetic where the JAX package calls Pillow: its
// BILINEAR / BICUBIC resample (`Image.resize`) and its RGB -> HSV -> RGB
// round trip (`convert("HSV")`, `convert("RGB")`).  Called through ctypes
// (`apla_tpu_torch/native/__init__.py`), which releases the GIL.
//
// Build: g++ -O3 -shared -fPIC image_ops.cpp -o image_ops.so

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <vector>

#include "bilinear_u8.h"

extern "C" {

// Bilinear resize uint8 HWC -> uint8 HWC (shared kernel).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
    bilinear_resize_u8(src, sh, sw, c, dst, dh, dw);
}

// Fused: crop [cy, cy+chh) x [cx, cx+cww) of uint8 HWC, bilinear-resize to
// (dh, dw), then out = (v/255 - mean[c]) / std[c] as float32 HWC.
void crop_resize_normalize(const uint8_t* src, int sh, int sw, int c,
                           int cy, int cx, int chh, int cww,
                           float* dst, int dh, int dw,
                           const float* mean, const float* stdv) {
    const float scale_y = (float)chh / dh;
    const float scale_x = (float)cww / dw;
    float inv_std[16];
    float m255[16];
    for (int ch = 0; ch < c && ch < 16; ++ch) {
        inv_std[ch] = 1.0f / (255.0f * stdv[ch]);
        m255[ch] = mean[ch] * 255.0f;
    }
    for (int y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * scale_y - 0.5f + cy;
        int y0 = (int)std::floor(fy);
        float wy = fy - y0;
        int y1 = std::min(y0 + 1, sh - 1);
        y0 = std::min(std::max(y0, 0), sh - 1);
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * scale_x - 0.5f + cx;
            int x0 = (int)std::floor(fx);
            float wx = fx - x0;
            int x1 = std::min(x0 + 1, sw - 1);
            x0 = std::min(std::max(x0, 0), sw - 1);
            const uint8_t* p00 = src + (y0 * sw + x0) * c;
            const uint8_t* p01 = src + (y0 * sw + x1) * c;
            const uint8_t* p10 = src + (y1 * sw + x0) * c;
            const uint8_t* p11 = src + (y1 * sw + x1) * c;
            float* out = dst + (y * dw + x) * c;
            for (int ch = 0; ch < c; ++ch) {
                float top = p00[ch] * (1 - wx) + p01[ch] * wx;
                float bot = p10[ch] * (1 - wx) + p11[ch] * wx;
                float v = top * (1 - wy) + bot * wy;
                out[ch] = (v - m255[ch]) * inv_std[ch];
            }
        }
    }
}

// Normalize only: uint8 HWC -> float32 HWC, (v/255 - mean)/std.
void normalize_u8(const uint8_t* src, int n_pixels, int c,
                  const float* mean, const float* stdv, float* dst) {
    float inv_std[16];
    float m255[16];
    for (int ch = 0; ch < c && ch < 16; ++ch) {
        inv_std[ch] = 1.0f / (255.0f * stdv[ch]);
        m255[ch] = mean[ch] * 255.0f;
    }
    for (int i = 0; i < n_pixels; ++i) {
        const uint8_t* p = src + i * c;
        float* out = dst + i * c;
        for (int ch = 0; ch < c; ++ch) {
            out[ch] = (p[ch] - m255[ch]) * inv_std[ch];
        }
    }
}

// Horizontal flip in place, uint8 HWC.
void hflip_u8(uint8_t* img, int h, int w, int c) {
    for (int y = 0; y < h; ++y) {
        uint8_t* row = img + y * w * c;
        for (int x = 0; x < w / 2; ++x) {
            for (int ch = 0; ch < c; ++ch) {
                std::swap(row[x * c + ch], row[(w - 1 - x) * c + ch]);
            }
        }
    }
}

// ------------------------------------------------------------------------ //
// Pillow's resample (Resample.c): separable, a horizontal then a vertical
// pass, each only where that side changes; the filter's support grows with
// the reduction; coefficients in double, normalised, then fixed point with
// 22 fraction bits; sums in 32-bit integers, rounded, clipped.
// ------------------------------------------------------------------------ //

static double triangle_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

static double bicubic_filter(double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
}

static const int kPrecisionBits = 32 - 8 - 2;

// precompute_coeffs + normalize_coeffs_8bpc for in_size -> out_size.
static int resample_coeffs(int in_size, int out_size, int bicubic,
                           std::vector<int>& bounds, std::vector<int>& kk) {
    double (*filter)(double) = bicubic ? bicubic_filter : triangle_filter;
    double support_base = bicubic ? 2.0 : 1.0;
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support_base * filterscale;
    int ksize = (int)std::ceil(support) * 2 + 1;
    std::vector<double> k(ksize);
    bounds.assign(2 * out_size, 0);
    kk.assign((size_t)out_size * ksize, 0);
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (int x = 0; x < xmax; ++x) {
            double w = filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (int x = 0; x < xmax; ++x) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (int x = 0; x < xmax; ++x) {
            double v = k[x] * (1 << kPrecisionBits);
            kk[(size_t)xx * ksize + x] = k[x] < 0 ? (int)(-0.5 + v)
                                                  : (int)(0.5 + v);
        }
        bounds[2 * xx] = xmin;
        bounds[2 * xx + 1] = xmax;
    }
    return ksize;
}

static inline uint8_t clip8(int in) {
    if (in >= (1 << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> kPrecisionBits);
}

// Pillow's `Image.resize((dw, dh), BILINEAR or BICUBIC)` on uint8 HWC.
void resample_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                 int dh, int dw, int bicubic) {
    if (sh == dh && sw == dw) {
        std::memcpy(dst, src, (size_t)sh * sw * c);
        return;
    }
    std::vector<uint8_t> tmp;
    const uint8_t* in = src;
    int ih = sh, iw = sw;
    if (dw != sw) {
        std::vector<int> bounds, kk;
        int ksize = resample_coeffs(sw, dw, bicubic, bounds, kk);
        uint8_t* out = dh == sh ? dst : (tmp.resize((size_t)sh * dw * c),
                                         tmp.data());
        for (int y = 0; y < sh; ++y) {
            const uint8_t* row = src + (size_t)y * sw * c;
            uint8_t* orow = out + (size_t)y * dw * c;
            for (int xx = 0; xx < dw; ++xx) {
                const int* k = &kk[(size_t)xx * ksize];
                int xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
                for (int ch = 0; ch < c; ++ch) {
                    int ss = 1 << (kPrecisionBits - 1);
                    for (int x = 0; x < xmax; ++x)
                        ss += row[(x + xmin) * c + ch] * k[x];
                    orow[xx * c + ch] = clip8(ss);
                }
            }
        }
        if (dh == sh) return;
        in = tmp.data();
        iw = dw;
    }
    std::vector<int> bounds, kk;
    int ksize = resample_coeffs(ih, dh, bicubic, bounds, kk);
    for (int yy = 0; yy < dh; ++yy) {
        const int* k = &kk[(size_t)yy * ksize];
        int ymin = bounds[2 * yy], ymax = bounds[2 * yy + 1];
        uint8_t* orow = dst + (size_t)yy * iw * c;
        for (int xc = 0; xc < iw * c; ++xc) {
            int ss = 1 << (kPrecisionBits - 1);
            for (int y = 0; y < ymax; ++y)
                ss += in[(size_t)(y + ymin) * iw * c + xc] * k[y];
            orow[xc] = clip8(ss);
        }
    }
}

// ------------------------------------------------------------------------ //
// Pillow's RGB -> HSV -> RGB (Convert.c rgb2hsv_row, hsv2rgb), with the hue
// byte moved by `shift` modulo 256 in between, in place on n RGB pixels.
// The float / double mix is Pillow's, operation for operation.
// ------------------------------------------------------------------------ //

static inline uint8_t clip8i(int v) {
    return (uint8_t)(v <= 0 ? 0 : v >= 255 ? 255 : v);
}

void hue_shift_u8(uint8_t* img, long n, int shift) {
    for (long i = 0; i < n; ++i) {
        uint8_t* px = img + 3 * i;
        uint8_t r = px[0], g = px[1], b = px[2];
        uint8_t maxc = std::max(r, std::max(g, b));
        uint8_t minc = std::min(r, std::min(g, b));
        uint8_t uh, us, uv = maxc;
        if (minc == maxc) {
            uh = 0;
            us = 0;
        } else {
            float cr = (float)(maxc - minc);
            float s = cr / (float)maxc;
            float rc = ((float)(maxc - r)) / cr;
            float gc = ((float)(maxc - g)) / cr;
            float bc = ((float)(maxc - b)) / cr;
            float h;
            if (r == maxc) {
                h = bc - gc;
            } else if (g == maxc) {
                h = 2.0 + rc - bc;
            } else {
                h = 4.0 + gc - rc;
            }
            h = std::fmod((h / 6.0 + 1.0), 1.0);
            uh = clip8i((int)(h * 255.0));
            us = clip8i((int)(s * 255.0));
        }
        uint8_t hh = (uint8_t)(((int)uh + shift) & 255);
        if (us == 0) {
            px[0] = px[1] = px[2] = uv;
            continue;
        }
        int ii = (int)std::floor((float)hh * 6.0 / 255.0);
        float f = (float)hh * 6.0 / 255.0 - (float)ii;
        float fs = ((float)us) / 255.0;
        int p = (int)std::round((float)uv * (1.0 - fs));
        int q = (int)std::round((float)uv * (1.0 - fs * f));
        int t = (int)std::round((float)uv * (1.0 - fs * (1.0 - f)));
        uint8_t up = clip8i(p), uq = clip8i(q), ut = clip8i(t);
        switch (ii % 6) {
            case 0: px[0] = uv; px[1] = ut; px[2] = up; break;
            case 1: px[0] = uq; px[1] = uv; px[2] = up; break;
            case 2: px[0] = up; px[1] = uv; px[2] = ut; break;
            case 3: px[0] = up; px[1] = uq; px[2] = uv; break;
            case 4: px[0] = ut; px[1] = up; px[2] = uv; break;
            case 5: px[0] = uv; px[1] = up; px[2] = uq; break;
        }
    }
}

}  // extern "C"
