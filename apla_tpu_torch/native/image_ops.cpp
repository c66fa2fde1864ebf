// Host image kernels of the input pipeline, over uint8 HWC buffers: the
// bilinear resize, the fused crop -> resize -> normalise, the normalise
// alone and the horizontal flip (the same arithmetic as the JAX package's
// `apla_tpu/native/image_ops.cpp`, so the two give the same bits); and
// Pillow's own arithmetic where the JAX package calls Pillow: its
// BILINEAR / BICUBIC resample (`Image.resize`) and its RGB -> HSV -> RGB
// round trip (`convert("HSV")`, `convert("RGB")`), ImageEnhance's blends
// (Brightness, Contrast, Color), its GaussianBlur
// (`ImageFilter.GaussianBlur`: extended box passes) and its BILINEAR
// generic transform (`Image.transform` with AFFINE or PERSPECTIVE, which
// `rotate`, the shears and the translations go through).  Called through
// ctypes (`apla_tpu_torch/native/__init__.py`), which releases the GIL.
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

// C's `round` on a non-negative double below 2^31, inline: the floor by
// truncation, then up where the rest is at least a half (both exact).
static inline int round_nonneg(double x) {
    int i = (int)x;
    return x - i >= 0.5 ? i + 1 : i;
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
            // fmod(t, 1.0) for t = h / 6 + 1 in [5/6, 11/6]: t - 1 is
            // exact there (Sterbenz), and fmod's call is the op's cost
            double t = h / 6.0 + 1.0;
            h = t >= 1.0 ? t - 1.0 : t;
            uh = clip8i((int)(h * 255.0));
            us = clip8i((int)(s * 255.0));
        }
        uint8_t hh = (uint8_t)(((int)uh + shift) & 255);
        if (us == 0) {
            px[0] = px[1] = px[2] = uv;
            continue;
        }
        int ii = (int)((float)hh * 6.0 / 255.0);    // floor: >= 0
        float f = (float)hh * 6.0 / 255.0 - (float)ii;
        float fs = ((float)us) / 255.0;
        int p = round_nonneg((float)uv * (1.0 - fs));
        int q = round_nonneg((float)uv * (1.0 - fs * f));
        int t = round_nonneg((float)uv * (1.0 - fs * (1.0 - f)));
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

// ------------------------------------------------------------------------ //
// Pillow's ImageEnhance on RGB: `Image.blend(degenerate, img, alpha)`,
// d + alpha * (v - d) in float, truncated to a byte, clipped first when
// alpha is outside [0, 1].  The degenerate d: 0 (Brightness), the grey
// mean int(sum(L) / n + 0.5) (Contrast), or each pixel's own L (Color),
// L = (19595 R + 38470 G + 7471 B + 2^15) >> 16 (`convert("L")`).
// ------------------------------------------------------------------------ //

static inline int luma(const uint8_t* p) {
    return (p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16;
}

// kind: 0 Brightness, 1 Contrast, 2 Color.
void enhance_u8(const uint8_t* img, uint8_t* out, long n, int kind,
                float alpha) {
    int d = 0;
    if (kind == 1) {
        long long sum = 0;
        for (long i = 0; i < n; ++i) sum += luma(img + 3 * i);
        d = (int)((double)sum / n + 0.5);
    }
    const bool inside = alpha >= 0 && alpha <= 1.0;
    for (long i = 0; i < n; ++i) {
        const uint8_t* p = img + 3 * i;
        if (kind == 2) d = luma(p);
        for (int ch = 0; ch < 3; ++ch) {
            float v = (float)d + alpha * (float)(p[ch] - d);
            if (!inside) v = v <= 0.0f ? 0.0f : v >= 255.0f ? 255.0f : v;
            out[3 * i + ch] = (uint8_t)v;
        }
    }
}

// ------------------------------------------------------------------------ //
// Pillow's GaussianBlur (BoxBlur.c): `passes` extended box blurs along each
// row, then `passes` along each column.  The box radius comes from the
// Gaussian's in float (its sqrt and floor in double); a pass gives
// out[x] = (ww * sum(in[x - r .. x + r]) + fw * (in[x - r - 1] +
// in[x + r + 1]) + 2^23) >> 24 in 32-bit unsigned arithmetic, indices
// clamped to the line, with ww = 2^24 / (2 * radius + 1) truncated and fw
// the rest of 2^24 shared by the two far taps.
// ------------------------------------------------------------------------ //

static float gaussian_box_radius(float radius, int passes) {
    float sigma2 = radius * radius / passes;
    float L = std::sqrt(12.0 * sigma2 + 1.0);
    float l = std::floor((L - 1.0) / 2.0);
    float a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
    a /= 6 * (sigma2 - (l + 1) * (l + 1));
    return l + a;
}

// One pass down the n rows of an [n, m] array: every column is a line
// (the accumulators run across the row, which the compiler vectorises).
static void box_pass_rows(const uint8_t* in, uint8_t* out, int n, long m,
                          float fradius, std::vector<uint32_t>& acc) {
    const int radius = (int)fradius;
    const uint32_t ww = (uint32_t)((float)(1 << 24) / (fradius * 2 + 1));
    const uint32_t fw = ((1 << 24) - (radius * 2 + 1) * ww) / 2;
    const int last = n - 1;
    auto row = [&](int i) {
        return in + (long)(i < 0 ? 0 : i > last ? last : i) * m;
    };
    acc.assign(m, 0);
    uint32_t* a = acc.data();
    for (int i = -radius - 1; i < radius; ++i) {
        const uint8_t* r = row(i);
        for (long j = 0; j < m; ++j) a[j] += r[j];
    }
    for (int y = 0; y < n; ++y) {
        const uint8_t* add = row(y + radius);
        const uint8_t* sub = row(y - radius - 1);
        const uint8_t* far = row(y + radius + 1);
        uint8_t* o = out + (long)y * m;
        for (long j = 0; j < m; ++j) {
            a[j] += (uint32_t)add[j] - (uint32_t)sub[j];
            uint32_t bulk = a[j] * ww + ((uint32_t)sub[j] + far[j]) * fw;
            o[j] = (uint8_t)((bulk + (1u << 23)) >> 24);
        }
    }
}

// [h, w, c] -> [w, h, c]
static void transpose_hwc(const uint8_t* in, uint8_t* out, int h, int w,
                          int c) {
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            std::memcpy(out + ((long)x * h + y) * c,
                        in + ((long)y * w + x) * c, c);
}

// `ImageFilter.GaussianBlur(radius)` in place on uint8 HWC: the passes
// along the rows run down the columns of the transposed image, as
// Pillow's own vertical passes run along the rows of its transpose.
void gaussian_blur_u8(uint8_t* img, int h, int w, int c, float radius) {
    const int passes = 3;
    float r = gaussian_box_radius(radius, passes);
    if (r == 0) return;
    const long n = (long)h * w * c;
    std::vector<uint8_t> t0(n), t1(n);
    std::vector<uint32_t> acc;
    transpose_hwc(img, t0.data(), h, w, c);
    for (int p = 0; p < passes; ++p) {     // along each row
        box_pass_rows(t0.data(), t1.data(), w, (long)h * c, r, acc);
        t0.swap(t1);
    }
    transpose_hwc(t0.data(), t1.data(), w, h, c);
    for (int p = 0; p < passes; ++p) {     // along each column
        box_pass_rows(t1.data(), p + 1 < passes ? t0.data() : img, h,
                      (long)w * c, r, acc);
        t1.swap(t0);
    }
}

// ------------------------------------------------------------------------ //
// Pillow's `Image.transform(img.size, AFFINE | PERSPECTIVE, a, BILINEAR)` on
// an RGB image (Geometry.c: ImagingGenericTransform with affine_transform or
// perspective_transform and bilinear_filter32RGB): each output pixel's
// centre (x + 0.5, y + 0.5) mapped through `a` in double; a source point
// outside [0, w) x [0, h) gives 0; else the four neighbours of the point
// less 0.5, columns clamped, the row below replaced by the row itself past
// the last, interpolated in double and truncated.
// ------------------------------------------------------------------------ //

void transform_bilinear_u8(const uint8_t* src, int h, int w, int c,
                           uint8_t* dst, const double* a, int perspective) {
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            uint8_t* out = dst + ((long)y * w + x) * c;
            double xin = x + 0.5, yin = y + 0.5, xs, ys;
            if (perspective) {
                xs = (a[0] * xin + a[1] * yin + a[2])
                     / (a[6] * xin + a[7] * yin + 1);
                ys = (a[3] * xin + a[4] * yin + a[5])
                     / (a[6] * xin + a[7] * yin + 1);
            } else {
                xs = a[0] * xin + a[1] * yin + a[2];
                ys = a[3] * xin + a[4] * yin + a[5];
            }
            if (xs < 0.0 || xs >= w || ys < 0.0 || ys >= h) {
                std::memset(out, 0, c);
                continue;
            }
            xs -= 0.5;
            ys -= 0.5;
            int xi = (int)std::floor(xs), yi = (int)std::floor(ys);
            double dx = xs - xi, dy = ys - yi;
            int x0 = std::min(std::max(xi, 0), w - 1);
            int x1 = std::min(std::max(xi + 1, 0), w - 1);
            const uint8_t* r0 = src + (long)std::min(std::max(yi, 0), h - 1)
                                      * w * c;
            const bool below = yi + 1 >= 0 && yi + 1 < h;
            const uint8_t* r1 = src + (long)(below ? yi + 1 : 0) * w * c;
            for (int ch = 0; ch < c; ++ch) {
                int p0 = r0[x0 * c + ch], p1 = r0[x1 * c + ch];
                double v1 = p0 + (p1 - p0) * dx, v2 = v1;
                if (below) {
                    int q0 = r1[x0 * c + ch], q1 = r1[x1 * c + ch];
                    v2 = q0 + (q1 - q0) * dx;
                }
                out[ch] = (uint8_t)(v1 + (v2 - v1) * dy);
            }
        }
    }
}

}  // extern "C"
