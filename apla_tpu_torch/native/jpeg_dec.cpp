// JPEG decoder for the input pipeline, with no library beneath it.
//
// The JAX package decodes with the system's libjpeg (libjpeg-turbo) and,
// for the files libjpeg's RGB output refuses, with Pillow (which carries a
// libjpeg-turbo of its own).  The card's machine has neither, so this file
// decodes the same files to the same bits:
//
// - Huffman-coded baseline, extended and progressive frames (SOF0-2), with
//   restart markers; DC and AC scans, first passes and refinements;
// - dequantisation and libjpeg's integer inverse DCTs: `jpeg_idct_islow`
//   at 8 x 8, and the scaled sizes that a decode at scale M/8 picks (1, 2
//   and 4 from jidctred.c; 3, 5, 6, 7, 10, 12 and 14 from jidctint.c: the
//   chroma of a subsampled image is scaled up by its IDCT, not upsampled,
//   where the sampling allows);
// - libjpeg's upsampling: fancy (triangle) h2v1, h1v2 and h2v2, box
//   replication elsewhere and at scale 1/8, the edges replicated as
//   libjpeg's context rows replicate them;
// - libjpeg's YCbCr -> RGB tables; grey replicated to RGB; Adobe RGB
//   passed through; CMYK and YCCK (libjpeg's RGB output refuses them)
//   converted as Pillow reads them ("CMYK;I", inverted) and converts them
//   (`convert("RGB")`).
//
// Entry points (C, bound by ctypes in __init__.py):
//   jpeg_probe          header only: size, components, colour handling;
//   jpeg_decode         decode at scale num/8 (num = 8: full size) to RGB;
//   jpeg_decode_resize  the JAX package's `jpeg_decode_resize`: the
//                       smallest scale num/8 whose output still covers the
//                       target, then bilinear to exactly [out_h, out_w, 3];
//                       2 for a CMYK or YCCK stream, which it leaves to
//                       the full decode (as the JAX package leaves it to
//                       Pillow).
// Each returns 0 on success; otherwise `jpeg_error_message()` says why.
// Arithmetic coding, lossless and hierarchical frames and 12-bit samples
// are refused.
//
// Build: g++ -O3 -shared -fPIC jpeg_dec.cpp -o jpeg_dec.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "bilinear_u8.h"

namespace {

thread_local char g_error[256];

struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw DecodeError(what); }

// Natural (row-major) position of the k-th zigzag coefficient; the 16
// extra entries absorb runs past 63 in corrupt data, as libjpeg's do.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ----------------------------------------------------------------------- //
// Huffman tables and the entropy-coded bit reader
// ----------------------------------------------------------------------- //

constexpr int kLookBits = 9;

struct HuffTable {
    bool defined = false;
    // libjpeg's jpeg_make_d_derived_tbl refuses a table, when a scan uses
    // it, whose codes of some length l do not fit in l bits (or would take
    // the all-ones code), and a DC table with a symbol past 15
    bool overfull = false;
    int max_symbol = 0;
    uint8_t vals[256] = {};
    int32_t maxcode[18] = {};
    int32_t valoffset[18] = {};
    uint8_t look_len[1 << kLookBits] = {};   // 0: code longer than kLookBits
    uint8_t look_sym[1 << kLookBits] = {};

    void build(const uint8_t* counts, const uint8_t* symbols, int n) {
        defined = true;
        overfull = false;
        max_symbol = 0;
        for (int i = 0; i < n; ++i) max_symbol = std::max<int>(max_symbol,
                                                               symbols[i]);
        std::memset(look_len, 0, sizeof(look_len));
        long next = 0;  // the first code of length l, then one past its last
        for (int l = 1; l <= 16; ++l) {
            next += counts[l - 1];
            if (next >= (1L << l)) {   // libjpeg's JERR_BAD_HUFF_TABLE test
                overfull = true;
                return;
            }
            next <<= 1;
        }
        std::memcpy(vals, symbols, n);
        int code = 0, p = 0;
        for (int l = 1; l <= 16; ++l) {
            valoffset[l] = p - code;
            if (counts[l - 1]) {
                for (int i = 0; i < counts[l - 1]; ++i, ++p, ++code) {
                    if (l <= kLookBits) {
                        int shift = kLookBits - l;
                        for (int j = 0; j < (1 << shift); ++j) {
                            look_len[(code << shift) | j] = (uint8_t)l;
                            look_sym[(code << shift) | j] = symbols[p];
                        }
                    }
                }
                maxcode[l] = code - 1;
            } else {
                maxcode[l] = -1;
            }
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;                // sentinel: ends the search
    }

    // What a scan checks before it decodes with the table.
    void check(bool is_dc) const {
        if (!defined)
            fail(is_dc ? "undefined DC Huffman table"
                       : "undefined AC Huffman table");
        if (overfull || (is_dc && max_symbol > 15))
            fail("bad Huffman table");
    }
};

struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t pos;            // next byte to load
    uint64_t acc = 0;      // bits left-aligned at bit 63
    int nbits = 0;
    bool at_marker = false;

    void fill() {
        while (nbits <= 56) {
            uint32_t byte = 0;
            if (!at_marker && pos < len) {
                byte = data[pos];
                if (byte == 0xFF) {
                    uint8_t next = pos + 1 < len ? data[pos + 1] : 0xD9;
                    if (next == 0x00) {
                        pos += 2;
                    } else {
                        // a marker ends the segment: zeros from here on,
                        // as libjpeg feeds them
                        at_marker = true;
                        byte = 0;
                    }
                } else {
                    pos += 1;
                }
            } else {
                at_marker = true;
            }
            acc |= (uint64_t)byte << (56 - nbits);
            nbits += 8;
        }
    }
    inline int get_bits(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        int v = (int)(acc >> (64 - n));
        acc <<= n;
        nbits -= n;
        return v;
    }
    inline int get_bit() { return get_bits(1); }
    inline int decode(const HuffTable& t) {
        if (nbits < 16) fill();
        int look = (int)(acc >> (64 - kLookBits));
        int l = t.look_len[look];
        if (l) {
            acc <<= l;
            nbits -= l;
            return t.look_sym[look];
        }
        l = kLookBits + 1;
        int code = (int)(acc >> (64 - l));
        while (code > t.maxcode[l]) {
            ++l;
            if (l > 16) {
                // libjpeg warns ("bad Huffman code") and decodes a zero
                acc <<= 16;
                nbits -= 16;
                return 0;
            }
            code = (int)(acc >> (64 - l));
        }
        acc <<= l;
        nbits -= l;
        return t.vals[(t.valoffset[l] + code) & 0xFF];
    }
    void reset() {
        acc = 0;
        nbits = 0;
        at_marker = false;
    }
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v;
}

// ----------------------------------------------------------------------- //
// Frame state
// ----------------------------------------------------------------------- //

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;          // blocks, padded to whole MCUs
    int bw_real = 0, bh_real = 0;
    std::vector<int16_t> coef;   // [bh][bw][64], natural order
    uint16_t q[64] = {};
    bool q_latched = false;
    int dc_tbl = 0, ac_tbl = 0;
    int dc_pred = 0;
    int16_t* block(int by, int bx) {
        return coef.data() + ((size_t)by * bw + bx) * 64;
    }
};

enum ColorKind { kGray = 0, kYCbCr = 1, kRGB = 2, kCMYK = 3, kYCCK = 4 };

// One stream; the constructor reads its markers up to the frame header.
struct Jpeg {
    const uint8_t* data = nullptr;
    size_t len = 0;
    size_t pos = 0;
    int width = 0, height = 0;
    bool progressive = false;
    int max_h = 1, max_v = 1;
    int mcus_x = 0, mcus_y = 0;
    std::vector<Component> comps;
    uint16_t qt[4][64] = {};
    bool qt_defined[4] = {};
    HuffTable dc[4], ac[4];
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = -1;
    bool frame_seen = false;

    Jpeg(const uint8_t* d, long n) : data(d), len(n > 0 ? (size_t)n : 0) {
        read_header();
    }

    uint8_t byte() {
        if (pos >= len) fail("unexpected end of data");
        return data[pos++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }

    // The next marker code, skipping fill bytes and any stray data.
    int next_marker() {
        while (pos < len) {
            if (data[pos] != 0xFF) { ++pos; continue; }
            while (pos < len && data[pos] == 0xFF) ++pos;
            if (pos >= len) break;
            int m = data[pos++];
            if (m != 0) return m;
        }
        return -1;
    }

    void read_app(int marker) {
        size_t n = (size_t)u16();
        if (n < 2 || pos + n - 2 > len) fail("bad marker length");
        const uint8_t* p = data + pos;
        size_t body = n - 2;
        if (marker == 0xE0 && body >= 5 && !std::memcmp(p, "JFIF\0", 5))
            saw_jfif = true;
        if (marker == 0xEE && body >= 12 && !std::memcmp(p, "Adobe", 5)) {
            saw_adobe = true;
            adobe_transform = p[11];
        }
        pos += body;
    }

    void read_dqt() {
        size_t n = (size_t)u16();
        size_t end = pos + n - 2;
        while (pos < end) {
            int pq_tq = byte();
            int t = pq_tq & 15, prec = pq_tq >> 4;
            if (t > 3) fail("bad quantisation table index");
            for (int k = 0; k < 64; ++k)
                qt[t][kNatural[k]] = (uint16_t)(prec ? u16() : byte());
            qt_defined[t] = true;
        }
        if (pos != end) fail("bad DQT length");
    }

    void read_dht() {
        size_t n = (size_t)u16();
        size_t end = pos + n - 2;
        while (pos < end) {
            int tc_th = byte();
            int cls = tc_th >> 4, t = tc_th & 15;
            if (t > 3 || cls > 1) fail("bad Huffman table index");
            uint8_t counts[16], symbols[256];
            int total = 0;
            for (int i = 0; i < 16; ++i) {
                counts[i] = byte();
                total += counts[i];
            }
            if (total > 256) fail("bad Huffman table");
            for (int i = 0; i < total; ++i) symbols[i] = byte();
            (cls ? ac[t] : dc[t]).build(counts, symbols, total);
        }
        if (pos != end) fail("bad DHT length");
    }

    void read_sof(int marker) {
        if (frame_seen) fail("more than one frame");
        frame_seen = true;
        progressive = marker == 0xC2;
        int n = u16();
        int precision = byte();
        if (precision != 8) fail("only 8-bit samples are decoded");
        height = u16();
        width = u16();
        int nc = byte();
        if (width <= 0 || height <= 0) fail("image has no size (DNL)");
        if (width > 65500 || height > 65500)   // libjpeg's JPEG_MAX_DIMENSION
            fail("image too big");
        // Pillow's decompression-bomb limit (2 * Image.MAX_IMAGE_PIXELS),
        // past which its open raises: the coefficients of a larger frame
        // would take gigabytes here
        if ((long)width * height > 178956970L) fail("image too big");
        if (nc != 1 && nc != 3 && nc != 4)
            fail("only 1, 3 or 4 components are decoded");
        if (n != 8 + 3 * nc) fail("bad SOF length");
        comps.resize(nc);
        for (auto& c : comps) {
            c.id = byte();
            int hv = byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = byte() & 3;
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
                fail("bad sampling factors");
            max_h = std::max(max_h, c.h);
            max_v = std::max(max_v, c.v);
        }
        mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
        mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
        for (auto& c : comps) {
            int cw = (int)(((long)width * c.h + max_h - 1) / max_h);
            int ch = (int)(((long)height * c.v + max_v - 1) / max_v);
            c.bw_real = (cw + 7) / 8;
            c.bh_real = (ch + 7) / 8;
            c.bw = mcus_x * c.h;
            c.bh = mcus_y * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        }
    }

    ColorKind color() const {
        int n = (int)comps.size();
        if (n == 1) return kGray;
        if (n == 3) {
            if (saw_jfif) return kYCbCr;
            if (saw_adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
            if (comps[0].id == 1 && comps[1].id == 2 && comps[2].id == 3)
                return kYCbCr;
            if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66)
                return kRGB;
            return kYCbCr;
        }
        if (saw_adobe) return adobe_transform == 0 ? kCMYK : kYCCK;
        return kCMYK;
    }

    // Reads markers up to the frame header.
    void read_header() {
        if (len < 2 || data[0] != 0xFF || data[1] != 0xD8)
            fail("not a JPEG stream (no SOI marker)");
        pos = 2;
        for (;;) {
            int m = next_marker();
            if (m < 0) fail("no frame header before the end of data");
            if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
                read_sof(m);
                return;
            }
            if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                m != 0xCC)
                fail("arithmetic-coded, lossless or hierarchical JPEG");
            dispatch(m);
        }
    }

    void dispatch(int m) {
        if (m == 0xDB) read_dqt();
        else if (m == 0xC4) read_dht();
        else if (m == 0xDD) {
            if (u16() != 4) fail("bad DRI length");
            restart_interval = u16();
        }
        else if (m == 0xCC) fail("arithmetic-coded JPEG");
        else if (m >= 0xE0 && m <= 0xEF) read_app(m);
        else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {}
        else {
            size_t n = (size_t)u16();
            if (n < 2) fail("bad marker length");
            pos += n - 2;
        }
    }

    // ------------------------------------------------------------------ //
    // Scans
    // ------------------------------------------------------------------ //

    void decode_block_baseline(BitReader& br, Component& c, int16_t* blk) {
        const HuffTable& d = dc[c.dc_tbl];
        const HuffTable& a = ac[c.ac_tbl];
        int s = br.decode(d);
        int diff = s ? extend(br.get_bits(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = (int16_t)c.dc_pred;
        for (int k = 1; k < 64; ++k) {
            int rs = br.decode(a);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(br.get_bits(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void scan(BitReader& br, std::vector<Component*>& sc, int ss, int se,
              int ah, int al) {
        int eobrun = 0;
        int kind;  // 0 baseline, 1 DC first, 2 DC refine, 3 AC first,
                   // 4 AC refine
        if (!progressive) kind = 0;
        else if (ss == 0) kind = ah ? 2 : 1;
        else kind = ah ? 4 : 3;
        if (progressive && ss > 0 && sc.size() != 1)
            fail("progressive AC scan with more than one component");
        if (progressive && (se > 63 || ss > se || (ss == 0 && se != 0) ||
                            (ah != 0 && al != ah - 1) || al > 13))
            fail("bad progressive scan parameters");
        for (auto* c : sc) {
            if (kind == 0 || kind == 1) dc[c->dc_tbl].check(true);
            if (kind == 0 || kind >= 3) ac[c->ac_tbl].check(false);
        }

        auto block_fn = [&](Component& c, int16_t* blk) {
            switch (kind) {
            case 0:
                decode_block_baseline(br, c, blk);
                break;
            case 1: {
                int s = br.decode(dc[c.dc_tbl]);
                int diff = s ? extend(br.get_bits(s), s) : 0;
                c.dc_pred += diff;
                blk[0] = (int16_t)(c.dc_pred * (1 << al));
                break;
            }
            case 2:
                if (br.get_bit()) blk[0] |= (int16_t)(1 << al);
                break;
            case 3: {
                if (eobrun > 0) { --eobrun; break; }
                const HuffTable& a = ac[c.ac_tbl];
                for (int k = ss; k <= se; ++k) {
                    int rs = br.decode(a);
                    int r = rs >> 4, s = rs & 15;
                    if (s) {
                        k += r;
                        int v = extend(br.get_bits(s), s);
                        blk[kNatural[k]] = (int16_t)(v * (1 << al));
                    } else if (r == 15) {
                        k += 15;
                    } else {
                        eobrun = 1 << r;
                        if (r) eobrun += br.get_bits(r);
                        --eobrun;
                        break;
                    }
                }
                break;
            }
            case 4: {
                const HuffTable& a = ac[c.ac_tbl];
                int p1 = 1 << al, m1 = -1 * (1 << al);
                int k = ss;
                if (eobrun == 0) {
                    for (; k <= se; ++k) {
                        int rs = br.decode(a);
                        int r = rs >> 4, s = rs & 15;
                        if (s) {
                            s = br.get_bit() ? p1 : m1;
                        } else if (r != 15) {
                            eobrun = 1 << r;
                            if (r) eobrun += br.get_bits(r);
                            break;
                        }
                        do {
                            int16_t* coef = blk + kNatural[k];
                            if (*coef != 0) {
                                if (br.get_bit() && (*coef & p1) == 0)
                                    *coef = (int16_t)(*coef >= 0 ? *coef + p1
                                                                 : *coef + m1);
                            } else if (--r < 0) {
                                break;
                            }
                            ++k;
                        } while (k <= se);
                        if (s) blk[kNatural[k]] = (int16_t)s;
                    }
                }
                if (eobrun > 0) {
                    for (; k <= se; ++k) {
                        int16_t* coef = blk + kNatural[k];
                        if (*coef != 0 && br.get_bit() && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef >= 0 ? *coef + p1
                                                         : *coef + m1);
                    }
                    --eobrun;
                }
                break;
            }
            }
        };

        auto restart = [&]() {
            br.reset();
            // resume at the marker the reader stopped at (or find it)
            size_t p = br.pos;
            while (p + 1 < len && !(data[p] == 0xFF && data[p + 1] >= 0xD0 &&
                                    data[p + 1] <= 0xD7))
                ++p;
            br.pos = std::min(len, p + 2);
            for (auto* c : sc) c->dc_pred = 0;
            eobrun = 0;
        };

        long todo = restart_interval;
        if (sc.size() == 1) {
            Component& c = *sc[0];
            for (int by = 0; by < c.bh_real; ++by) {
                for (int bx = 0; bx < c.bw_real; ++bx) {
                    if (restart_interval && todo == 0) {
                        restart();
                        todo = restart_interval;
                    }
                    block_fn(c, c.block(by, bx));
                    --todo;
                }
            }
        } else {
            for (int my = 0; my < mcus_y; ++my) {
                for (int mx = 0; mx < mcus_x; ++mx) {
                    if (restart_interval && todo == 0) {
                        restart();
                        todo = restart_interval;
                    }
                    for (auto* cp : sc) {
                        Component& c = *cp;
                        for (int v = 0; v < c.v; ++v)
                            for (int h = 0; h < c.h; ++h)
                                block_fn(c, c.block(my * c.v + v,
                                                    mx * c.h + h));
                    }
                    --todo;
                }
            }
        }
    }

    void read_sos() {
        int n = u16();
        int ns = byte();
        if (ns < 1 || ns > 4 || n != 6 + 2 * ns)
            fail("bad SOS length or component count");
        std::vector<Component*> sc;
        for (int i = 0; i < ns; ++i) {
            int id = byte();
            int tables = byte();
            Component* found = nullptr;
            for (auto& c : comps)
                if (c.id == id) found = &c;
            if (!found) fail("scan names an unknown component");
            found->dc_tbl = (tables >> 4) & 3;
            found->ac_tbl = tables & 3;
            sc.push_back(found);
        }
        int ss = byte(), se = byte(), a = byte();
        if (ns > 1) {                  // libjpeg's D_MAX_BLOCKS_IN_MCU
            int blocks = 0;
            for (auto* c : sc) blocks += c->h * c->v;
            if (blocks > 10) fail("too many blocks in an MCU");
        }
        for (auto* c : sc) {
            // libjpeg latches a component's table at its first scan
            if (!c->q_latched) {
                if (!qt_defined[c->tq]) fail("undefined quantisation table");
                std::memcpy(c->q, qt[c->tq], sizeof(c->q));
                c->q_latched = true;
            }
            c->dc_pred = 0;
        }
        BitReader br{data, len, pos};
        scan(br, sc, ss, se, a >> 4, a & 15);
        pos = br.pos;
    }

    // Reads the scans that follow the frame header.
    void read_scans() {
        for (;;) {
            int m = next_marker();
            if (m < 0 || m == 0xD9) break;
            if (m == 0xDA) read_sos();
            else if (m >= 0xC0 && m <= 0xC2) fail("more than one frame");
            else dispatch(m);
        }
        for (auto& c : comps)
            if (!c.q_latched) fail("a component has no scan");
    }
};

// ----------------------------------------------------------------------- //
// Inverse DCTs: libjpeg's integer ones, each at its own output size
// ----------------------------------------------------------------------- //

using JLONG = long;
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr JLONG ONE = 1;
constexpr JLONG FIX(double x) { return (JLONG)(x * (ONE << CONST_BITS) + 0.5); }
inline JLONG DESCALE(JLONG x, int n) { return (x + (ONE << (n - 1))) >> n; }
inline JLONG RSH(JLONG x, int n) { return x >> n; }

// libjpeg's post-IDCT range limit: the sample + 128, clamped, with the
// wrap-around of its 1024-entry table for far-off values.
inline uint8_t range_limit(JLONG x) {
    int v = (int)x & 1023;
    if (v < 128) return (uint8_t)(v + 128);
    if (v < 512) return 255;
    if (v < 896) return 0;
    return (uint8_t)(v - 896);
}

// jidctint.c jpeg_idct_islow (8 x 8).
void idct_8(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        auto D = [&](int r) { return (JLONG)ip[8 * r] * qp[8 * r]; };
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
            ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int dc = (int)(D(0) * (1 << PASS1_BITS));
            for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
            continue;
        }
        JLONG z2 = D(2), z3 = D(6);
        JLONG z1 = (z2 + z3) * FIX(0.541196100);
        JLONG tmp2 = z1 + z3 * (-FIX(1.847759065));
        JLONG tmp3 = z1 + z2 * FIX(0.765366865);
        z2 = D(0);
        z3 = D(4);
        JLONG tmp0 = (z2 + z3) * (ONE << CONST_BITS);
        JLONG tmp1 = (z2 - z3) * (ONE << CONST_BITS);
        JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = D(7);
        tmp1 = D(5);
        tmp2 = D(3);
        tmp3 = D(1);
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        JLONG z4 = tmp1 + tmp3;
        JLONG z5 = (z3 + z4) * FIX(1.175875602);
        tmp0 = tmp0 * FIX(0.298631336);
        tmp1 = tmp1 * FIX(2.053119869);
        tmp2 = tmp2 * FIX(3.072711026);
        tmp3 = tmp3 * FIX(1.501321110);
        z1 = z1 * (-FIX(0.899976223));
        z2 = z2 * (-FIX(2.562915447));
        z3 = z3 * (-FIX(1.961570560));
        z4 = z4 * (-FIX(0.390180644));
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS - PASS1_BITS;
        ws[8 * 0 + c] = (int)DESCALE(tmp10 + tmp3, sh);
        ws[8 * 7 + c] = (int)DESCALE(tmp10 - tmp3, sh);
        ws[8 * 1 + c] = (int)DESCALE(tmp11 + tmp2, sh);
        ws[8 * 6 + c] = (int)DESCALE(tmp11 - tmp2, sh);
        ws[8 * 2 + c] = (int)DESCALE(tmp12 + tmp1, sh);
        ws[8 * 5 + c] = (int)DESCALE(tmp12 - tmp1, sh);
        ws[8 * 3 + c] = (int)DESCALE(tmp13 + tmp0, sh);
        ws[8 * 4 + c] = (int)DESCALE(tmp13 - tmp0, sh);
    }
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + (size_t)r * stride;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            uint8_t dc = range_limit(DESCALE((JLONG)w[0], PASS1_BITS + 3));
            for (int i = 0; i < 8; ++i) o[i] = dc;
            continue;
        }
        JLONG z2 = w[2], z3 = w[6];
        JLONG z1 = (z2 + z3) * FIX(0.541196100);
        JLONG tmp2 = z1 + z3 * (-FIX(1.847759065));
        JLONG tmp3 = z1 + z2 * FIX(0.765366865);
        JLONG tmp0 = ((JLONG)w[0] + (JLONG)w[4]) * (ONE << CONST_BITS);
        JLONG tmp1 = ((JLONG)w[0] - (JLONG)w[4]) * (ONE << CONST_BITS);
        JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        JLONG z4 = tmp1 + tmp3;
        JLONG z5 = (z3 + z4) * FIX(1.175875602);
        tmp0 = tmp0 * FIX(0.298631336);
        tmp1 = tmp1 * FIX(2.053119869);
        tmp2 = tmp2 * FIX(3.072711026);
        tmp3 = tmp3 * FIX(1.501321110);
        z1 = z1 * (-FIX(0.899976223));
        z2 = z2 * (-FIX(2.562915447));
        z3 = z3 * (-FIX(1.961570560));
        z4 = z4 * (-FIX(0.390180644));
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = range_limit(DESCALE(tmp10 + tmp3, sh));
        o[7] = range_limit(DESCALE(tmp10 - tmp3, sh));
        o[1] = range_limit(DESCALE(tmp11 + tmp2, sh));
        o[6] = range_limit(DESCALE(tmp11 - tmp2, sh));
        o[2] = range_limit(DESCALE(tmp12 + tmp1, sh));
        o[5] = range_limit(DESCALE(tmp12 - tmp1, sh));
        o[3] = range_limit(DESCALE(tmp13 + tmp0, sh));
        o[4] = range_limit(DESCALE(tmp13 - tmp0, sh));
    }
}

// jidctred.c jpeg_idct_1x1.
void idct_1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
    out[0] = range_limit(DESCALE((JLONG)in[0] * q[0], 3));
}

// jidctred.c jpeg_idct_2x2.
void idct_2(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[16];
    for (int c = 0; c < 8; ++c) {
        if (c == 2 || c == 4 || c == 6) continue;
        auto D = [&](int r) { return (JLONG)in[8 * r + c] * q[8 * r + c]; };
        JLONG tmp10 = D(0) * (ONE << (CONST_BITS + 2));
        JLONG tmp0 = D(7) * (-FIX(0.720959822)) + D(5) * FIX(0.850430095) +
                     D(3) * (-FIX(1.272758580)) + D(1) * FIX(3.624509785);
        ws[c] = (int)DESCALE(tmp10 + tmp0, CONST_BITS - PASS1_BITS + 2);
        ws[8 + c] = (int)DESCALE(tmp10 - tmp0, CONST_BITS - PASS1_BITS + 2);
    }
    for (int r = 0; r < 2; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + (size_t)r * stride;
        JLONG tmp10 = (JLONG)w[0] * (ONE << (CONST_BITS + 2));
        JLONG tmp0 = (JLONG)w[7] * (-FIX(0.720959822)) +
                     (JLONG)w[5] * FIX(0.850430095) +
                     (JLONG)w[3] * (-FIX(1.272758580)) +
                     (JLONG)w[1] * FIX(3.624509785);
        const int sh = CONST_BITS + PASS1_BITS + 3 + 2;
        o[0] = range_limit(DESCALE(tmp10 + tmp0, sh));
        o[1] = range_limit(DESCALE(tmp10 - tmp0, sh));
    }
}

// jidctred.c jpeg_idct_4x4.
void idct_4(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[32];
    auto odd = [](JLONG z1, JLONG z2, JLONG z3, JLONG z4, JLONG& tmp0,
                  JLONG& tmp2) {
        tmp0 = z1 * (-FIX(0.211164243)) + z2 * FIX(1.451774981) +
               z3 * (-FIX(2.172734803)) + z4 * FIX(1.061594337);
        tmp2 = z1 * (-FIX(0.509795579)) + z2 * (-FIX(0.601344887)) +
               z3 * FIX(0.899976223) + z4 * FIX(2.562915447);
    };
    for (int c = 0; c < 8; ++c) {
        if (c == 4) continue;
        auto D = [&](int r) { return (JLONG)in[8 * r + c] * q[8 * r + c]; };
        JLONG tmp0 = D(0) * (ONE << (CONST_BITS + 1));
        JLONG tmp2 = D(2) * FIX(1.847759065) + D(6) * (-FIX(0.765366865));
        JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
        odd(D(7), D(5), D(3), D(1), tmp0, tmp2);
        const int sh = CONST_BITS - PASS1_BITS + 1;
        ws[8 * 0 + c] = (int)DESCALE(tmp10 + tmp2, sh);
        ws[8 * 3 + c] = (int)DESCALE(tmp10 - tmp2, sh);
        ws[8 * 1 + c] = (int)DESCALE(tmp12 + tmp0, sh);
        ws[8 * 2 + c] = (int)DESCALE(tmp12 - tmp0, sh);
    }
    for (int r = 0; r < 4; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + (size_t)r * stride;
        JLONG tmp0 = (JLONG)w[0] * (ONE << (CONST_BITS + 1));
        JLONG tmp2 = (JLONG)w[2] * FIX(1.847759065) +
                     (JLONG)w[6] * (-FIX(0.765366865));
        JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
        odd(w[7], w[5], w[3], w[1], tmp0, tmp2);
        const int sh = CONST_BITS + PASS1_BITS + 3 + 1;
        o[0] = range_limit(DESCALE(tmp10 + tmp2, sh));
        o[3] = range_limit(DESCALE(tmp10 - tmp2, sh));
        o[1] = range_limit(DESCALE(tmp12 + tmp0, sh));
        o[2] = range_limit(DESCALE(tmp12 - tmp0, sh));
    }
}

// The jidctint.c scaled IDCTs share a frame: pass 1 over the columns (the
// dequantised coefficients, with the rounding fudge added to the DC term
// and the results scaled down by CONST_BITS - PASS1_BITS), pass 2 over the
// rows (fudge added to the workspace's DC term, scaled down by CONST_BITS +
// PASS1_BITS + 3).  `Kernel::run(x, y, first)` maps N inputs to N outputs
// (N <= 8) or 8 inputs to N outputs (N > 8); `first` says which pass.
template <int N, int NIN, class Kernel>
void idct_scaled(const int16_t* in, const uint16_t* q, uint8_t* out,
                 int stride) {
    int ws[NIN * N];
    for (int c = 0; c < NIN; ++c) {
        JLONG x[8];
        for (int r = 0; r < NIN; ++r) x[r] = (JLONG)in[8 * r + c] * q[8 * r + c];
        JLONG y[N];
        Kernel::run(x, y, true);
        for (int r = 0; r < N; ++r) ws[NIN * r + c] = (int)y[r];
    }
    for (int r = 0; r < N; ++r) {
        JLONG x[8];
        for (int c = 0; c < NIN; ++c) x[c] = ws[NIN * r + c];
        JLONG y[N];
        Kernel::run(x, y, false);
        uint8_t* o = out + (size_t)r * stride;
        for (int c = 0; c < N; ++c) o[c] = range_limit(y[c]);
    }
}

// Pass 1 shifts every result by CONST_BITS - PASS1_BITS and pass 2 by
// CONST_BITS + PASS1_BITS + 3.  Where libjpeg's pass 1 shifts one term
// early and adds another formed at PASS1_BITS scale (the 6x6, 10x10 and
// 14x14 IDCTs), the kernels here form that term at CONST_BITS and shift
// the sum: adding a multiple of 2^n before an arithmetic shift by n is the
// same as adding it after, so the bits are libjpeg's.  `dc_term(x0,
// first)` is the DC term at CONST_BITS scale with the rounding fudge in.
inline JLONG dc_term(JLONG x0, bool first) {
    if (first)
        return x0 * (ONE << CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    return (x0 + (ONE << (PASS1_BITS + 2))) * (ONE << CONST_BITS);
}
inline int out_shift(bool first) {
    return first ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS + 3;
}

struct K3 {  // jpeg_idct_3x3
    static void run(const JLONG* x, JLONG* y, bool first) {
        int sh = out_shift(first);
        JLONG tmp0 = dc_term(x[0], first);
        JLONG tmp12 = x[2] * FIX(0.707106781);
        JLONG tmp10 = tmp0 + tmp12;
        JLONG tmp2 = tmp0 - tmp12 - tmp12;
        tmp0 = x[1] * FIX(1.224744871);
        y[0] = RSH(tmp10 + tmp0, sh);
        y[2] = RSH(tmp10 - tmp0, sh);
        y[1] = RSH(tmp2, sh);
    }
};

struct K5 {  // jpeg_idct_5x5
    static void run(const JLONG* x, JLONG* y, bool first) {
        int sh = out_shift(first);
        JLONG tmp12 = dc_term(x[0], first);
        JLONG tmp0 = x[2], tmp1 = x[4];
        JLONG z1 = (tmp0 + tmp1) * FIX(0.790569415);
        JLONG z2 = (tmp0 - tmp1) * FIX(0.353553391);
        JLONG z3 = tmp12 + z2;
        JLONG tmp10 = z3 + z1, tmp11 = z3 - z1;
        tmp12 -= z2 * 4;
        z2 = x[1];
        z3 = x[3];
        z1 = (z2 + z3) * FIX(0.831253876);
        tmp0 = z1 + z2 * FIX(0.513743148);
        tmp1 = z1 - z3 * FIX(2.176250899);
        y[0] = RSH(tmp10 + tmp0, sh);
        y[4] = RSH(tmp10 - tmp0, sh);
        y[1] = RSH(tmp11 + tmp1, sh);
        y[3] = RSH(tmp11 - tmp1, sh);
        y[2] = RSH(tmp12, sh);
    }
};

struct K6 {  // jpeg_idct_6x6
    static void run(const JLONG* x, JLONG* y, bool first) {
        int sh = out_shift(first);
        JLONG tmp0 = dc_term(x[0], first);
        JLONG tmp10 = x[4] * FIX(0.707106781);
        JLONG tmp1 = tmp0 + tmp10;
        JLONG tmp11 = tmp0 - tmp10 - tmp10;
        tmp10 = x[2];
        tmp0 = tmp10 * FIX(1.224744871);
        tmp10 = tmp1 + tmp0;
        JLONG tmp12 = tmp1 - tmp0;
        JLONG z1 = x[1], z2 = x[3], z3 = x[5];
        tmp1 = (z1 + z3) * FIX(0.366025404);
        tmp0 = tmp1 + (z1 + z2) * (ONE << CONST_BITS);
        JLONG tmp2 = tmp1 + (z3 - z2) * (ONE << CONST_BITS);
        tmp1 = (z1 - z2 - z3) * (ONE << CONST_BITS);
        y[0] = RSH(tmp10 + tmp0, sh);
        y[5] = RSH(tmp10 - tmp0, sh);
        y[1] = RSH(tmp11 + tmp1, sh);
        y[4] = RSH(tmp11 - tmp1, sh);
        y[2] = RSH(tmp12 + tmp2, sh);
        y[3] = RSH(tmp12 - tmp2, sh);
    }
};

struct K7 {  // jpeg_idct_7x7
    static void run(const JLONG* x, JLONG* y, bool first) {
        int sh = out_shift(first);
        JLONG tmp13 = dc_term(x[0], first);
        JLONG z1 = x[2], z2 = x[4], z3 = x[6];
        JLONG tmp10 = (z2 - z3) * FIX(0.881747734);
        JLONG tmp12 = (z1 - z2) * FIX(0.314692123);
        JLONG tmp11 = tmp10 + tmp12 + tmp13 - z2 * FIX(1.841218003);
        JLONG tmp0 = z1 + z3;
        z2 -= tmp0;
        tmp0 = tmp0 * FIX(1.274162392) + tmp13;
        tmp10 += tmp0 - z3 * FIX(0.077722536);
        tmp12 += tmp0 - z1 * FIX(2.470602249);
        tmp13 += z2 * FIX(1.414213562);
        z1 = x[1];
        z2 = x[3];
        z3 = x[5];
        JLONG tmp1 = (z1 + z2) * FIX(0.935414347);
        JLONG tmp2 = (z1 - z2) * FIX(0.170262339);
        tmp0 = tmp1 - tmp2;
        tmp1 += tmp2;
        tmp2 = (z2 + z3) * (-FIX(1.378756276));
        tmp1 += tmp2;
        z2 = (z1 + z3) * FIX(0.613604268);
        tmp0 += z2;
        tmp2 += z2 + z3 * FIX(1.870828693);
        y[0] = RSH(tmp10 + tmp0, sh);
        y[6] = RSH(tmp10 - tmp0, sh);
        y[1] = RSH(tmp11 + tmp1, sh);
        y[5] = RSH(tmp11 - tmp1, sh);
        y[2] = RSH(tmp12 + tmp2, sh);
        y[4] = RSH(tmp12 - tmp2, sh);
        y[3] = RSH(tmp13, sh);
    }
};

struct K10 {  // jpeg_idct_10x10
    static void run(const JLONG* x, JLONG* y, bool first) {
        int sh = out_shift(first);
        JLONG z3 = dc_term(x[0], first);
        JLONG z4 = x[4];
        JLONG z1 = z4 * FIX(1.144122806);
        JLONG z2 = z4 * FIX(0.437016024);
        JLONG tmp10 = z3 + z1;
        JLONG tmp11 = z3 - z2;
        JLONG tmp22 = z3 - (z1 - z2) * 2;
        z2 = x[2];
        z3 = x[6];
        z1 = (z2 + z3) * FIX(0.831253876);
        JLONG tmp12 = z1 + z2 * FIX(0.513743148);
        JLONG tmp13 = z1 - z3 * FIX(2.176250899);
        JLONG tmp20 = tmp10 + tmp12, tmp24 = tmp10 - tmp12;
        JLONG tmp21 = tmp11 + tmp13, tmp23 = tmp11 - tmp13;
        z1 = x[1];
        z2 = x[3];
        z3 = x[5] * (ONE << CONST_BITS);
        z4 = x[7];
        tmp11 = z2 + z4;
        tmp13 = z2 - z4;
        tmp12 = tmp13 * FIX(0.309016994);
        z2 = tmp11 * FIX(0.951056516);
        z4 = z3 + tmp12;
        tmp10 = z1 * FIX(1.396802247) + z2 + z4;
        JLONG tmp14 = z1 * FIX(0.221231742) - z2 + z4;
        z2 = tmp11 * FIX(0.587785252);
        z4 = z3 - tmp12 - tmp13 * (ONE << (CONST_BITS - 1));
        tmp12 = (z1 - tmp13) * (ONE << CONST_BITS) - z3;
        tmp11 = z1 * FIX(1.260073511) - z2 - z4;
        tmp13 = z1 * FIX(0.642039522) - z2 + z4;
        y[0] = RSH(tmp20 + tmp10, sh);
        y[9] = RSH(tmp20 - tmp10, sh);
        y[1] = RSH(tmp21 + tmp11, sh);
        y[8] = RSH(tmp21 - tmp11, sh);
        y[2] = RSH(tmp22 + tmp12, sh);
        y[7] = RSH(tmp22 - tmp12, sh);
        y[3] = RSH(tmp23 + tmp13, sh);
        y[6] = RSH(tmp23 - tmp13, sh);
        y[4] = RSH(tmp24 + tmp14, sh);
        y[5] = RSH(tmp24 - tmp14, sh);
    }
};

struct K12 {  // jpeg_idct_12x12
    static void run(const JLONG* x, JLONG* y, bool first) {
        int sh = out_shift(first);
        JLONG z3 = dc_term(x[0], first);
        JLONG z4 = x[4] * FIX(1.224744871);
        JLONG tmp10 = z3 + z4, tmp11 = z3 - z4;
        JLONG z1 = x[2];
        z4 = z1 * FIX(1.366025404);
        z1 = z1 * (ONE << CONST_BITS);
        JLONG z2 = x[6] * (ONE << CONST_BITS);
        JLONG tmp12 = z1 - z2;
        JLONG tmp21 = z3 + tmp12, tmp24 = z3 - tmp12;
        tmp12 = z4 + z2;
        JLONG tmp20 = tmp10 + tmp12, tmp25 = tmp10 - tmp12;
        tmp12 = z4 - z1 - z2;
        JLONG tmp22 = tmp11 + tmp12, tmp23 = tmp11 - tmp12;
        z1 = x[1];
        z2 = x[3];
        z3 = x[5];
        z4 = x[7];
        tmp11 = z2 * FIX(1.306562965);
        JLONG tmp14 = z2 * (-FIX(0.541196100));
        tmp10 = z1 + z3;
        JLONG tmp15 = (tmp10 + z4) * FIX(0.860918669);
        tmp12 = tmp15 + tmp10 * FIX(0.261052384);
        tmp10 = tmp12 + tmp11 + z1 * FIX(0.280143716);
        JLONG tmp13 = (z3 + z4) * (-FIX(1.045510580));
        tmp12 += tmp13 + tmp14 - z3 * FIX(1.478575242);
        tmp13 += tmp15 - tmp11 + z4 * FIX(1.586706681);
        tmp15 += tmp14 - z1 * FIX(0.676326758) - z4 * FIX(1.982889723);
        z1 -= z4;
        z2 -= z3;
        z3 = (z1 + z2) * FIX(0.541196100);
        tmp11 = z3 + z1 * FIX(0.765366865);
        tmp14 = z3 - z2 * FIX(1.847759065);
        y[0] = RSH(tmp20 + tmp10, sh);
        y[11] = RSH(tmp20 - tmp10, sh);
        y[1] = RSH(tmp21 + tmp11, sh);
        y[10] = RSH(tmp21 - tmp11, sh);
        y[2] = RSH(tmp22 + tmp12, sh);
        y[9] = RSH(tmp22 - tmp12, sh);
        y[3] = RSH(tmp23 + tmp13, sh);
        y[8] = RSH(tmp23 - tmp13, sh);
        y[4] = RSH(tmp24 + tmp14, sh);
        y[7] = RSH(tmp24 - tmp14, sh);
        y[5] = RSH(tmp25 + tmp15, sh);
        y[6] = RSH(tmp25 - tmp15, sh);
    }
};

struct K14 {  // jpeg_idct_14x14
    static void run(const JLONG* x, JLONG* y, bool first) {
        int sh = out_shift(first);
        JLONG z1 = dc_term(x[0], first);
        JLONG z4 = x[4];
        JLONG z2 = z4 * FIX(1.274162392);
        JLONG z3 = z4 * FIX(0.314692123);
        z4 = z4 * FIX(0.881747734);
        JLONG tmp10 = z1 + z2, tmp11 = z1 + z3, tmp12 = z1 - z4;
        JLONG tmp23 = z1 - (z2 + z3 - z4) * 2;
        z1 = x[2];
        z2 = x[6];
        z3 = (z1 + z2) * FIX(1.105676686);
        JLONG tmp13 = z3 + z1 * FIX(0.273079590);
        JLONG tmp14 = z3 - z2 * FIX(1.719280954);
        JLONG tmp15 = z1 * FIX(0.613604268) - z2 * FIX(1.378756276);
        JLONG tmp20 = tmp10 + tmp13, tmp26 = tmp10 - tmp13;
        JLONG tmp21 = tmp11 + tmp14, tmp25 = tmp11 - tmp14;
        JLONG tmp22 = tmp12 + tmp15, tmp24 = tmp12 - tmp15;
        z1 = x[1];
        z2 = x[3];
        z3 = x[5];
        z4 = x[7] * (ONE << CONST_BITS);
        tmp14 = z1 + z3;
        tmp11 = (z1 + z2) * FIX(1.334852607);
        tmp12 = tmp14 * FIX(1.197448846);
        tmp10 = tmp11 + tmp12 + z4 - z1 * FIX(1.126980169);
        tmp14 = tmp14 * FIX(0.752406978);
        JLONG tmp16 = tmp14 - z1 * FIX(1.061150426);
        z1 -= z2;
        tmp15 = z1 * FIX(0.467085129) - z4;
        tmp16 += tmp15;
        tmp13 = (z2 + z3) * (-FIX(0.158341681)) - z4;
        tmp11 += tmp13 - z2 * FIX(0.424103948);
        tmp12 += tmp13 - z3 * FIX(2.373959773);
        tmp13 = (z3 - z2) * FIX(1.405321284);
        tmp14 += tmp13 + z4 - z3 * FIX(1.6906431334);
        tmp15 += tmp13 + z2 * FIX(0.674957567);
        tmp13 = (z1 - z3) * (ONE << CONST_BITS) + z4;
        y[0] = RSH(tmp20 + tmp10, sh);
        y[13] = RSH(tmp20 - tmp10, sh);
        y[1] = RSH(tmp21 + tmp11, sh);
        y[12] = RSH(tmp21 - tmp11, sh);
        y[2] = RSH(tmp22 + tmp12, sh);
        y[11] = RSH(tmp22 - tmp12, sh);
        y[3] = RSH(tmp23 + tmp13, sh);
        y[10] = RSH(tmp23 - tmp13, sh);
        y[4] = RSH(tmp24 + tmp14, sh);
        y[9] = RSH(tmp24 - tmp14, sh);
        y[5] = RSH(tmp25 + tmp15, sh);
        y[8] = RSH(tmp25 - tmp15, sh);
        y[6] = RSH(tmp26 + tmp16, sh);
        y[7] = RSH(tmp26 - tmp16, sh);
    }
};

using IdctFn = void (*)(const int16_t*, const uint16_t*, uint8_t*, int);

IdctFn idct_for(int size) {
    switch (size) {
    case 1: return idct_1;
    case 2: return idct_2;
    case 3: return idct_scaled<3, 3, K3>;
    case 4: return idct_4;
    case 5: return idct_scaled<5, 5, K5>;
    case 6: return idct_scaled<6, 6, K6>;
    case 7: return idct_scaled<7, 7, K7>;
    case 8: return idct_8;
    case 10: return idct_scaled<10, 8, K10>;
    case 12: return idct_scaled<12, 8, K12>;
    case 14: return idct_scaled<14, 8, K14>;
    default: fail("unsupported IDCT size");
    }
}

// ----------------------------------------------------------------------- //
// Output: IDCT per component, upsampling, colour conversion
// ----------------------------------------------------------------------- //

struct Plane {
    int w = 0, h = 0;       // valid samples (libjpeg's downsampled size)
    int stride = 0;
    std::vector<uint8_t> px;
    const uint8_t* row(int y) const {
        y = std::min(std::max(y, 0), h - 1);  // libjpeg's context rows
        return px.data() + (size_t)y * stride;
    }
};

inline long div_round_up(long a, long b) { return (a + b - 1) / b; }

// One component upsampled to [out_h, out_w] as libjpeg's upsampler does.
void upsample(const Plane& in, int eh, int ev, bool fancy, int out_w,
              int out_h, uint8_t* out) {
    std::vector<uint8_t> row(std::max((long)in.w * eh, (long)out_w) + 8);
    std::vector<int> sums(in.w);
    for (int y = 0; y < out_h; ++y) {
        uint8_t* o = out + (size_t)y * out_w;
        int iy = y / ev;
        const uint8_t* a = in.row(iy);
        if (ev == 2 && fancy && (eh == 1 || (eh == 2 && in.w > 2))) {
            // vertical triangle: 3/4 nearer row + 1/4 further row
            int v = y & 1;
            const uint8_t* b = in.row(v == 0 ? iy - 1 : iy + 1);
            if (eh == 1) {
                int bias = v == 0 ? 1 : 2;
                for (int x = 0; x < out_w; ++x)
                    o[x] = (uint8_t)((a[x] * 3 + b[x] + bias) >> 2);
                continue;
            }
            // h2v2: column sums, then the horizontal triangle
            int n = in.w;
            int* sum = sums.data();
            for (int x = 0; x < n; ++x) sum[x] = a[x] * 3 + b[x];
            uint8_t* r = row.data();
            r[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
            r[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
            for (int x = 1; x < n - 1; ++x) {
                r[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 8) >> 4);
                r[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 7) >> 4);
            }
            r[2 * n - 2] = (uint8_t)((sum[n - 1] * 3 + sum[n - 2] + 8) >> 4);
            r[2 * n - 1] = (uint8_t)((sum[n - 1] * 4 + 7) >> 4);
            std::memcpy(o, r, out_w);
            continue;
        }
        if (eh == 1) {
            std::memcpy(o, a, out_w);
        } else if (eh == 2 && fancy && in.w > 2 && ev == 1) {
            int n = in.w;
            uint8_t* r = row.data();
            r[0] = a[0];
            r[1] = (uint8_t)((a[0] * 3 + a[1] + 2) >> 2);
            for (int x = 1; x < n - 1; ++x) {
                int v3 = a[x] * 3;
                r[2 * x] = (uint8_t)((v3 + a[x - 1] + 1) >> 2);
                r[2 * x + 1] = (uint8_t)((v3 + a[x + 1] + 2) >> 2);
            }
            r[2 * n - 2] = (uint8_t)((a[n - 1] * 3 + a[n - 2] + 1) >> 2);
            r[2 * n - 1] = a[n - 1];
            std::memcpy(o, r, out_w);
        } else {
            // box: each sample repeated eh times (rows repeated ev times)
            for (int x = 0; x < out_w; ++x) o[x] = a[std::min(x / eh, in.w - 1)];
        }
    }
}

inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

struct YccTables {
    int cr_r[256], cb_b[256];
    JLONG cr_g[256], cb_g[256];
    YccTables() {
        const int SB = 16;
        auto F = [](double x) { return (JLONG)(x * (1L << 16) + 0.5); };
        for (int i = 0; i < 256; ++i) {
            JLONG x = i - 128;
            cr_r[i] = (int)((F(1.40200) * x + (1L << (SB - 1))) >> SB);
            cb_b[i] = (int)((F(1.77200) * x + (1L << (SB - 1))) >> SB);
            cr_g[i] = -F(0.71414) * x;
            cb_g[i] = -F(0.34414) * x + (1L << (SB - 1));
        }
    }
};
const YccTables kYcc;

// Pillow's CMYK -> RGB (`convert("RGB")`).
inline uint8_t cmyk_channel(int c, int nk) {
    int tmp = c * nk + 128;
    return clamp255(nk - (((tmp >> 8) + tmp) >> 8));
}

struct Decoded {
    int w, h;
    std::vector<uint8_t> rgb;
};

// Decodes the frame whose header `j` has read, at scale num/8.
Decoded decode(Jpeg& j, int num) {
    j.read_scans();
    int out_w = (int)div_round_up((long)j.width * num, 8);
    int out_h = (int)div_round_up((long)j.height * num, 8);
    int nc = (int)j.comps.size();
    bool fancy = num > 1;
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ++ci) {
        Component& c = j.comps[ci];
        int ss = num;
        while (ss < 8 && (j.max_h * num) % (c.h * ss * 2) == 0 &&
               (j.max_v * num) % (c.v * ss * 2) == 0)
            ss *= 2;
        IdctFn idct = idct_for(ss);
        Plane p;
        p.w = (int)div_round_up((long)j.width * c.h * ss, (long)j.max_h * 8);
        p.h = (int)div_round_up((long)j.height * c.v * ss, (long)j.max_v * 8);
        p.stride = c.bw_real * ss;
        p.px.assign((size_t)p.stride * c.bh_real * ss, 0);
        for (int by = 0; by < c.bh_real; ++by)
            for (int bx = 0; bx < c.bw_real; ++bx)
                idct(c.block(by, bx), c.q,
                     p.px.data() + (size_t)by * ss * p.stride + bx * ss,
                     p.stride);
        int in_h = c.h * ss / num, in_v = c.v * ss / num;
        if (j.max_h % in_h || j.max_v % in_v)
            fail("fractional sampling ratio");
        full[ci].resize((size_t)out_w * out_h);
        upsample(p, j.max_h / in_h, j.max_v / in_v, fancy, out_w, out_h,
                 full[ci].data());
    }
    Decoded d{out_w, out_h, std::vector<uint8_t>((size_t)out_w * out_h * 3)};
    uint8_t* o = d.rgb.data();
    size_t n = (size_t)out_w * out_h;
    ColorKind kind = j.color();
    if (kind == kGray) {
        const uint8_t* g = full[0].data();
        for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = g[i];
    } else if (kind == kRGB) {
        for (size_t i = 0; i < n; ++i)
            for (int k = 0; k < 3; ++k) o[3 * i + k] = full[k][i];
    } else if (kind == kYCbCr) {
        const uint8_t *Y = full[0].data(), *Cb = full[1].data(),
                      *Cr = full[2].data();
        for (size_t i = 0; i < n; ++i) {
            int y = Y[i], cb = Cb[i], cr = Cr[i];
            o[3 * i] = clamp255(y + kYcc.cr_r[cr]);
            o[3 * i + 1] =
                clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
            o[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
        }
    } else {
        for (size_t i = 0; i < n; ++i) {
            int c0 = full[0][i], c1 = full[1][i], c2 = full[2][i];
            int k = full[3][i];
            if (kind == kYCCK) {  // libjpeg's YCCK -> CMYK
                int y = c0, cb = c1, cr = c2;
                c0 = 255 - clamp255(y + kYcc.cr_r[cr]);
                c1 = 255 - clamp255(
                    y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
                c2 = 255 - clamp255(y + kYcc.cb_b[cb]);
            }
            // Pillow reads JPEG CMYK inverted ("CMYK;I"), then converts
            int nk = 255 - (255 - k);
            o[3 * i] = cmyk_channel(255 - c0, nk);
            o[3 * i + 1] = cmyk_channel(255 - c1, nk);
            o[3 * i + 2] = cmyk_channel(255 - c2, nk);
        }
    }
    return d;
}

int report(const char* what) {
    std::snprintf(g_error, sizeof(g_error), "%s", what);
    return 1;
}

}  // namespace

extern "C" {

const char* jpeg_error_message() { return g_error; }

// Header only.  *kind: 0 grey, 1 YCbCr, 2 RGB (libjpeg's RGB output takes
// these three), 3 CMYK, 4 YCCK (the JAX package hands these to Pillow).
int jpeg_probe(const uint8_t* data, long len, int* h, int* w, int* comps,
               int* kind, int* progressive) {
    try {
        Jpeg j(data, len);
        *h = j.height;
        *w = j.width;
        *comps = (int)j.comps.size();
        *kind = (int)j.color();
        *progressive = j.progressive ? 1 : 0;
        return 0;
    } catch (const std::exception& e) {
        return report(e.what());
    }
}

// Decode at scale num/8 (1..8) to RGB uint8 HWC in `out` (capacity in
// bytes); the size lands in *got_h, *got_w.
int jpeg_decode(const uint8_t* data, long len, int num, uint8_t* out,
                long out_cap, int* got_h, int* got_w) {
    try {
        if (num < 1 || num > 8) fail("scale must be 1/8 .. 8/8");
        Jpeg j(data, len);
        Decoded d = decode(j, num);
        if ((long)d.rgb.size() > out_cap) fail("output buffer too small");
        std::memcpy(out, d.rgb.data(), d.rgb.size());
        *got_h = d.h;
        *got_w = d.w;
        return 0;
    } catch (const std::exception& e) {
        return report(e.what());
    }
}

// The JAX package's jpeg_decode_resize with out_h, out_w > 0: the smallest
// DCT scale num/8 whose output still covers [out_h, out_w], then the
// shared bilinear resize to exactly that size (none when it already is).
// Returns 2, decoding nothing, for a CMYK or YCCK stream: libjpeg's RGB
// output refuses those, and the JAX package reads them with Pillow.
int jpeg_decode_resize(const uint8_t* data, long len, int out_h, int out_w,
                       uint8_t* out, long out_cap, int* got_h, int* got_w) {
    try {
        if (out_h <= 0 || out_w <= 0) fail("target size must be positive");
        if ((long)out_h * out_w * 3 > out_cap) fail("output buffer too small");
        Jpeg j(data, len);
        if (j.color() == kCMYK || j.color() == kYCCK) {
            report("CMYK or YCCK: libjpeg's RGB output refuses it");
            return 2;
        }
        int num = 8;
        while (num > 1 && j.height * (num - 1) / 8 >= out_h &&
               j.width * (num - 1) / 8 >= out_w)
            --num;
        Decoded d = decode(j, num);
        if (d.h == out_h && d.w == out_w)
            std::memcpy(out, d.rgb.data(), d.rgb.size());
        else
            bilinear_resize_u8(d.rgb.data(), d.h, d.w, 3, out, out_h, out_w);
        *got_h = out_h;
        *got_w = out_w;
        return 0;
    } catch (const std::exception& e) {
        return report(e.what());
    }
}

}  // extern "C"
