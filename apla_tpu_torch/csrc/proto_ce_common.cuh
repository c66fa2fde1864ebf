// Tile helpers of the prototype cross-entropy forward (proto_ce_fwd.cu).
//
// Shapes: x [R, D] bf16 rows (the L2-normalised head bottlenecks), w [D, K]
// bf16 (the weight-normalised prototype layer, K contiguous), D = 256.  A
// block of 8 warps works on a tile of 64 rows x 64 prototype columns: warp w
// computes the logits of rows 16 * (w & 3) .. +15 and columns
// 32 * (w >> 2) .. +31 of the tile, as mma.sync m16n8k16 C fragments
// acc[j][e] (mma_sm90.cuh): row 16 * (w & 3) + g (+8 for e >= 2), column
// 32 * (w >> 2) + 8 j + 2 t + (e & 1), with g = lane / 4, t = lane % 4.
//
// Shared-memory layouts: x tiles [64][LDX] (LDX = D + 8: the eight rows an
// ldmatrix reads fall on distinct banks), w tiles [D][LDT] (LDT = 72).

#pragma once

#include "mma_sm90.cuh"

namespace proto {

using namespace mma;

constexpr int D = 256;                 // bottleneck width
constexpr int LDX = D + 8;             // x tile row stride (elements)
constexpr int BR = 64;                 // rows per tile
constexpr int BK = 64;                 // prototype columns per tile
constexpr int NT = 256;                // 8 warps
constexpr int X_TILE = BR * LDX;       // elements of one x tile
constexpr int W_TILE = D * LDT;        // elements of one w tile
constexpr float LN2 = 0.6931471805599453f;

// Queue the copy of rows [row0, row0 + 64) of x into a [64][LDX] tile; rows
// at or past R are zero-filled.
__device__ __forceinline__ void issue_x(bf16* dst, const bf16* x, int row0,
                                        int R, int tid) {
#pragma unroll
  for (int i = tid; i < BR * (D / 8); i += NT) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const bool ok = row0 + r < R;
    cp_async16(dst + r * LDX + c8, ok ? x + (long)(row0 + r) * D + c8 : x,
               ok);
  }
}

// Queue the copy of columns [col0, col0 + 64) of w (D rows, row stride K)
// into a [D][LDT] tile; columns at or past K are zero-filled (K % 8 == 0,
// so a 16-byte chunk is either all in or all out).
__device__ __forceinline__ void issue_w(bf16* dst, const bf16* w, int col0,
                                        int K, int tid) {
#pragma unroll
  for (int i = tid; i < D * 8; i += NT) {
    const int r = i >> 3, c8 = (i & 7) * 8;
    const bool ok = col0 + c8 < K;
    cp_async16(dst + r * LDT + c8, ok ? w + (long)r * K + col0 + c8 : w, ok);
  }
}

// acc = x tile rows wrow..wrow+15 . w tile columns 32*half..+31 (contraction
// over D), zeroed first.
__device__ __forceinline__ void tile_logits(const bf16* xs, const bf16* ws,
                                            int wrow, int half, int lane,
                                            float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a[0], a[1], a[2], a[3],
            xs + (wrow + (lane & 15)) * LDX + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3,
                ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT
                   + half * 32 + nn * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * nn], a, b0, b1);
      mma_bf16(acc[2 * nn + 1], a, b2, b3);
    }
  }
}

// The student and teacher logits of the warp's fragment in log2 units:
// s2 = (xs ws) * ks with ks = log2(e) / tau_s, t2 = (xt wt - c) * kt with
// kt = log2(e) / tau_t; -inf at columns at or past K.  col0 is the column
// of acc[0][0] for t = 0 (tile column 0 + 32 * half).
__device__ __forceinline__ void scale_logits(float (&s)[4][4],
                                             float (&tv)[4][4],
                                             const float* __restrict__ c,
                                             int col0, int t, int K, float ks,
                                             float kt) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + 2 * t + e;
      const bool ok = col < K;
      const float cv = ok ? __ldg(c + col) : 0.f;
      s[j][e] = ok ? s[j][e] * ks : -INFINITY;
      s[j][2 + e] = ok ? s[j][2 + e] * ks : -INFINITY;
      tv[j][e] = ok ? (tv[j][e] - cv) * kt : -INFINITY;
      tv[j][2 + e] = ok ? (tv[j][2 + e] - cv) * kt : -INFINITY;
    }
}

}  // namespace proto
