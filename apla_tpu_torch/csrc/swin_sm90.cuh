// What the Swin window attention's forward (swin_attn_fwd.cu, TPU row 3)
// and backward (swin_attn_bwd.cu, row 4) share on Hopper (sm_90a): the
// head-dim-32 tiles, TMA boxes of 32 columns x 64 rows with the 64-byte
// swizzle (sm90_async.cuh: swz64, desc_kmajor64, desc_mnmajor64), and the
// score terms.
//
// The scores of head h of window b are formed as the single mma.sync
// kernel of the first port formed them, so that both files keep its bits:
//
//   s = ((q k^T) * scale + bias[h]) + mask[b mod nW]     in f32, each step
//       rounded (__fmul_rn, __fadd_rn: nvcc must not contract them), the
//       mask added only in a shifted block; then times log2(e)
//
// and -inf at a column or row at or past N.  The bias and mask rows are
// 4 N bytes (no multiple of 16 at N = 49), so neither TMA nor a bulk copy
// takes them: each thread reads its terms by __ldg into registers, and the
// kernels issue those reads while the q k^T wgmmas run.

#pragma once

#include "attn_fwd_sm90.cuh"

namespace swin90 {

using namespace attn90;

constexpr int DH = 32;                  // head dim (every Swin model's)
constexpr int TILE_BYTES = BM * DH * 2; // 4 KB: 64 rows x 32 columns

// The bias and mask terms of the first WD columns of key tile kt at the
// thread's rows r_lo and r_lo + 8 (0 where a column or row lies at or past
// n, or where there is no mask), read into registers.  bias_h and mask_w
// point at the [n, n] f32 planes of this head and this window; MASKED: a
// shifted block (mask_w is read).
template <int WD, bool MASKED>
__device__ __forceinline__ void fetch_terms_of(
    float (&bt)[32], float (&mt)[32], int kt, int r_lo, int t, int n,
    const float* __restrict__ bias_h, const float* __restrict__ mask_w) {
#pragma unroll
  for (int j = 0; j < WD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kt * BM + 8 * j + 2 * t + (e & 1);
      const int row = r_lo + (e >> 1) * 8;
      bt[4 * j + e] = mt[4 * j + e] = 0.0f;
      if (col < n && row < n) {
        const int idx = row * n + col;
        bt[4 * j + e] = __ldg(bias_h + idx);
        if constexpr (MASKED) mt[4 * j + e] = __ldg(mask_w + idx);
      }
    }
}

// The same with the block's one test of mask_w outside the unrolled loop
// (a test per term held the loads back on the H100: PERF.md §6, row 4)
template <int WD>
__device__ __forceinline__ void fetch_terms(float (&bt)[32], float (&mt)[32],
                                            int kt, int r_lo, int t, int n,
                                            const float* __restrict__ bias_h,
                                            const float* __restrict__ mask_w) {
  if (mask_w != nullptr)
    fetch_terms_of<WD, true>(bt, mt, kt, r_lo, t, n, bias_h, mask_w);
  else
    fetch_terms_of<WD, false>(bt, mt, kt, r_lo, t, n, bias_h, mask_w);
}

// The first WD columns of key tile kt's scores s (the wgmma accumulator:
// rows r_lo, r_lo + 8) to log2 units with the terms fetched above, as the
// header states; `masked`: the block is shifted.
template <int WD>
__device__ __forceinline__ void add_terms(float (&s)[32],
                                          const float (&bt)[32],
                                          const float (&mt)[32], int kt,
                                          int r_lo, int t, int n, float scale,
                                          bool masked) {
#pragma unroll
  for (int j = 0; j < WD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kt * BM + 8 * j + 2 * t + (e & 1);
      const int row = r_lo + (e >> 1) * 8;
      float v = -INFINITY;
      if (col < n && row < n) {
        v = __fadd_rn(__fmul_rn(s[4 * j + e], scale), bt[4 * j + e]);
        if (masked) v = __fadd_rn(v, mt[4 * j + e]);
        v *= LOG2E;
      }
      s[4 * j + e] = v;
    }
}

// fetch_terms then add_terms, for a kernel with nothing to overlap them
template <int WD>
__device__ __forceinline__ void bias_mask(float (&s)[32], int kt, int r_lo,
                                          int t, int n, float scale,
                                          const float* __restrict__ bias_h,
                                          const float* __restrict__ mask_w) {
  float bt[32], mt[32];
  fetch_terms<WD>(bt, mt, kt, r_lo, t, n, bias_h, mask_w);
  add_terms<WD>(s, bt, mt, kt, r_lo, t, n, scale, mask_w != nullptr);
}

// A 64 x 32 f32 accumulator (rows 16 warp + g and + 8) rounded to bf16 into
// a 64-byte-swizzled tile at `tile`, the layout a TMA store of a 32-column
// box reads.
__device__ __forceinline__ void stage_tile(const float (&acc)[16],
                                           uint8_t* tile, int tid) {
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + swz64(r0, col)) =
        pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + swz64(r0 + 8, col)) =
        pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// A 3-D map of bf16 [d2][d1][d0] (row-major) with boxes of 32 elements x 64
// rows and the 64-byte swizzle
inline int encode_dh32(CUtensorMap* map, const void* base, uint64_t d0,
                       uint64_t d1, uint64_t d2) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, d0, d1, d2,
                   2 * d0, 2 * d0 * d1, DH, BM, CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace swin90
