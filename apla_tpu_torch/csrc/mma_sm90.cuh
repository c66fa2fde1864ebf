// Warp-level building blocks shared by the port's hand-written kernels:
// ldmatrix operand loads, mma.sync m16n8k16 bf16 -> f32, cp.async copies,
// and the fragment helpers of a 16-row warp tile whose width (the head dim:
// 64 for the ViTs, 32 for Swin) follows from the fragment arrays' sizes.
//
// Fragment conventions (PTX ISA, mma.m16n8k16 with .bf16):
//   lane = 4 * g + t;  a C/D fragment acc[j][0..3] of n-tile j holds
//   (row g, cols 8j + 2t, +1) in [0..1] and (row g + 8, same cols) in [2..3].
// Shared-memory tiles hold up to 64 rows x 64 bf16 columns with a row
// stride of LDT = 72 elements, so the eight rows an ldmatrix reads fall on
// distinct banks; a 32-column tile uses the first half of each row.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace mma {

constexpr int LDT = 64 + 8;          // tile row stride (elements)
constexpr int TILE = 64 * LDT;       // elements per 64x64 tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte async copy; valid = false writes zeros (rows past the end)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Queue the copy of ROWS rows x COLS columns (row-major source `src`
// pointing at column 0 of the tile, row stride `stride` elements) into a
// [ROWS][LDT] tile; rows at or past n_rows are zero-filled.  NTHREADS
// threads, id `tid`.
template <int NTHREADS, int COLS = 64, int ROWS = 64>
__device__ __forceinline__ void issue_tile(bf16* dst, const bf16* src,
                                           long stride, int row0, int n_rows,
                                           int tid) {
  static_assert((COLS == 64 || COLS == 32) && ROWS <= 64, "tile shape");
  constexpr int SHIFT = COLS == 64 ? 3 : 2;   // log2 of 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < (ROWS << SHIFT); i += NTHREADS) {
    const int r = i >> SHIFT, c8 = (i & ((1 << SHIFT) - 1)) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * LDT + c8,
               ok ? src + (long)(row0 + r) * stride + c8 : src, ok);
  }
}

// A fragments of the warp's 16 rows (tile rows wrow..wrow+15, the first
// 16 * KS columns) of a row-major [64][LDT] tile.
template <int KS>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[KS][4],
                                            const bf16* tile, int wrow,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(a[kk][0], a[kk][1], a[kk][2], a[kk][3],
            tile + (wrow + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8);
}

// acc[j] += A (16 x 16KS, fragments a) . B^T where B is a [64][LDT] tile
// whose first 8NJ rows are the output columns (NJ n-tiles) and whose first
// 16KS columns are the contraction: the "q k^T" product.
template <int KS, int NJ>
__device__ __forceinline__ void warp_mma_nt(const uint32_t (&a)[KS][4],
                                            const bf16* bs, int lane,
                                            float (&acc)[NJ][4]) {
  static_assert(KS == 2 || KS == 4, "contraction of 32 or 64");
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t b[2 * KS];
    const bf16* row = bs + (8 * j + (lane & 7)) * LDT + (lane >> 3) * 8;
    ldsm_x4(b[0], b[1], b[2], b[3], row);
    if constexpr (KS == 4) ldsm_x4(b[4], b[5], b[6], b[7], row + 32);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_bf16(acc[j], a[kk], b[2 * kk], b[2 * kk + 1]);
  }
}

template <int NJ>
__device__ __forceinline__ void zero_acc(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// acc = the warp's 16 rows . the tile's 64 rows (zeroed first)
template <int KS>
__device__ __forceinline__ void warp_scores(const uint32_t (&a)[KS][4],
                                            const bf16* bs, int lane,
                                            float (&acc)[8][4]) {
  zero_acc(acc);
  warp_mma_nt(a, bs, lane, acc);
}

// acc[j] += P (16 x 64 as C fragments p, rounded to bf16 here) . V, where
// V is a row-major [64][LDT] tile: contraction over its 64 rows, output
// over its first 8NJ columns (the "p v" product).
template <int NJ>
__device__ __forceinline__ void warp_mma_pv(const float (&p)[8][4],
                                            const bf16* vs, int lane,
                                            float (&acc)[NJ][4]) {
  static_assert(NJ % 2 == 0, "output width a multiple of 16");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {            // contraction rows 16kk..+15
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int nn = 0; nn < NJ / 2; ++nn) {     // output columns 16nn..+15
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3,
                vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT
                   + nn * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * nn], pa, b0, b1);
      mma_bf16(acc[2 * nn + 1], pa, b2, b3);
    }
  }
}

// scores -> log2 units, -inf outside [lo, hi) of the fragment's row; the
// fragment's columns are col0 + 8j + e (col0 includes the lane's 2t)
__device__ __forceinline__ void scale_mask(float (&s)[8][4], int col0,
                                           float scale_log2, int lo0, int hi0,
                                           int lo1, int hi1) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      s[j][e] = (col >= lo0 && col < hi0) ? s[j][e] * scale_log2 : -INFINITY;
      s[j][2 + e] =
          (col >= lo1 && col < hi1) ? s[j][2 + e] * scale_log2 : -INFINITY;
    }
}

// Swin window scores -> log2 units: (s * scale + bias) + mask in f32, as
// the TPU kernel adds them, then times log2(e); -inf at a column or row at
// or past n.  The fragment's rows are r_lo and r_lo + 8, its columns
// col0 + 8j + e (col0 includes the lane's 2t).  bias and mask point at the
// [n, n] f32 planes of this head and this window; mask is null in a block
// that is not shifted.  TRANS: the fragment holds s^T (rows are keys,
// columns queries), so both are read at [column][row].
template <bool TRANS>
__device__ __forceinline__ void scale_bias_mask(float (&s)[8][4], int col0,
                                                int r_lo, int n, float scale,
                                                const float* __restrict__ bias,
                                                const float* __restrict__ mask) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + 8 * j + (e & 1);
      const int row = r_lo + (e >> 1) * 8;
      float v = -INFINITY;
      if (col < n && row < n) {
        const int idx = TRANS ? col * n + row : row * n + col;
        v = __fadd_rn(__fmul_rn(s[j][e], scale), __ldg(bias + idx));
        if (mask != nullptr) v = __fadd_rn(v, __ldg(mask + idx));
        v *= LOG2E;
      }
      s[j][e] = v;
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store the warp's 16 x 8NJ f32 fragments as bf16 at dst (row 0 of the
// warp's rows, column 0; row stride ld), rows at or past n_rows skipped.
template <int NJ>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long ld,
                                                const float (&acc)[NJ][4],
                                                int r_lo, int n_rows, int g,
                                                int t) {
  bf16* lo = dst + (long)g * ld + 2 * t;
  bf16* hi = lo + 8 * ld;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(lo + 8 * j) = pack_bf16(acc[j][0],
                                                           acc[j][1]);
    if (r_lo + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(hi + 8 * j) = pack_bf16(acc[j][2],
                                                           acc[j][3]);
  }
}

}  // namespace mma
