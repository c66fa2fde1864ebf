// Pieces that the one-warpgroup attention forwards on TMA and wgmma share:
// mha_fwd.cu (head dim 64: TPU rows 1, 5 and 8) and swin_attn_fwd.cu (head
// dim 32: the Swin windows, row 3).  Both tile q, K and V in 64-row boxes
// loaded by TMA and counted on mbarriers, keep a block's two q tiles at the
// base of its shared memory, and hold each score row as wgmma's m64
// accumulator lays it out: a thread's rows g and g + 8 of its warp's 16,
// each row spread over the quad of threads that share g.

#pragma once

#include "sm90_async.cuh"

#include <math.h>

namespace attn90 {

using namespace sm90;

constexpr int NT = 128;                 // one warpgroup
constexpr int BM = 64;                  // rows per tile (query and key)
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special-function unit, results below 2^-126 flushed to 0 (such
// a p weighs nothing beside the row maximum's 2^0); on the inputs of
// tools/compare_mha_fwd.py the outputs equal, bit for bit, those of a
// kernel that calls exp2f.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s (+)= q k^T over the DH head columns, NC of the key tile's rows (q and k
// K-major tiles: a k16 step is 32 bytes, 2 in the descriptor's units)
template <int DH, int NC>
__device__ __forceinline__ void scores_n(float (&s)[32], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<NC>(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// q tile `buf` of the block (at sm + buf * 64 * DH * 2 bytes): rows qt * 64
// .. qt * 64 + 63 of head h of image or window b, on barrier qbar[buf]
template <int DH>
__device__ __forceinline__ void load_q(uint8_t* sm, uint64_t* qbar,
                                       const CUtensorMap* qmap, int h,
                                       int qt, int b, int buf) {
  constexpr int bytes = BM * DH * 2;
  mbar_expect_tx(qbar + buf, bytes);
  tma_load_3d(sm + buf * bytes, qmap, qbar + buf, h * DH, qt * BM, b);
}

// running max and sum of one key tile's scores s (log2 units) into (m, l),
// each row's sum taken against its running maximum; 2^x by ex2 (FLUSH) or
// by exp2f
template <bool FLUSH>
__device__ __forceinline__ void online_stats(const float (&s)[32], float& m0,
                                             float& m1, float& l0,
                                             float& l1) {
  auto pow2 = [](float x) {
    if constexpr (FLUSH) return ex2(x);
    else return exp2f(x);
  };
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  const float ref0 = (mn0 == -INFINITY) ? 0.0f : mn0;
  const float ref1 = (mn1 == -INFINITY) ? 0.0f : mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sum0 += pow2(s[4 * j] - ref0) + pow2(s[4 * j + 1] - ref0);
    sum1 += pow2(s[4 * j + 2] - ref1) + pow2(s[4 * j + 3] - ref1);
  }
  l0 = l0 * pow2(m0 - ref0) + quad_sum(sum0);
  l1 = l1 * pow2(m1 - ref1) + quad_sum(sum1);
  m0 = mn0;
  m1 = mn1;
}

// Opt a kernel in to `bytes` of dynamic shared memory; 0 or a cudaError_t.
template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
}

}  // namespace attn90
