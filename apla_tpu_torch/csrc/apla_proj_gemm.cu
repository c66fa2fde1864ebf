// The APLA output projection of the fused attention forward, for Hopper
// (sm_90a): out[M, N] = o[M, K] @ w[K, N] over the flattened rows of the
// attention output o (M = B * N), bf16 in, f32 accumulated, bf16 out, or
// the f32 sums themselves.  On one rank K = N = C.  Under tensor
// parallelism (ops/fused_apla_attn.py, parallel/tensor.py) a rank holds
// H/T heads: o [M, K] with K = (H/T) * 64 meets its rows of the projection
// w [K, C], and the kernel writes the f32 partial [M, C] that the model
// group sums before the bias and one rounding.
//
// Replaces the projection inside the TPU kernels
// apla_tpu/ops/pallas_apla_attn.py:_fwd_kernel (called through _call_fwd;
// the f32 dot_general of o_cat and w at :124-129, rounded to the input
// dtype) and apla_tpu/ops/pallas_apla_attn_long.py:_fwd_kernel (through
// _call_fwd).  The attention half of those kernels is the memory-efficient
// attention forward (mha_fwd.cu), which writes o [B, N, C] bf16; this
// kernel reads it back (ops/fused_apla_attn.py launches the two).  On the
// H100 o fits the 50 MB L2 (16.8 MB at [8, 1025, 1024], 25.3 MB at
// [64, 257, 768]): writing and reading it once is 0.01-0.015 ms at the
// published 3.35 TB/s, which is all the single kernel's fusion saved.  The
// caller adds the projection's bias.
//
//   o   [M, K] bf16, row-major (the heads concatenated, as mha_fwd writes)
//   w   [K, N] bf16, row-major [d_in, d_out] (the assembled projection, or
//       its rows)
//   out [M, N] bf16 = bf16(sum over k16 steps, in increasing k, of
//                          o[:, k16] @ w[k16, :] in f32)
//       or f32: the same sums, unrounded (out_f32)
//
// Bits: each output is one f32 accumulator over all of K, the k16 steps
// taken in increasing order from +0, and no split of K, which is the order
// of the mma.sync projection this replaces, so the output is that kernel's
// to the last bit (chip_smoke.py phase 2 and tools/compare_mha_fwd.py
// --kernel fused check it).
//
// What bounds it on the H100: 2 M C^2 operations against 2 (2 M C + C^2)
// bytes; at M = 16448, C = 768 that is 19.4 GFLOP (0.0196 ms at 989
// TFLOP/s) against 51.7 MB (0.0154 ms at 3.35 TB/s): the tensor cores, by a
// little, at every shape the port gives it.  A tensor-parallel rank's share
// is 2 M K N operations against 2 (M K + K N) + 4 M N bytes (f32 out): at
// M = 2056, K = 384, N = 768 (ViT-B over two ranks, b8) 1.21 GFLOP (0.0012
// ms) against 8.5 MB (0.0025 ms), the memory.
//
// Design: gemm_sm90.cuh's kernel with o as a K-major A (64-column boxes of
// 128 rows) and w read in place as an MN-major B (64 x 64 boxes: the B
// operand of wgmma in its transposed form), bf16 out through TMA stores;
// the same body runs the fused backward's dO and dW_t GEMMs
// (fused_apla_attn_bwd.cu).  The launch plan (BN, stages, grid, shared
// memory) is decided by ops/apla_proj_gemm.py:gemm_plan; the three tensor
// maps are encoded at every call.

#include "gemm_sm90.cuh"

extern "C" {

// Opt the kernels in to the device's per-block shared memory limit on the
// current device, `device`; returns that limit in bytes, or -1.  Called once
// per device, before the first launch there.
int apla_proj_gemm_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return gemm90::set_smem<0, 1, false>(v) == 0 &&
                 gemm90::set_smem<0, 1, true>(v) == 0
             ? v
             : -1;
}

// out [M, N] = o [M, K] @ w [K, N] on `stream` with the plan of
// ops/apla_proj_gemm.py:gemm_plan (bn, stages, smem_bytes): bf16, or with
// out_f32 != 0 the f32 sums (`out` then f32 [M, N]).  Returns 0 when
// queued, a cudaError_t of the launch, 1000 + the CUresult of a tensor map
// that could not be encoded, or 2000 for a tile width with no kernel.  The
// caller checks shapes: K and N multiples of 64, 16-byte aligned contiguous
// tensors, the plan's shared memory within the device's limit.
int apla_proj_gemm(const void* o, const void* w, void* out, int M, int K,
                   int N, int bn, int stages, int smem_bytes, int out_f32,
                   void* stream) {
  CUtensorMap amap, wmap, cmap;
  const uint64_t a_row = 2ull * K, b_row = 2ull * N;
  int err = sm90::encode_bf16_3d(&amap, o, K, M, 1, a_row, a_row * M,
                                 gemm90::BM);
  if (err == 0)
    err = sm90::encode_bf16_3d(&wmap, w, N, K, 1, b_row, b_row * K,
                               gemm90::BK);
  // the bf16 output's map (an f32 output is written with plain stores)
  if (err == 0 && !out_f32)
    err = sm90::encode_bf16_3d(&cmap, out, N, M, 1, b_row, b_row * M, 64);
  if (err != 0) return 1000 + err;
  gemm90::Args a;
  a.K = K;
  a.chunk = K;
  a.stages = stages;
  a.M = M;
  a.N = N;
  a.out = out_f32 ? static_cast<float*>(out) : nullptr;
  if (out_f32)
    return gemm90::launch<0, 1, true>(amap, wmap, amap, a, bn, 1, smem_bytes,
                                      (cudaStream_t)stream);
  return gemm90::launch<0, 1, false>(amap, wmap, cmap, a, bn, 1, smem_bytes,
                                     (cudaStream_t)stream);
}

}  // extern "C"
