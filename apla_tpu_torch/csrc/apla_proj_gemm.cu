// The APLA output projection of the fused attention forward, for Hopper
// (sm_90a): out[M, C] = o[M, C] @ w[C, C] over the flattened rows of the
// attention output o (M = B * N), bf16 in, f32 accumulated, bf16 out.
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
//   o   [M, C] bf16, row-major (the heads concatenated, as mha_fwd writes)
//   w   [C, C] bf16, row-major [d_in, d_out] (the assembled projection)
//   out [M, C] bf16 = bf16(sum over k16 steps, in increasing k, of
//                          o[:, k16] @ w[k16, :] in f32)
//
// Bits: each output is one f32 accumulator over all of C, the k16 steps
// taken in increasing order from +0, and no split of K, which is the order
// of the mma.sync projection this replaces, so the output is that kernel's
// to the last bit (chip_smoke.py phase 2 and tools/compare_mha_fwd.py
// --kernel fused check it).
//
// What bounds it on the H100: 2 M C^2 operations against 2 (2 M C + C^2)
// bytes; at M = 16448, C = 768 that is 19.4 GFLOP (0.0196 ms at 989
// TFLOP/s) against 51.7 MB (0.0154 ms at 3.35 TB/s): the tensor cores, by a
// little, at every shape the port gives it.
//
// Design:
//  * one block per BM x BN output tile (BM = 128: two consumer warpgroups
//    of 64 rows each; BN = 128 or 256 columns, a template), blocks
//    ordered with the column tiles fastest, so the blocks in flight share
//    their rows of o in L2; w (1.2-2 MB) stays in L2 for the whole call.
//  * a producer warp (one thread) feeds a ring of `stages` stages by TMA:
//    per 64-deep step of the contraction, one box of o (64 columns x 128
//    rows, K-major) and BN / 64 boxes of w read in place (64 columns x 64
//    rows, MN-major: the B operand of wgmma in its transposed form), all
//    with the 128-byte swizzle, counted on the stage's "full" mbarrier;
//    TMA zero-fills rows of o past M and columns of w past C.
//  * each consumer warpgroup runs four wgmma m64nBNk16 per stage into its
//    64 x BN f32 accumulator in registers, keeps one group in flight
//    (wgmma.wait_group 1), and releases the stage before it on the stage's
//    "empty" mbarrier (one arrival per warpgroup).
//  * the epilogue rounds to bf16 and stages the warpgroup's tile, swizzled,
//    in its own 64-row halves of the ring's o boxes (free once its last
//    wgmma has retired: every load has landed and no other warpgroup reads
//    them), then one thread stores it with BN / 64 TMA stores, which clip
//    rows past M and columns past C.
// The launch plan (BN, stages, grid, shared memory) is decided by
// ops/apla_proj_gemm.py:gemm_plan; the three tensor maps are encoded at
// every call.

#include "sm90_async.cuh"

namespace {

using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                     // rows per block
constexpr int BK = 64;                      // contraction per stage
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int NT = CONSUMERS + 32;          // and the producer warp
constexpr int A_BYTES = BM * BK * 2;        // 16 KB: the o box
constexpr int HALF_A = A_BYTES / 2;         // one warpgroup's 64 rows
constexpr int W_TILE = BK * 64 * 2;         // 8 KB: one 64 x 64 w box

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + (BN / 64) * W_TILE;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// amap: o as [1][M][C] with boxes {64, 128, 1}; wmap: w as [1][C][C] with
// boxes {64, 64, 1}; cmap: out as [1][M][C] with boxes {64, 64, 1}.
// Blocks: x over the column tiles of BN, y over the row tiles of BM.
// Two blocks share an SM at BN = 128 with three stages (96 KB each).
template <int BN>
__global__ void __launch_bounds__(NT, BN == 128 ? 2 : 1)
apla_proj_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap cmap, int K,
                      int stages) {
  constexpr int STAGE = stage_bytes<BN>();
  constexpr int NB = BN / 64;               // w boxes per stage
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + stages * STAGE);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = K / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                   // the producer warp
    if (tid == CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty + s, (i / stages - 1) & 1);
        uint8_t* st = sm + s * STAGE;
        mbar_expect_tx(full + s, STAGE);
        tma_load_3d(st, &amap, full + s, i * BK, m0, 0);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load_3d(st + A_BYTES + j * W_TILE, &wmap, full + s,
                      n0 + 64 * j, i * BK, 0);
      }
    }
    return;
  }

  const int wg = tid >> 7, wtid = tid & 127;
  float acc[BN / 2];
  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    mbar_wait(full + s, (i / stages) & 1);
    const uint8_t* st = sm + s * STAGE;
    const uint64_t da = desc_kmajor(st + wg * HALF_A);
    const uint64_t dw = desc_sw128(st + A_BYTES, W_TILE, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)    // +32 bytes of o, +16 rows of w
      wgmma_ss_tb<BN>(acc, da + 2 * kk, dw + kk * (16 * 128 >> 4),
                      i > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait1();                          // stage i - 1's wgmmas retired
    if (i > 0 && wtid == 0) mbar_arrive(empty + (i - 1) % stages);
  }
  wgmma_wait0();
  // The first k16 step overwrites the accumulator (a zeroed one, written
  // by ordinary instructions, makes ptxas serialise the wgmmas); adding +0
  // at the end gives what a sum started from +0 gives, -0 included.
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    asm volatile("" : "+f"(acc[e])::"memory");  // read acc from here on
    acc[e] += 0.0f;
  }

  // bf16 tile, staged swizzled in this warpgroup's halves of the o boxes
  // of stages 0 .. NB - 1, then stored by TMA
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint8_t* box = sm + (j / 8) * STAGE + wg * HALF_A;
    const int col = 8 * (j % 8) + 2 * t;
    *reinterpret_cast<uint32_t*>(box + swz128(r0, col)) =
        pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(box + swz128(r0 + 8, col)) =
        pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (wtid == 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_store_3d(&cmap, sm + j * STAGE + wg * HALF_A, n0 + 64 * j,
                   m0 + 64 * wg, 0);
    tma_store_commit();
    tma_store_wait_all();
  }
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, int, int);

Kernel kernel_for(int bn) {
  return bn == 128 ? apla_proj_gemm_kernel<128>
         : bn == 256 ? apla_proj_gemm_kernel<256>
                     : nullptr;
}

}  // namespace

extern "C" {

// Opt the kernels in to the device's per-block shared memory limit on the
// current device, `device`; returns that limit in bytes, or -1.  Called once
// per device, before the first launch there.
int apla_proj_gemm_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  for (int bn = 128; bn <= 256; bn *= 2)
    if (cudaFuncSetAttribute((const void*)kernel_for(bn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             v) != cudaSuccess)
      return -1;
  return v;
}

// out [M, C] = o [M, C] @ w [C, C] on `stream` with the plan of
// ops/apla_proj_gemm.py:gemm_plan (bn, stages, smem_bytes).  Returns 0 when
// queued, a cudaError_t of the launch, 1000 + the CUresult of a tensor map
// that could not be encoded, or 2000 for a tile width with no kernel.  The
// caller checks shapes: C a multiple of 64, 16-byte aligned contiguous
// tensors, the plan's shared memory within the device's limit.
int apla_proj_gemm(const void* o, const void* w, void* out, int M, int C,
                   int bn, int stages, int smem_bytes, void* stream) {
  const Kernel k = kernel_for(bn);
  if (k == nullptr) return 2000;
  CUtensorMap amap, wmap, cmap;
  const uint64_t row = 2ull * C;
  int err = encode_bf16_3d(&amap, o, C, M, 1, row, row * M, BM);
  if (err == 0)
    err = encode_bf16_3d(&wmap, w, C, C, 1, row, row * C, BK);
  if (err == 0)
    err = encode_bf16_3d(&cmap, out, C, M, 1, row, row * M, 64);
  if (err != 0) return 1000 + err;
  dim3 grid((C + bn - 1) / bn, (M + BM - 1) / BM);
  k<<<grid, NT, smem_bytes, (cudaStream_t)stream>>>(amap, wmap, cmap, C,
                                                    stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
