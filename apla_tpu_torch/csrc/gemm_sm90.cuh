// A bf16 GEMM for Hopper (sm_90a) with f32 sums: TMA loads into a ring of
// stages fed by a producer warp, two consumer warpgroups running wgmma.
// Shared by the forwards' projections (apla_proj_gemm.cu, swin_attn_fwd.cu:
// out = o w) and the backwards' two GEMMs (fused_apla_attn_bwd.cu,
// swin_attn_bwd.cu: dO = g w^T and the dW_t partials o_cat^T g_t over
// chunks of rows, then their fixed-order sum, dw_reduce_kernel).
//
//   C [M, N] = A [M, K] B [K, N] over k in [k_begin, k_end) of the block's
//   chunk (blockIdx.z; one chunk of all K for a plain product), one f32
//   accumulator per output, k16 steps in increasing k from +0, no split of
//   K: the sum order of the mma.sync kernels these replaced, so the
//   outputs are theirs to the last bit.
//
// Operands, each read in place through a 3-D tensor map of a row-major
// bf16 tensor, 64-column boxes with the 128-byte swizzle (sm90_async.cuh):
//   A_MN = 0: A row-major [M, K] (K-major): one box of 64 k x 128 rows;
//   A_MN = 1: A given as its transpose, row-major [K, M] (MN-major): two
//             boxes of 64 m x 64 k rows, one per warpgroup (o_cat^T);
//   B_MN = 0: B given as its transpose, row-major [N, K] (K-major): one box
//             of 64 k x BN rows (w^T);
//   B_MN = 1: B row-major [K, N] (MN-major): BN / 64 boxes of 64 n x 64 k
//             rows (w, g_t).
// TMA zero-fills what lies past the tensors' edges (rows past M, columns
// past N, k past K), so ragged shapes need no padding copies.
//
// What bounds it on the H100: 2 M N K operations against the bytes of A,
// B and C; at the port's shapes (M = 16448 rows, N = K = 768: 19.4 GFLOP,
// 0.0196 ms at 989 TFLOP/s, against 51.7 MB, 0.0154 ms at 3.35 TB/s) the
// tensor cores, by a little.
//
// Design:
//  * one block per BM x BN output tile (BM = 128: two consumer warpgroups
//    of 64 rows each; BN = 128 or 256 columns, a template), blocks ordered
//    with the column tiles fastest, so the blocks in flight share their
//    rows of A in L2; B (at most 2 MB) stays in L2 for the whole call.
//  * a producer warp (one thread) keeps `stages` stages of A and B boxes in
//    flight, counted on each stage's "full" mbarrier.
//  * each consumer warpgroup runs four wgmma m64nBNk16 per stage into its
//    64 x BN f32 accumulator in registers, keeps one group in flight
//    (wgmma.wait_group 1), and releases the stage before it on the stage's
//    "empty" mbarrier (one arrival per warpgroup).
//  * bf16 out: the epilogue rounds and stages the warpgroup's tile,
//    swizzled, in its own 64-row halves of the ring's A boxes (free once its
//    last wgmma has retired: every load has landed and no other warpgroup
//    reads them), then one thread stores it with BN / 64 TMA stores, which
//    clip rows past M and columns past N.  f32 out (the dW_t partials):
//    plain 8-byte stores of the fragments into the chunk's [M, N] slice.
// Plans (BN, stages, grid, shared memory) come from
// ops/apla_proj_gemm.py:gemm_plan.

#pragma once

#include "sm90_async.cuh"

namespace gemm90 {

using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                     // rows per block
constexpr int BK = 64;                      // contraction per stage
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int NT = CONSUMERS + 32;          // and the producer warp
constexpr int A_BYTES = BM * BK * 2;        // 16 KB: the A box(es)
constexpr int HALF_A = A_BYTES / 2;         // one warpgroup's 64 rows
constexpr int B_TILE = BK * 64 * 2;         // 8 KB: 64 k x 64 columns of B

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + (BN / 64) * B_TILE;
}

struct Args {
  int K;            // contraction length
  int chunk;        // contraction rows per blockIdx.z (K for one chunk)
  int stages;
  int M, N;         // output extent (the f32 stores' bounds)
  float* out;       // f32 out: [gridDim.z][M][N]; bf16 out: unused
};

// amap, bmap: the operands as above; cmap: C as [1][M][N] with boxes
// {64, 64, 1} (bf16 out only).  Blocks: x over the column tiles of BN, y
// over the row tiles of BM, z over the chunks.  Two blocks share an SM at
// BN = 128 with three stages (96 KB each).
template <int BN, int A_MN, int B_MN, bool F32_OUT>
__global__ void __launch_bounds__(NT, BN == 128 ? 2 : 1)
gemm_kernel(const __grid_constant__ CUtensorMap amap,
            const __grid_constant__ CUtensorMap bmap,
            const __grid_constant__ CUtensorMap cmap, const Args a) {
  constexpr int STAGE = stage_bytes<BN>();
  constexpr int NB = BN / 64;               // B boxes (MN-major) per stage
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  const int stages = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + stages * STAGE);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * a.chunk;     // every chunk non-empty
  const int nk = (min(a.K, k_begin + a.chunk) - k_begin + BK - 1) / BK;

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
        const int s = i % stages, k = k_begin + i * BK;
        if (i >= stages) mbar_wait(empty + s, (i / stages - 1) & 1);
        uint8_t* st = sm + s * STAGE;
        mbar_expect_tx(full + s, STAGE);
        if (A_MN) {
          tma_load_3d(st, &amap, full + s, m0, k, 0);
          tma_load_3d(st + HALF_A, &amap, full + s, m0 + 64, k, 0);
        } else {
          tma_load_3d(st, &amap, full + s, k, m0, 0);
        }
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            tma_load_3d(st + A_BYTES + j * B_TILE, &bmap, full + s,
                        n0 + 64 * j, k, 0);
        } else {
          tma_load_3d(st + A_BYTES, &bmap, full + s, k, n0, 0);
        }
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
    const uint64_t da = A_MN ? desc_mnmajor(st + wg * HALF_A)
                             : desc_kmajor(st + wg * HALF_A);
    const uint64_t db = B_MN ? desc_sw128(st + A_BYTES, B_TILE, 1024)
                             : desc_kmajor(st + A_BYTES);
    // a k16 step: +32 bytes of a K-major box, +16 rows of an MN-major one
    constexpr uint32_t KSTEP_A = A_MN ? (16 * 128 >> 4) : 2;
    constexpr uint32_t KSTEP_B = B_MN ? (16 * 128 >> 4) : 2;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_t<BN, A_MN, B_MN>(acc, da + kk * KSTEP_A, db + kk * KSTEP_B,
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

  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  if constexpr (F32_OUT) {
    float* out = a.out + (long)blockIdx.z * a.M * a.N;
    const int row = m0 + 64 * wg + r0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= a.N) continue;
      if (row < a.M)
        *reinterpret_cast<float2*>(out + (long)row * a.N + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < a.M)
        *reinterpret_cast<float2*>(out + (long)(row + 8) * a.N + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
    // bf16 tile, staged swizzled in this warpgroup's halves of the A boxes
    // of stages 0 .. NB - 1, then stored by TMA
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
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Args);

// The kernel of tile width `bn` (128 or 256), or null.
template <int A_MN, int B_MN, bool F32_OUT>
Kernel kernel_for(int bn) {
  return bn == 128 ? gemm_kernel<128, A_MN, B_MN, F32_OUT>
         : bn == 256 ? gemm_kernel<256, A_MN, B_MN, F32_OUT>
                     : nullptr;
}

// Opt both widths of a kernel in to `bytes` of dynamic shared memory;
// returns 0 or a cudaError_t.
template <int A_MN, int B_MN, bool F32_OUT>
int set_smem(int bytes) {
  for (int bn = 128; bn <= 256; bn *= 2) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)kernel_for<A_MN, B_MN, F32_OUT>(bn),
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != 0) return err;
  }
  return 0;
}

// One launch on `s` over the M x N output (`chunks` chunks of `a.chunk`
// contraction rows): 0 when queued, a cudaError_t, or 2000 for a tile
// width with no kernel.
template <int A_MN, int B_MN, bool F32_OUT>
int launch(const CUtensorMap& amap, const CUtensorMap& bmap,
           const CUtensorMap& cmap, const Args& a, int bn, int chunks,
           int smem_bytes, cudaStream_t s) {
  const Kernel k = kernel_for<A_MN, B_MN, F32_OUT>(bn);
  if (k == nullptr) return 2000;
  const dim3 grid((a.N + bn - 1) / bn, (a.M + BM - 1) / BM, chunks);
  k<<<grid, NT, smem_bytes, s>>>(amap, bmap, cmap, a);
  return (int)cudaGetLastError();
}

// out[i] = the f32 partials of a chunked launch (F32_OUT: `n_chunks`
// slices of n values) summed in chunk order from +0: a fixed order, so
// reruns are bit-equal.  A template only so that a file that never sums
// partials compiles no kernel for it.
template <int = 0>
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long n,
                                 int n_chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += part[(long)c * n + i];
  out[i] = s;
}

// dw_reduce_kernel on `s`: 0 when queued, or a cudaError_t
inline int reduce_chunks(const float* part, float* out, long n, int n_chunks,
                         cudaStream_t s) {
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, n,
                                                               n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace gemm90
