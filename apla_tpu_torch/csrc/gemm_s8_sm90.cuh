// The W8A8 GEMM for Hopper (sm_90a): int8 codes times an int8 weight on
// int8 wgmma, exact int32 sums, scaled in f32 and rounded to the output
// dtype in the epilogue, with an optional bias.  The GEMM half of
// int8_matmul.cu (its quantize pass writes the codes and scales this
// kernel reads).
//
//   xq [M, K] int8, the activations' codes; sx [M, K / G] f32 their scales
//   wk [N, K] int8, the weight K-major; sw [N] f32 its scales
//   y  [M, N] bf16 or f32: for each group g of G consecutive k,
//        acc += ((float)(xq[m, g] . wk[n, g]) * sx[m, g]) * sw[n]
//      in increasing g from +0 (with one group: y = that one product, no
//      sum), each product and sum rounded on its own (__fmul_rn,
//      __fadd_rn: no FMA), then rounded once to y's dtype; with a bias,
//      y = round(round(acc) + round(bias)), the bias rounded to y's dtype
//      first (what `y + bias.to(y.dtype)` computes after the product).
//
// The layout is gemm_sm90.cuh's with 8-bit operands: a producer warp keeps
// a ring of `stages` stages in flight by TMA, two consumer warpgroups (64
// rows each of a 128-row tile) run wgmma.m64nBNk32.s32.s8.s8 on them.
//  * A stage is 128 bytes of K: one 128-byte swizzle row holds 128 int8
//    values, so a box is {128, rows} with CU_TENSOR_MAP_SWIZZLE_128B, both
//    operands K-major (8-bit wgmma reads only that), and a k32 step is a
//    32-byte advance of the descriptor's start, as a bf16 k16 step is
//    (sm90_async.cuh).  TMA fills zeros past M, N and K, so ragged shapes
//    need no padding copies, and the zeros add nothing to an int32 sum.
//  * With one group the first k32 step overwrites the int32 accumulator
//    and the epilogue scales it once.  With G < K each group's first step
//    overwrites it, and its last step is followed by wgmma.wait_group 0 and
//    the f32 scaling into a second accumulator, in increasing group order
//    (BN = 64 then: ptxas gives a block of 288 threads at most 168
//    registers a thread, and 64 + 64 accumulators at BN = 128 spill).
//  * The tile's weight scales and bias go to shared memory once per tile;
//    each thread keeps its two rows' activation scale in registers (one
//    group) or loads the next group's while this one runs.
//  * Epilogue: once both warpgroups are done the ring is free; each stages
//    its 64 x BN tile there, swizzled, in boxes of 64 rows x 128 bytes, and
//    one thread stores them by TMA, which clips rows past M and columns
//    past N.
// Plans (BN, stages, grid, shared memory) come from
// ops/int8_matmul.py:int8_plan.

#pragma once

#include "sm90_async.cuh"

namespace gemm_s8 {

using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                     // rows per block
constexpr int BK = 128;                     // int8 contraction per stage
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int NT = CONSUMERS + 32;          // and the producer warp
constexpr int A_BYTES = BM * BK;            // 16 KB: the codes' box
constexpr int HALF_A = A_BYTES / 2;         // one warpgroup's 64 rows
constexpr int OUT_BOX = 64 * 128;           // an output box: 64 rows x 128 B

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN * BK;
}

// Byte offset of byte `cb` of row `row` in a 128-byte-swizzled box.
__device__ __forceinline__ int swz_bytes(int row, int cb) {
  return row * 128 + ((((cb >> 4) ^ row) & 7) << 4) + (cb & 15);
}

// ((float)part * sx) * sw, each product rounded on its own
__device__ __forceinline__ float scaled(int part, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(part), sx), sw);
}

template <typename T>
struct Out;

template <>
struct Out<bf16> {
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void store2(uint8_t* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Out<float> {
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static void store2(uint8_t* p, float a,
                                                float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// ---- int8 wgmma ----------------------------------------------------------

#define S8_R8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), \
    "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), \
    "+r"(d[i + 7])

// d (64 x N s32) (+)= A (64 x 32 s8) B^T (N x 32 s8), both K-major
// 128-byte-swizzled tiles in shared memory (desc_kmajor); accumulate = 0
// overwrites d.  The sums are exact (no saturation is reached: |d| <=
// 127^2 K).
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  __device__ __forceinline__ static void run(int* d, uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
        " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : S8_R8(0), S8_R8(8), S8_R8(16), S8_R8(24)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ __forceinline__ static void run(int* d, uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
        " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
        " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
        " %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
        " %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : S8_R8(0), S8_R8(8), S8_R8(16), S8_R8(24), S8_R8(32), S8_R8(40),
          S8_R8(48), S8_R8(56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<256> {
  __device__ __forceinline__ static void run(int* d, uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
        " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
        " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
        " %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
        " %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67,"
        " %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78,"
        " %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
        " %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100,"
        " %101, %102, %103, %104, %105, %106, %107, %108, %109,"
        " %110, %111, %112, %113, %114, %115, %116, %117, %118,"
        " %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : S8_R8(0), S8_R8(8), S8_R8(16), S8_R8(24), S8_R8(32), S8_R8(40),
          S8_R8(48), S8_R8(56), S8_R8(64), S8_R8(72), S8_R8(80), S8_R8(88),
          S8_R8(96), S8_R8(104), S8_R8(112), S8_R8(120)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

#undef S8_R8

// Wait until the grid this one depends on (a programmatic dependent
// launch: the quantize pass) has ended and its writes are visible; a no-op
// for a plain launch.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Order later reads of the accumulator after the wgmma.wait_group before
// them (the wait has no register operands the compiler could see).
template <int N>
__device__ __forceinline__ void settle(int (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+r"(d[e])::"memory");
}

struct Args {
  const float* sx;     // [M, K / G]
  const float* sw;     // [N]
  const void* bias;    // [N] f32 or bf16, or null
  int bias_bf16;
  int M, N, K, G;
  int stages;
};

// amap: the codes [M, K] as {K, M, 1}, boxes {128, 128, 1}; bmap: the
// weight [N, K] as {K, N, 1}, boxes {128, BN, 1}; cmap: y [M, N] as
// {N, M, 1}, boxes {128 / sizeof(OutT), 64, 1}; all with the 128-byte
// swizzle.  Blocks: x over the column tiles of BN (fastest, so the blocks
// in flight share their rows of codes in L2), y over the row tiles.  Two
// blocks share an SM at BN = 128 with one group, and with groups in bf16
// (in f32, ptxas spills at the registers two blocks leave).  Launched as a
// programmatic dependent of the quantize pass: it reads nothing that pass
// writes before griddepcontrol.wait.
template <int BN, typename OutT, bool ONE_GROUP>
__global__ void __launch_bounds__(
    NT, (ONE_GROUP ? BN == 128 : sizeof(OutT) == 2) ? 2 : 1)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap, const Args a) {
  static_assert(ONE_GROUP ? BN == 128 || BN == 256 : BN == 64,
                "one group: BN = 128 or 256; groups: BN = 64");
  constexpr int STAGE = stage_bytes<BN>();
  constexpr int KSTEPS = BK / 32;           // k32 steps per stage
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  const int stages = a.stages;
  float* s_sw = reinterpret_cast<float*>(sm + stages * STAGE);
  float* s_bias = s_sw + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_bias + BN);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (a.K + BK - 1) / BK;

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
      grid_dependency_wait();               // the codes are written
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty + s, (i / stages - 1) & 1);
        uint8_t* st = sm + s * STAGE;
        mbar_expect_tx(full + s, STAGE);
        tma_load_3d(st, &amap, full + s, i * BK, m0, 0);
        tma_load_3d(st + A_BYTES, &bmap, full + s, i * BK, n0, 0);
      }
    }
    return;
  }

  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;            // rows row, row + 8 of the
  const int grow = m0 + 64 * wg + row;      // warpgroup's 64; in y
  // the tile's weight scales and bias (rounded to y's dtype), 0 past N
  if (tid < BN) {
    const int c = n0 + tid;
    float b = 0.f;
    if (a.bias != nullptr && c < a.N)
      b = a.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(a.bias)[c])
                      : static_cast<const float*>(a.bias)[c];
    s_sw[tid] = c < a.N ? a.sw[c] : 0.f;
    s_bias[tid] = Out<OutT>::round(b);
  }
  named_sync(1, CONSUMERS);
  grid_dependency_wait();                   // the scales are written

  int part[BN / 2];
  float acc[ONE_GROUP ? 1 : BN / 2];
  float sx0, sx1;                           // this thread's rows' scales
  if constexpr (ONE_GROUP) {
    sx0 = grow < a.M ? a.sx[grow] : 0.f;
    sx1 = grow + 8 < a.M ? a.sx[grow + 8] : 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(full + s, (i / stages) & 1);
      const uint8_t* st = sm + s * STAGE;
      const uint64_t da = desc_kmajor(st + wg * HALF_A);
      const uint64_t db = desc_kmajor(st + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        WgmmaS8<BN>::run(part, da + 2 * kk, db + 2 * kk, i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait1();                        // stage i - 1's wgmmas retired
      if (i > 0 && wtid == 0) mbar_arrive(empty + (i - 1) % stages);
    }
    wgmma_wait0();
    settle(part);
  } else {
    const int ng = a.K / a.G, gsteps = a.G / 32, ksteps = a.K / 32;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    int grp = 0, in_grp = 0;
    sx0 = grow < a.M ? a.sx[(long)grow * ng] : 0.f;
    sx1 = grow + 8 < a.M ? a.sx[(long)(grow + 8) * ng] : 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(full + s, (i / stages) & 1);
      const uint8_t* st = sm + s * STAGE;
      const uint64_t da = desc_kmajor(st + wg * HALF_A);
      const uint64_t db = desc_kmajor(st + A_BYTES);
      wgmma_fence();
#pragma unroll 1
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if (i * KSTEPS + kk >= ksteps) break;
        WgmmaS8<BN>::run(part, da + 2 * kk, db + 2 * kk, in_grp);
        if (++in_grp == gsteps) {           // the group's last step
          wgmma_commit();
          wgmma_wait0();
          settle(part);
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 w = *reinterpret_cast<const float2*>(
                s_sw + 8 * j + 2 * t);
            acc[4 * j] = __fadd_rn(acc[4 * j],
                                   scaled(part[4 * j], sx0, w.x));
            acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1],
                                       scaled(part[4 * j + 1], sx0, w.y));
            acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2],
                                       scaled(part[4 * j + 2], sx1, w.x));
            acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3],
                                       scaled(part[4 * j + 3], sx1, w.y));
          }
          in_grp = 0;
          if (++grp < ng) {
            sx0 = grow < a.M ? a.sx[(long)grow * ng + grp] : 0.f;
            sx1 = grow + 8 < a.M ? a.sx[(long)(grow + 8) * ng + grp] : 0.f;
          }
          wgmma_fence();
        }
      }
      wgmma_commit();
      wgmma_wait1();
      if (i > 0 && wtid == 0) mbar_arrive(empty + (i - 1) % stages);
    }
    wgmma_wait0();
  }

  // every load has landed and both warpgroups' wgmmas have retired: the
  // ring is free for the output tile
  named_sync(2, CONSUMERS);
  constexpr int ES = sizeof(OutT), BOX_COLS = 128 / ES, NBOX = BN / BOX_COLS;
  uint8_t* out = sm + wg * NBOX * OUT_BOX;
  const bool with_bias = a.bias != nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    float v[4];
    if constexpr (ONE_GROUP) {
      const float2 w = *reinterpret_cast<const float2*>(s_sw + col);
      v[0] = scaled(part[4 * j], sx0, w.x);
      v[1] = scaled(part[4 * j + 1], sx0, w.y);
      v[2] = scaled(part[4 * j + 2], sx1, w.x);
      v[3] = scaled(part[4 * j + 3], sx1, w.y);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[4 * j + e];
    }
    if (with_bias) {
      const float2 b = *reinterpret_cast<const float2*>(s_bias + col);
      v[0] = __fadd_rn(Out<OutT>::round(v[0]), b.x);
      v[1] = __fadd_rn(Out<OutT>::round(v[1]), b.y);
      v[2] = __fadd_rn(Out<OutT>::round(v[2]), b.x);
      v[3] = __fadd_rn(Out<OutT>::round(v[3]), b.y);
    }
    uint8_t* box = out + (col / BOX_COLS) * OUT_BOX;
    const int cb = (col % BOX_COLS) * ES;
    Out<OutT>::store2(box + swz_bytes(row, cb), v[0], v[1]);
    Out<OutT>::store2(box + swz_bytes(row + 8, cb), v[2], v[3]);
  }
  fence_proxy_async();
  named_sync(3 + wg, 128);
  if (wtid == 0 && m0 + 64 * wg < a.M) {
#pragma unroll
    for (int b = 0; b < NBOX; ++b)
      if (n0 + b * BOX_COLS < a.N)
        tma_store_3d(&cmap, out + b * OUT_BOX, n0 + b * BOX_COLS,
                     m0 + 64 * wg, 0);
    tma_store_commit();
    tma_store_wait_all();
  }
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Args);

// The kernel of tile width `bn` (128 or 256 with one group, 64 with
// groups), or null.
template <typename OutT>
Kernel kernel_for(int bn, bool one_group) {
  if (one_group)
    return bn == 128 ? w8a8_gemm_kernel<128, OutT, true>
           : bn == 256 ? w8a8_gemm_kernel<256, OutT, true>
                       : nullptr;
  return bn == 64 ? w8a8_gemm_kernel<64, OutT, false> : nullptr;
}

// Opt every instantiation in to `bytes` of dynamic shared memory; returns
// 0 or a cudaError_t.
inline int set_smem(int bytes) {
  const Kernel all[] = {kernel_for<bf16>(128, true),
                        kernel_for<bf16>(256, true),
                        kernel_for<bf16>(64, false),
                        kernel_for<float>(128, true),
                        kernel_for<float>(256, true),
                        kernel_for<float>(64, false)};
  for (Kernel k : all) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace gemm_s8
