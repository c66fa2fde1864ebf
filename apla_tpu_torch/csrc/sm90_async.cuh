// Hopper (sm_90a) asynchronous building blocks: mbarriers, TMA tile loads
// and stores through a tensor map, and warpgroup MMA (wgmma) on bf16 tiles
// stored with the 128-byte swizzle.
//
// Tile convention: a tile is R rows of 64 bf16 (128 bytes each), as TMA
// writes a box {64, R} with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c
// of row r sits at chunk c ^ (r % 8), and the tile starts on a 1024-byte
// boundary (the swizzle is a function of the address).  Such a tile is
//  * K-major (rows = M or N, the 64 columns = the contraction) for the A
//    and B operands of q k^T: a k16 step is a 32-byte advance of the start
//    address; 8-row groups are 1024 bytes apart (SBO);
//  * MN-major (rows = the contraction, columns = N) for the B operand of
//    p v: a k16 step is 16 rows (2048 bytes); 8-row groups are 1024 bytes
//    apart, and with N = 64 one swizzle row spans all of N.  A wider
//    MN-major B (the GEMMs' of gemm_sm90.cuh) is N / 64 such tiles side by
//    side, the descriptor's leading byte offset apart.  The same tile read
//    as the A operand of a product whose rows are its columns (o^T g in
//    the APLA dW) is an MN-major A.
//
// wgmma accumulator layout (m64nN, f32): warp w of the warpgroup holds rows
// 16w + g and 16w + g + 8 (lane = 4g + t); d[4j + e] is row 16w + g, column
// 8j + 2t + e for e < 2, and row 16w + g + 8, column 8j + 2t + e - 2 for
// e >= 2, the layout of mma.sync m16n8 fragments laid side by side.  The
// register A operand of m64nNk16 has the mma.sync m16n8k16 A layout, so the
// accumulator of a product, rounded and packed in pairs, is the A operand
// of the next one (`acc_to_a`).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dynamic shared memory `raw` rounded up to 1 KB (the 128-byte
// swizzle's atom).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make initialised barriers visible to the other threads and to the async
// proxy (TMA); follow with __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One plain arrival (no transaction bytes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// Copy the box at coordinates (c0, c1, c2) of a 3-D tensor map into shared
// memory; completion is counted on `bar` (bytes of the whole box, the
// zero-filled part past the tensor's edge included).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Bring a tensor map (a kernel parameter's address) into the cache that
// TMA reads it from, ahead of its first load.
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"((uint64_t)map)
               : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global memory into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)src), "r"(bytes),
         "r"(smem_addr(bar))
      : "memory");
}

// Store a shared-memory box to (c0, c1, c2); elements past the tensor's
// edge are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"((uint64_t)map), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until the committed stores are complete.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `count` threads (a warpgroup: 128).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Byte offset of element (row, col) of a 128-byte-swizzled tile of 64 bf16
// columns.
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// The same for a 64-byte-swizzled tile of 32 bf16 columns (a box {32, R}
// with CU_TENSOR_MAP_SWIZZLE_64B: chunk c of row r sits at c ^ ((r / 2) % 4),
// the tile on a 512-byte boundary), the head-dim-32 tiles of the Swin
// window attention.
__device__ __forceinline__ uint32_t swz64(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row >> 1)) & 3) << 4) + ((col & 7) << 1);
}

// The max and the sum over the quad of threads that share a row of a
// wgmma (or mma.sync) accumulator (lanes 4g .. 4g + 3), each lane's own
// value first.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at `p`
// (1024-byte aligned but for a k-step offset); `lbo`/`sbo` in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major tile (rows of 64 along the contraction)
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return desc_sw128(p, 16, 1024);
}

// MN-major tile (rows along the contraction, 64 columns of N): 8-row groups
// 1024 bytes apart; with N = 64 the other stride is never used, and it is
// given the same value.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p) {
  return desc_sw128(p, 1024, 1024);
}

// The 64-byte swizzle's tiles (rows of 32 bf16, swz64): K-major, a k16 step
// is a 32-byte advance and 8-row groups are 512 bytes apart; MN-major with
// N = 32 (one swizzle row spans all of N), a k16 step is 16 rows (1024
// bytes) and 8-row groups are 512 bytes apart.
__device__ __forceinline__ uint64_t desc_sw64(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (desc_sw128(p, lbo, sbo) & ~(3ull << 62)) | (2ull << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor64(const void* p) {
  return desc_sw64(p, 16, 512);
}

__device__ __forceinline__ uint64_t desc_mnmajor64(const void* p) {
  return desc_sw64(p, 512, 512);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most one committed group is still running.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

#define SM90_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// d (64 x N f32) (+)= A (64 x 16, K-major tile) B^T (N x 16, K-major tile),
// both bf16 from shared memory; accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : SM90_R8(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SM90_R8(0), SM90_R8(8)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1,"
      " 0, 0;\n}\n"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N f32) (+)= A (64 x 16) B (16 x N), both bf16 from shared memory;
// accumulate = 0 overwrites d.  TA = 0: A K-major (desc_kmajor), 1: A
// MN-major, one 64-column tile (desc_mnmajor).  TB = 0: B K-major (N rows
// of 64 along the contraction, desc_kmajor); 1: B MN-major, N / 64 tiles
// of 64 columns side by side, the descriptor's leading byte offset apart.
// A k16 step is +32 bytes of a K-major tile, +16 rows of an MN-major one.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float* d, uint64_t a, uint64_t b,
                                           int accumulate);

template <int TA, int TB>
struct WgmmaT128 {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        " %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24), SM90_R8(32),
          SM90_R8(40), SM90_R8(48), SM90_R8(56)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaT256 {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
        " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
        " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
        " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
        " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24), SM90_R8(32),
          SM90_R8(40), SM90_R8(48), SM90_R8(56), SM90_R8(64), SM90_R8(72),
          SM90_R8(80), SM90_R8(88), SM90_R8(96), SM90_R8(104),
          SM90_R8(112), SM90_R8(120)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaT32 {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"
        " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        " %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : SM90_R8(0), SM90_R8(8)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float* d, uint64_t a, uint64_t b,
                                           int accumulate) {
  static_assert(N == 32 || N == 128 || N == 256,
                "wgmma_ss_t: N of 32, 128 or 256");
  if constexpr (N == 32)
    WgmmaT32<TA, TB>::run(d, a, b, accumulate);
  else if constexpr (N == 128)
    WgmmaT128<TA, TB>::run(d, a, b, accumulate);
  else
    WgmmaT256<TA, TB>::run(d, a, b, accumulate);
}

// d (64 x 64 f32) += A (64 x 16 bf16 from registers, a[4]) B (16 x 64,
// MN-major tile in shared memory).
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, 1, 1;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 32 f32) (+)= A (64 x 16 bf16 from registers, a[4]) B (16 x 32,
// MN-major 64-byte-swizzled tile in shared memory); accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_rs32(float* d, const uint32_t (&a)[4],
                                           uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : SM90_R8(0), SM90_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 256 f32) (+)= A (64 x 16 bf16 from registers, a[4]) B (16 x
// 256 in shared memory); accumulate = 0 overwrites d.  TB = 0: B K-major
// (256 rows along N), 1: MN-major (four tiles of 64 columns side by side,
// the descriptor's leading byte offset apart).
template <int TB>
__device__ __forceinline__ void wgmma_rs256(float* d, const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24), SM90_R8(32),
        SM90_R8(40), SM90_R8(48), SM90_R8(56), SM90_R8(64), SM90_R8(72),
        SM90_R8(80), SM90_R8(88), SM90_R8(96), SM90_R8(104),
        SM90_R8(112), SM90_R8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate), "n"(TB));
}

#undef SM90_R8

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The k16 step kk (accumulator columns 16kk .. 16kk + 15) of an f32
// accumulator, rounded to bf16, as the register A operand of a wgmma.
__device__ __forceinline__ void acc_to_a(const float* d, int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---- tensor maps (host) --------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library needs no -lcuda); null if the driver has none.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a row-major tensor [d2][d1][d0] of `dtype` (d0 innermost,
// row_bytes and plane_bytes its strides), boxes of {box0, box_rows, 1} with
// the 128-byte swizzle (box0 elements span at most 128 bytes; or `swizzle`,
// whose span bounds them); reads past an edge fill zeros.  Returns 0 or a
// CUresult.
inline int encode_3d(CUtensorMap* map, CUtensorMapDataType dtype,
                     const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint64_t row_bytes, uint64_t plane_bytes, uint32_t box0,
                     uint32_t box_rows,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {box0, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return (int)fn(map, dtype, 3, const_cast<void*>(base), dims, strides, box,
                 estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The same over bf16 with boxes 64 elements (128 bytes) wide.
inline int encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0,
                          uint64_t d1, uint64_t d2, uint64_t row_bytes,
                          uint64_t plane_bytes, uint32_t box_rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, d0, d1, d2,
                   row_bytes, plane_bytes, 64, box_rows);
}

}  // namespace sm90
