// W8A8 GEMM for Hopper (sm_90a): x [M, K] float times an int8 weight with
// per-output-channel scales, the activations quantized on the fly.
//
// Replaces the TPU kernel apla_tpu/ops/pallas_int8_matmul.py:_kernel
// (called through fused_int8_matmul) and, with one group spanning all of K,
// the XLA dot_general of apla_tpu/ops/quant.py:_int8_forward, the W8A8
// serving path's frozen qkv / fc1 / fc2 products.  Contract:
//
//   x   [M, K] bf16 or f32, any M (the ragged edge is masked here)
//   wk  [N, K] int8, the weight K-major (w_i8 [K, N] transposed once, when
//       the weight is quantized or loaded: the 8-bit mma's B operand is read
//       K-major, and ldmatrix has no 8-bit transpose)
//   sw  [N] f32 per-output-channel weight scales
//   y   [M, N] in x's dtype; for each group g of G consecutive k:
//       sx[m, g] = max(max_k |x[m, k]| / 127, 1e-12)          (f32)
//       q[m, k]  = clamp(rint(x[m, k] / sx[m, g]), -127, 127)  (half to even)
//       acc     += ((float)(q[m, g-block] . wk[n, g-block]) * sx[m, g])
//                  * sw[n]                                      (f32)
//       y = acc rounded once to x's dtype.
//
// Every step rounds as the JAX functions do: the division is IEEE f32 (no
// reciprocal), rint is half-to-even like jnp.round, the int32 dot is exact,
// and the two scale products and the sum are issued as __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into an FMA.  At G = K the
// result is quant.int8_matmul's forward bit for bit.
//
// What bounds it on the H100: at the classifier's b64 (M = 16448, K = 768)
// the fc1 product (N = 3072) is 77.6 G int8 operations, 0.039 ms at the
// card's 1,979 TOPS, against 129 MB of bf16 in and out (0.038 ms at 3.35
// TB/s); qkv (N = 2304) is bound by its bytes.  The quantize pass adds one
// read of x and a write and read of its int8 codes (1.5 bytes per element
// of x) that a prologue fused into the GEMM would save.
//
// Design (right first; wgmma/TMA are later work):
//  * quantize pass: one warp per (row, group), four elements a lane per
//    step: the group's amax by a warp shuffle, then the codes (int8 [M, K])
//    and the scale (f32 [M, K / G]) to scratch the caller allocates.
//  * GEMM: 128 x 128 output tiles, 8 warps of 64 x 32, k in steps of 32
//    bytes (one mma.sync.m16n8k32 s8 per 16 x 8 sub-tile), operand tiles
//    brought by cp.async through a 4-stage ring with zero-filled rows past
//    M and N, read by ldmatrix (rows of 32 bytes, the two 16-byte halves
//    swapped on every other group of four rows so an 8-row read meets no
//    bank twice).  The int32 partial of a group is scaled into the f32
//    accumulator when the group's last k-step is done; with one group the
//    accumulator is skipped and the epilogue scales the int32 sum.
//  * K must be a multiple of 32, G a multiple of 32 dividing K, N a
//    multiple of 8; the wrapper checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int QT = 256;              // quantize pass: 8 warps a block
constexpr int GT = 256;              // GEMM: 8 warps as 2 (m) x 4 (n)
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

template <typename T>
__global__ void __launch_bounds__(QT)
w8a8_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, long items, int K, int G) {
  const long item = (long)blockIdx.x * (QT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (item >= items) return;
  const int ng = K / G;
  const long off = (item / ng) * (long)K + (long)(item % ng) * G;
  float amax = 0.f;
  for (int i = 4 * lane; i < G; i += 128) {
    float v[4];
    load4(x + off + i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  for (int i = 4 * lane; i < G; i += 128) {
    float v[4];
    load4(x + off + i, v);
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.f),
                            127.f);
      packed |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(q) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(xq + off + i) = packed;
  }
  if (lane == 0) sx[item] = scale;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte half `c` of row `r` in a [rows][32] int8 tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 2) & 1)) << 4);
}

// 16-byte async copy; valid = false writes zeros (rows past M or N)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const int8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), exact s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ((float)part * sx) * sw, each product rounded on its own
__device__ __forceinline__ float scaled(int part, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(part), sx), sw);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT, bool ONE_GROUP>
__global__ void __launch_bounds__(GT)
w8a8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wk,
                const float* __restrict__ sx, const float* __restrict__ sw,
                OutT* __restrict__ y, int M, int N, int K, int G) {
  __shared__ __align__(128) int8_t sa[STAGES][BM * BK];
  __shared__ __align__(128) int8_t sb[STAGES][BN * BK];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ng = K / G, steps = K / BK, gsteps = G / BK;

  // each thread copies one 16-byte half-row of the A and of the B tile
  const int lr = tid >> 1, lc = tid & 1;
  const bool a_ok = m0 + lr < M, b_ok = n0 + lr < N;
  const int8_t* a_src = xq + (long)(a_ok ? m0 + lr : 0) * K + lc * 16;
  const int8_t* b_src = wk + (long)(b_ok ? n0 + lr : 0) * K + lc * 16;
  const int l_off = swz(lr, lc);
  auto issue = [&](int s) {
    if (s < steps) {
      cp_async16(&sa[s % STAGES][l_off], a_src + s * BK, a_ok);
      cp_async16(&sb[s % STAGES][l_off], b_src + s * BK, b_ok);
    }
    cp_async_commit();               // an empty group past the end
  };

  // ldmatrix row addresses: A, matrix lane / 8 = (rows +8, half) as a0..a3;
  // B, matrix lane / 8 = (half, n-tile +1) as b[j][0], b[j][1], b[j+1][..]
  const int a_row = wm * 64 + (lane & 15), a_half = lane >> 4;
  const int b_row = wn * 32 + ((lane >> 4) << 3) + (lane & 7);
  const int b_half = (lane >> 3) & 1;

  int part[4][4][4];
  float acc[ONE_GROUP ? 1 : 4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[i][j][e] = 0;
        if (!ONE_GROUP) acc[ONE_GROUP ? 0 : i][j][e] = 0.f;
      }

  // the weight scales of this thread's 8 columns (0 past N)
  float sw_c[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + wn * 32 + j * 8 + 2 * t;
    sw_c[j][0] = c < N ? sw[c] : 0.f;
    sw_c[j][1] = c + 1 < N ? sw[c + 1] : 0.f;
  }
  // rows of this thread: i-th m16 tile, +0 / +8
  auto row_of = [&](int i, int h) { return m0 + wm * 64 + i * 16 + g + 8 * h; };
  auto sx_of = [&](int i, int h, int grp) {
    const int r = row_of(i, h);
    return r < M ? sx[(long)r * ng + grp] : 0.f;
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(s + STAGES - 1);
    const int8_t* ta = sa[s % STAGES];
    const int8_t* tb = sb[s % STAGES];
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldsm_x4(a[i][0], a[i][1], a[i][2], a[i][3],
              ta + swz(a_row + i * 16, a_half));
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      ldsm_x4(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1],
              tb + swz(b_row + j * 8, b_half));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(part[i][j], a[i], b[j][0], b[j][1]);

    if (!ONE_GROUP && (s + 1) % gsteps == 0) {
      const int grp = (s + 1) / gsteps - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s0 = sx_of(i, 0, grp), s1 = sx_of(i, 1, grp);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float (&d)[4] = acc[ONE_GROUP ? 0 : i][j];
          d[0] = __fadd_rn(d[0], scaled(part[i][j][0], s0, sw_c[j][0]));
          d[1] = __fadd_rn(d[1], scaled(part[i][j][1], s0, sw_c[j][1]));
          d[2] = __fadd_rn(d[2], scaled(part[i][j][2], s1, sw_c[j][0]));
          d[3] = __fadd_rn(d[3], scaled(part[i][j][3], s1, sw_c[j][1]));
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0;
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s0 = 0.f, s1 = 0.f;
    if (ONE_GROUP) { s0 = sx_of(i, 0, 0); s1 = sx_of(i, 1, 0); }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + wn * 32 + j * 8 + 2 * t;
      if (c >= N) continue;          // N % 8 == 0: c + 1 < N as well
      float v[4];
      if (ONE_GROUP) {
        v[0] = scaled(part[i][j][0], s0, sw_c[j][0]);
        v[1] = scaled(part[i][j][1], s0, sw_c[j][1]);
        v[2] = scaled(part[i][j][2], s1, sw_c[j][0]);
        v[3] = scaled(part[i][j][3], s1, sw_c[j][1]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[ONE_GROUP ? 0 : i][j][e];
      }
      const int r0 = row_of(i, 0), r1 = row_of(i, 1);
      if (r0 < M) store2(y + (long)r0 * N + c, v[0], v[1]);
      if (r1 < M) store2(y + (long)r1 * N + c, v[2], v[3]);
    }
  }
}

template <typename T, bool ONE_GROUP>
void launch(const void* x, const void* wk, const void* sw, void* xq, void* sx,
            void* y, int M, int N, int K, int G, cudaStream_t stream) {
  const long items = (long)M * (K / G);
  w8a8_quantize_kernel<T><<<(unsigned)((items + QT / 32 - 1) / (QT / 32)),
                            QT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), items, K, G);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  w8a8_mma_kernel<T, ONE_GROUP><<<grid, GT, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wk),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<T*>(y), M, N, K, G);
}

}  // namespace

extern "C" {

// Launch the quantize pass and the GEMM on `stream`; returns the
// cudaError_t of the launches (0 = queued).  `xq` [M, K] int8 and `sx`
// [M, K / G] f32 are scratch.  The caller checks shapes (M >= 1, K % 32,
// G % 32, K % G, N % 8, M / 128 and N / 128 within the grid), dtypes and
// 16-byte aligned contiguous tensors.
int int8_matmul(const void* x, int x_is_bf16, const void* wk, const void* sw,
                void* xq, void* sx, void* y, int M, int N, int K, int G,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool one = G == K;
  if (x_is_bf16) {
    if (one) launch<bf16, true>(x, wk, sw, xq, sx, y, M, N, K, G, st);
    else launch<bf16, false>(x, wk, sw, xq, sx, y, M, N, K, G, st);
  } else {
    if (one) launch<float, true>(x, wk, sw, xq, sx, y, M, N, K, G, st);
    else launch<float, false>(x, wk, sw, xq, sx, y, M, N, K, G, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
