// W8A8 GEMM for Hopper (sm_90a): x [M, K] float times an int8 weight with
// per-output-channel scales, the activations quantized on the fly, and an
// optional bias added in the epilogue.
//
// Replaces the TPU kernel apla_tpu/ops/pallas_int8_matmul.py:_kernel
// (called through fused_int8_matmul) and, with one group spanning all of K,
// the XLA dot_general of apla_tpu/ops/quant.py:_int8_forward, the W8A8
// serving path's frozen qkv / fc1 / fc2 products, with the bias add that
// maybe_quantized_dot makes after them.  Contract:
//
//   x    [M, K] bf16 or f32, any M
//   wk   [N, K] int8, the weight K-major (w_i8 [K, N] transposed once, when
//        the weight is quantized or loaded: 8-bit wgmma reads both
//        operands K-major)
//   sw   [N] f32 per-output-channel weight scales
//   bias [N] f32 or bf16, or none
//   y    [M, N] in x's dtype; for each group g of G consecutive k:
//        sx[m, g] = max(max_k |x[m, k]| / 127, 1e-12)          (f32)
//        q[m, k]  = clamp(rint(x[m, k] / sx[m, g]), -127, 127)  (half to even)
//        acc     += ((float)(q[m, g-block] . wk[n, g-block]) * sx[m, g])
//                   * sw[n]                                      (f32)
//        y = acc rounded once to x's dtype; with a bias,
//        y = round(float(y) + float(round(bias))), the bias rounded to x's
//        dtype first.
//
// Every step rounds as the JAX functions do: the division is IEEE f32 (no
// reciprocal), rint is half-to-even like jnp.round, the int32 dot is exact,
// and the two scale products and the sum are issued as __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into an FMA.  At G = K the
// result is quant.int8_matmul's forward bit for bit, and with the bias
// maybe_quantized_dot's.
//
// What bounds it on the H100: at the classifier's b64 (M = 16448, K = 768)
// the fc1 product (N = 3072) is 77.6 G int8 operations, 0.039 ms at the
// card's 1,979 TOPS, against 129 MB of bf16 in and out (0.038 ms at 3.35
// TB/s); qkv (N = 2304) is bound by its bytes.  The quantize pass adds a
// write of the int8 codes and their read (1 + 1 bytes per element of x,
// the read mostly from L2), about a quarter of the bytes.
//
// Design:
//  * quantize pass: a team of up to 32 threads per (row, group), each
//    holding up to 32 16-byte vectors of x, so that x is read once: the
//    group's amax (shuffles within the team), then the codes (int8 [M, K])
//    and the scale (f32 [M, K / G]) from the registers, to scratch the
//    caller allocates.  A grid the SMs hold at once, each warp walking
//    over items a grid apart; at up to 8 vectors a thread it loads its
//    next item while it divides this one's values.  The rint and the
//    conversion to int8 are one exact add (code()).  Folding the quantize
//    into the GEMM's operand path instead would divide every element once
//    per column tile (N / BN times), and the division already bounds the
//    pass with the bytes.
//  * GEMM: gemm_s8_sm90.cuh, int8 wgmma on TMA tiles of the codes and the
//    weight, the scales and the bias in the epilogue, y stored by TMA;
//    launched as a programmatic dependent of the quantize pass, so that
//    its blocks start while the pass ends.
//  * K and G multiples of 32, G dividing K, N a multiple of 8; the wrapper
//    checks.

#include "gemm_s8_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int QT = 256;              // quantize pass: threads a block

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(p);
    v[2 * i + 1] = __high2float(p);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}

// The code of v, clamp(rint(v / scale), -127, 127), in the low byte of the
// result.  Clamping before the rounding gives the same integer (the bounds
// are integers; NaN goes to -127 either way), and adding 1.5 * 2^23 rounds
// a float of magnitude below 2^22 half to even into the low bits of the
// mantissa: the rint and the conversion to an integer in one full-rate add
// instead of two instructions of the quarter-rate conversion pipe, which
// with the division's reciprocal would otherwise bound the pass.
__device__ __forceinline__ uint32_t code(float v, float scale) {
  const float q = fminf(fmaxf(__fdiv_rn(v, scale), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

// The low bytes of a, b, c, d as one word, a's lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <int E>
__device__ __forceinline__ void store_codes(int8_t* p, const float (&v)[E],
                                            float scale);

template <>
__device__ __forceinline__ void store_codes<8>(int8_t* p, const float (&v)[8],
                                               float scale) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      pack4(code(v[0], scale), code(v[1], scale), code(v[2], scale),
            code(v[3], scale)),
      pack4(code(v[4], scale), code(v[5], scale), code(v[6], scale),
            code(v[7], scale)));
}

template <>
__device__ __forceinline__ void store_codes<4>(int8_t* p, const float (&v)[4],
                                               float scale) {
  *reinterpret_cast<uint32_t*>(p) = pack4(code(v[0], scale),
                                          code(v[1], scale),
                                          code(v[2], scale),
                                          code(v[3], scale));
}

// One (row, group) item per team of `team` threads (a power of two up to
// 32), each holding up to QV 16-byte vectors of the group: vector j is
// thread j % team's (j / team)-th.  The items of a row are contiguous in
// x, so a warp's 32 / team items are one run of memory.  The grid is
// what the SMs hold at once; each warp walks over items a grid apart, and
// with PREFETCH issues the next item's loads before this one's
// arithmetic (the division per element costs about as long as the bytes
// take to arrive).
template <typename T, int QV, bool PREFETCH>
__global__ void __launch_bounds__(QT, 1)
w8a8_quantize_kernel(const void* __restrict__ xv, int8_t* __restrict__ xq,
                     float* __restrict__ sx, long items, int G, int team) {
  constexpr int EPV = 16 / sizeof(T);        // elements per vector
  const T* x = static_cast<const T*>(xv);
  const int nvec = G / EPV, lane = threadIdx.x % 32, tt = lane % team;
  const int per_warp = 32 / team;
  const long warps = (long)gridDim.x * (QT / 32);
  long first = ((long)blockIdx.x * QT + threadIdx.x) / 32 * per_warp;
  const long stride = warps * per_warp;
  uint4 u[QV], nxt[PREFETCH ? QV : 1];
  auto load = [&](long item, uint4 (&buf)[QV]) {
    const uint4* src = reinterpret_cast<const uint4*>(x + item * G);
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      const int j = q * team + tt;
      if (item < items && j < nvec) buf[q] = __ldg(src + j);
    }
  };
  // the GEMM may start its blocks (they wait for this grid's end before
  // they read what it writes) as soon as these leave room for them
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if constexpr (PREFETCH) load(first + lane / team, u);
  for (; first < items; first += stride) {   // uniform over the warp
    const long item = first + lane / team;
    if constexpr (PREFETCH)
      load(item + stride, nxt);
    else
      load(item, u);
    const bool live = item < items;
    float amax = 0.f;
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      if (live && q * team + tt < nvec) {
        float v[EPV];
        unpack(u[q], v);
#pragma unroll
        for (int e = 0; e < EPV; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
    }
    for (int s = team / 2; s > 0; s >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
    const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      const int j = q * team + tt;
      if (live && j < nvec) {
        float v[EPV];
        unpack(u[q], v);
        store_codes<EPV>(xq + item * G + (long)j * EPV, v, scale);
      }
    }
    if (live && tt == 0) sx[item] = scale;
    if constexpr (PREFETCH) {
#pragma unroll
      for (int q = 0; q < QV; ++q) u[q] = nxt[q];
    }
  }
}

typedef void (*QuantizeKernel)(const void*, int8_t*, float*, long, int,
                               int);

// The kernel of `qv` vectors a thread (4 and 8 with the prefetch; 16 and
// 32 without, for the registers: with it, 16 ran slower on the H100), or
// null.
template <typename T>
QuantizeKernel quantize_kernel_for(int qv) {
  return qv == 4 ? w8a8_quantize_kernel<T, 4, true>
         : qv == 8 ? w8a8_quantize_kernel<T, 8, true>
         : qv == 16 ? w8a8_quantize_kernel<T, 16, false>
         : qv == 32 ? w8a8_quantize_kernel<T, 32, false>
                    : nullptr;
}

// The quantize pass over x [M, K] in groups of G with `team` threads, `qv`
// vectors a thread and `blocks` blocks (ops/int8_matmul.py:int8_plan's).
template <typename T>
int quantize(const void* x, void* xq, void* sx, int M, int K, int G,
             int team, int qv, int blocks, cudaStream_t stream) {
  const QuantizeKernel k = quantize_kernel_for<T>(qv);
  if (k == nullptr || team < 1 || team > 32 || 32 % team || blocks < 1
      || (long)team * qv * 16 < (long)G * (long)sizeof(T))
    return 2001;
  const long items = (long)M * (K / G);
  k<<<(unsigned)blocks, QT, 0, stream>>>(x, static_cast<int8_t*>(xq),
                                         static_cast<float*>(sx), items, G,
                                         team);
  return (int)cudaGetLastError();
}

template <typename OutT>
int gemm(const void* xq, const void* wk, void* y, const gemm_s8::Args& a,
         int bn, int smem_bytes, cudaStream_t stream) {
  const gemm_s8::Kernel k = gemm_s8::kernel_for<OutT>(bn, a.G == a.K);
  if (k == nullptr) return 2000;
  CUtensorMap amap, bmap, cmap;
  constexpr int ES = sizeof(OutT);
  const uint64_t yrow = (uint64_t)a.N * ES;
  int err = sm90::encode_3d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, a.K,
                            a.M, 1, a.K, (uint64_t)a.K * a.M, gemm_s8::BK,
                            gemm_s8::BM);
  if (err == 0)
    err = sm90::encode_3d(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wk, a.K, a.N,
                          1, a.K, (uint64_t)a.K * a.N, gemm_s8::BK, bn);
  if (err == 0)
    err = sm90::encode_3d(&cmap,
                          ES == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          y, a.N, a.M, 1, yrow, yrow * a.M, 128 / ES, 64);
  if (err != 0) return 1000 + err;
  // a programmatic dependent launch: the blocks start while the quantize
  // pass ends, and wait for it (griddepcontrol.wait) before they read the
  // codes and scales
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + bn - 1) / bn,
                     (a.M + gemm_s8::BM - 1) / gemm_s8::BM);
  cfg.blockDim = dim3(gemm_s8::NT);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, k, amap, bmap, cmap, a);
}

}  // namespace

extern "C" {

// Opt the GEMM's kernels in to the device's per-block shared memory limit
// on the current device, `device`, and write to `resident` [8] the blocks
// of each quantize kernel that all its SMs hold at once (bf16 x, then f32,
// each at 4, 8, 16 and 32 vectors a thread); returns that limit in bytes,
// or -1.  Called once per device, before the first launch there.
int int8_matmul_prepare(int device, int* resident) {
  int v = 0, sms = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                device) != cudaSuccess)
    return -1;
  const int vectors[4] = {4, 8, 16, 32};
  for (int i = 0; i < 8; ++i) {
    const QuantizeKernel k = i < 4 ? quantize_kernel_for<bf16>(vectors[i])
                                   : quantize_kernel_for<float>(vectors[i - 4]);
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)k,
                                                      QT, 0) != cudaSuccess)
      return -1;
    resident[i] = per_sm * sms;
  }
  return gemm_s8::set_smem(v) == 0 ? v : -1;
}

// Launch the quantize pass and the GEMM on `stream` (of device `device`)
// with the plan of ops/int8_matmul.py:int8_plan (bn, stages, smem_bytes;
// the quantize pass's team, qv and blocks).  `xq` [M, K] int8 and `sx` [M, K / G]
// f32 are scratch; `bias` may be null.  Returns 0 when both are queued, a
// cudaError_t of a launch, 1000 + the CUresult of a tensor map that could
// not be encoded, 2000 for a tile width with no kernel, 2001 for a
// quantize plan with no kernel.  The caller
// checks shapes (M >= 1, K % 32, G % 32, K % G, N % 8, the grid), dtypes,
// 16-byte aligned contiguous tensors and the plan's shared memory.
int int8_matmul(const void* x, int x_is_bf16, const void* wk, const void* sw,
                const void* bias, int bias_is_bf16, void* xq, void* sx,
                void* y, int M, int N, int K, int G, int bn, int stages,
                int smem_bytes, int team, int qv, int qblocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = x_is_bf16
      ? quantize<bf16>(x, xq, sx, M, K, G, team, qv, qblocks, st)
      : quantize<float>(x, xq, sx, M, K, G, team, qv, qblocks, st);
  if (err != 0) return err;
  gemm_s8::Args a;
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(sw);
  a.bias = bias;
  a.bias_bf16 = bias_is_bf16;
  a.M = M;
  a.N = N;
  a.K = K;
  a.G = G;
  a.stages = stages;
  return x_is_bf16 ? gemm<bf16>(xq, wk, y, a, bn, smem_bytes, st)
                   : gemm<float>(xq, wk, y, a, bn, smem_bytes, st);
}

}  // extern "C"
