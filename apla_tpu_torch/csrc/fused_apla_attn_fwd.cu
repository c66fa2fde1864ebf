// Fused APLA attention forward for Hopper (sm_90a): per-head softmax
// attention followed by the assembled APLA output projection, in one kernel.
//
// Replaces the TPU kernel apla_tpu/ops/pallas_apla_attn.py:_fwd_kernel
// (called through _call_fwd).  Contract, exactly that kernel's:
//
//   qkv [B, N, 3C] bf16 (packed as the frozen qkv matmul emits it),
//   w   [C, C]     bf16 (the frozen projection with the trainable columns
//                        written in; [d_in, d_out] layout)
//   out [B, N, C]  bf16 = concat_h(softmax(q_h k_h^T * scale) v_h) @ w
//
// with f32 scores, columns masked to the row's segment when seg > 0, p
// rounded to bf16 before p v, the concatenated head outputs rounded to bf16
// before the projection, and the projection accumulated in f32 and stored
// as bf16.  The bias is added by the caller.  The kernel masks the ragged
// edge of N itself; no padding is needed.
//
// What bounds it on the H100: at the served shape (B=64, N=257, C=768) the
// work is 32 GFLOP of bf16 matrix products (39 with pass 2's recomputed
// scores, below) against ~102 MB of device traffic, far above the card's
// ~295 FLOP/byte balance point, so it is bound by the tensor cores and by
// how well their latency is hidden, not by HBM.
// The fusion keeps what the TPU kernel keeps out of device memory: the
// [B, N, C] attention output lives in shared memory (o_cat, 97 KB at C=768)
// and feeds the projection from there.
//
// Design (right first; wgmma/TMA and warp specialisation are later work):
//  * one block of 8 warps per (image, tile of 64 query rows).  The warps form
//    two groups of 4, each group working on every other head with its own
//    shared-memory tiles and named barrier, so one group's loads overlap the
//    other's math.  In a group each warp owns 16 query rows.
//  * products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix operand loads;
//    scores, p and the head output stay in registers (FlashAttention-2
//    layout), tiles arrive by cp.async, double-buffered.
//  * softmax in two passes over the key tiles: pass 1 keeps each row's
//    running max and sum, pass 2 recomputes the scores and forms the
//    normalised p, so p is rounded to bf16 where the TPU kernel rounds it
//    and the p v accumulator never needs rescaling.  Masked scores are -inf;
//    a row with no valid column keeps max -inf, its reference point is 0 and
//    its p is 0, so exp(-inf - -inf) never occurs.
//  * with seg > 0 only the key tiles that meet the block's segments are
//    visited.
//  * the projection: the two groups take alternate 64-column tiles of w,
//    streamed through shared memory, with o_cat as the A operand.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;               // query rows per block
constexpr int BN = 64;               // key rows per tile
constexpr int DH = 64;               // head dim (every ViT builder)
constexpr int NT = 256;              // 8 warps = 2 groups of 4
constexpr int GT = 128;              // threads per group
constexpr int LDT = DH + 8;          // tile row stride (elements); the +8
                                     // keeps ldmatrix rows on distinct banks
constexpr int TILE = BM * LDT;       // elements per 64x64 tile
constexpr int TILES_PER_GROUP = 5;   // q, k[2], v[2]
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline size_t smem_bytes_for(int C) {
  return (size_t)BM * (C + 8) * sizeof(bf16)                    // o_cat
       + 2 * (size_t)TILES_PER_GROUP * TILE * sizeof(bf16);      // tiles
}

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

// 16-byte async copy; src_bytes = 0 writes zeros (rows past N)
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

// barrier over the 4 warps of group grp (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(grp + 1), "r"(GT) : "memory");
}

// Queue the copy of 64 rows x 64 columns (row-major source, row stride
// `stride` elements) into a [64][LDT] tile; rows at or past n_rows -> 0.
__device__ __forceinline__ void issue_tile(bf16* dst, const bf16* src,
                                           long stride, int row0, int n_rows,
                                           int gtid) {
#pragma unroll
  for (int i = gtid; i < 64 * 8; i += GT) {
    const int r = i >> 3, c8 = (i & 7) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * LDT + c8,
               ok ? src + (long)(row0 + r) * stride + c8 : src, ok);
  }
}

// s[j] (keys 8j..8j+7 of the tile) = this warp's 16 query rows . keys
__device__ __forceinline__ void warp_scores(const uint32_t (&qa)[4][4],
                                            const bf16* ks, int lane,
                                            float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t b[8];
    const bf16* row = ks + (8 * j + (lane & 7)) * LDT + (lane >> 3) * 8;
    ldsm_x4(b[0], b[1], b[2], b[3], row);
    ldsm_x4(b[4], b[5], b[6], b[7], row + 32);
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_bf16(s[j], qa[kk], b[2 * kk], b[2 * kk + 1]);
  }
}

// scores -> log2 units, -inf outside [lo, hi) of the fragment's row
__device__ __forceinline__ void scale_mask(float (&s)[8][4], int key0,
                                           float scale_log2, int lo0, int hi0,
                                           int lo1, int hi1) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * j + e;
      s[j][e] = (key >= lo0 && key < hi0) ? s[j][e] * scale_log2 : -INFINITY;
      s[j][2 + e] =
          (key >= lo1 && key < hi1) ? s[j][2 + e] * scale_log2 : -INFINITY;
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

__global__ void __launch_bounds__(NT, 1)
fused_apla_attn_fwd_kernel(const bf16* __restrict__ qkv,
                           const bf16* __restrict__ w,
                           bf16* __restrict__ out,
                           int N, int C, int H, float scale_log2, int seg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldo = C + 8;
  bf16* o_cat = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, gtid = tid & (GT - 1);
  const int wrow = (warp & 3) * 16;          // warp's first row in the tile
  bf16* qs = o_cat + (size_t)BM * ldo + (size_t)grp * TILES_PER_GROUP * TILE;
  bf16* kbuf[2] = {qs + TILE, qs + 2 * TILE};
  bf16* vbuf[2] = {qs + 3 * TILE, qs + 4 * TILE};

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const long rs = 3L * C;
  const bf16* base = qkv + (long)b * N * rs;
  const int g = lane >> 2, t = lane & 3;     // mma fragment row / column pair
  const int r_lo = row0 + wrow + g, r_hi = r_lo + 8;

  // valid key range of each of the thread's two rows, and the key tiles
  // any row of the block can see
  int lo0 = 0, hi0 = N, lo1 = 0, hi1 = N;
  int kt0 = 0, kt1 = (N + BN - 1) / BN;
  if (seg > 0) {
    lo0 = (r_lo / seg) * seg; hi0 = min(N, lo0 + seg);
    lo1 = (r_hi / seg) * seg; hi1 = min(N, lo1 + seg);
    const int last = min(row0 + BM, N) - 1;
    kt0 = ((row0 / seg) * seg) / BN;
    kt1 = (min(N, (last / seg + 1) * seg) + BN - 1) / BN;
  }
  const int n_kt = kt1 - kt0;

  for (int h = grp; h < H; h += 2) {
    const bf16* qh = base + h * DH;
    const bf16* kh = base + C + h * DH;
    const bf16* vh = base + 2 * C + h * DH;

    // ---- pass 1: running max and sum per row (log2 units) -------------
    group_sync(grp);                          // last head's tiles are free
    issue_tile(qs, qh, rs, row0, N, gtid);
    issue_tile(kbuf[0], kh, rs, kt0 * BN, N, gtid);
    cp_async_commit();
    uint32_t qa[4][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int i = 0; i < n_kt; ++i) {
      if (i + 1 < n_kt) {
        issue_tile(kbuf[(i + 1) & 1], kh, rs, (kt0 + i + 1) * BN, N, gtid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                  qs + (wrow + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8);
      }
      float s[8][4];
      warp_scores(qa, kbuf[i & 1], lane, s);
      scale_mask(s, (kt0 + i) * BN + 2 * t, scale_log2, lo0, hi0, lo1, hi1);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float ref0 = (mn0 == -INFINITY) ? 0.0f : mn0;
      const float ref1 = (mn1 == -INFINITY) ? 0.0f : mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum0 += exp2f(s[j][0] - ref0) + exp2f(s[j][1] - ref0);
        sum1 += exp2f(s[j][2] - ref1) + exp2f(s[j][3] - ref1);
      }
      l0 = l0 * exp2f(m0 - ref0) + quad_sum(sum0);
      l1 = l1 * exp2f(m1 - ref1) + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
      group_sync(grp);                        // tile i may be overwritten
    }

    // ---- pass 2: p = exp(s - max) / sum in bf16, o += p v ---------------
    const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
    const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    issue_tile(kbuf[0], kh, rs, kt0 * BN, N, gtid);
    issue_tile(vbuf[0], vh, rs, kt0 * BN, N, gtid);
    cp_async_commit();
    for (int i = 0; i < n_kt; ++i) {
      if (i + 1 < n_kt) {
        const int nb = (i + 1) & 1, r = (kt0 + i + 1) * BN;
        issue_tile(kbuf[nb], kh, rs, r, N, gtid);
        issue_tile(vbuf[nb], vh, rs, r, N, gtid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
      float s[8][4];
      warp_scores(qa, kbuf[i & 1], lane, s);
      scale_mask(s, (kt0 + i) * BN + 2 * t, scale_log2, lo0, hi0, lo1, hi1);
      const bf16* vs = vbuf[i & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {            // keys 16kk .. 16kk+15
        uint32_t pa[4];
        pa[0] = pack_bf16(exp2f(s[2 * kk][0] - ref0) * inv0,
                          exp2f(s[2 * kk][1] - ref0) * inv0);
        pa[1] = pack_bf16(exp2f(s[2 * kk][2] - ref1) * inv1,
                          exp2f(s[2 * kk][3] - ref1) * inv1);
        pa[2] = pack_bf16(exp2f(s[2 * kk + 1][0] - ref0) * inv0,
                          exp2f(s[2 * kk + 1][1] - ref0) * inv0);
        pa[3] = pack_bf16(exp2f(s[2 * kk + 1][2] - ref1) * inv1,
                          exp2f(s[2 * kk + 1][3] - ref1) * inv1);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {          // head dims 16nn .. +15
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(b0, b1, b2, b3,
                    vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT
                       + nn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * nn], pa, b0, b1);
          mma_bf16(o[2 * nn + 1], pa, b2, b3);
        }
      }
      group_sync(grp);
    }
    // o_h -> o_cat[:, h*DH : (h+1)*DH] in bf16
    bf16* o_lo = o_cat + (wrow + g) * ldo + h * DH + 2 * t;
    bf16* o_hi = o_lo + 8 * ldo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(o_lo + 8 * j) = pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(o_hi + 8 * j) = pack_bf16(o[j][2], o[j][3]);
    }
  }
  __syncthreads();                            // o_cat holds every head

  // ---- projection: out[rows, nt*64 ..] = o_cat @ w[:, nt*64 ..] ----------
  const int n_k = C / 64;
  for (int nt = grp; nt < C / 64; nt += 2) {
    const bf16* wt = w + nt * 64;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    group_sync(grp);
    issue_tile(kbuf[0], wt, C, 0, C, gtid);
    cp_async_commit();
    for (int i = 0; i < n_k; ++i) {
      if (i + 1 < n_k) {
        issue_tile(kbuf[(i + 1) & 1], wt, C, (i + 1) * 64, C, gtid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
      const bf16* ws = kbuf[i & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        ldsm_x4(a[0], a[1], a[2], a[3],
                o_cat + (wrow + (lane & 15)) * ldo + i * 64 + kk * 16
                      + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(b0, b1, b2, b3,
                    ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT
                       + nn * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * nn], a, b0, b1);
          mma_bf16(acc[2 * nn + 1], a, b2, b3);
        }
      }
      group_sync(grp);
    }
    bf16* dst = out + (long)b * N * C + nt * 64 + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r_lo < N)
        *reinterpret_cast<uint32_t*>(dst + (long)r_lo * C + 8 * j) =
            pack_bf16(acc[j][0], acc[j][1]);
      if (r_hi < N)
        *reinterpret_cast<uint32_t*>(dst + (long)r_hi * C + 8 * j) =
            pack_bf16(acc[j][2], acc[j][3]);
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs at width C (bytes).
long long fused_apla_attn_fwd_smem_bytes(int C) {
  return (long long)smem_bytes_for(C);
}

// Opt the kernel in to the largest dynamic shared memory a block may have
// on the current device, `device`; returns that size in bytes, or -1.
// Called once per device, before the first launch there.
int fused_apla_attn_fwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  if (cudaFuncSetAttribute(fused_apla_attn_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           v) != cudaSuccess)
    return -1;
  return v;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// The caller checks shapes: C == H * 64, 16-byte aligned contiguous
// tensors, and that the shared memory fits what
// fused_apla_attn_fwd_prepare opted in to.
int fused_apla_attn_fwd(const void* qkv, const void* w, void* out, int B,
                        int N, int C, int H, float scale, int seg,
                        void* stream) {
  const size_t smem = smem_bytes_for(C);
  dim3 grid((N + BM - 1) / BM, B);
  fused_apla_attn_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), N, C, H, scale * LOG2E, seg);
  return (int)cudaGetLastError();
}

}  // extern "C"
