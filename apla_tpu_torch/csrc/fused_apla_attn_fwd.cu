// Fused Swin window attention forward for Hopper (sm_90a): per-head
// softmax attention followed by the window block's output projection, in
// one kernel.  The Swin window kernel (DH = 32, BIAS) replaces
// apla_tpu/ops/pallas_apla_attn.py:_fwd_kernel_bias (called through
// _call_fwd_swin), the ViT kernel's body with the relative-position bias
// and the shift mask added to the scores.
//
// The template's ViT instantiation (DH = 64, no bias, the segment mask)
// served pallas_apla_attn.py:_fwd_kernel and pallas_apla_attn_long.py:
// _fwd_kernel until their forward became two launches on the card, the
// attention (mha_fwd.cu) and the projection GEMM (apla_proj_gemm.cu), with
// this kernel's rounding points and sum orders; its DH = 64 and seg paths
// are kept so that the window kernels' code is unchanged.
//
// Contract, exactly those kernels':
//
//   qkv  [B, N, 3C] bf16 (packed as the frozen qkv matmul emits it; for
//                         Swin, B = images x windows, image outermost)
//   w    [C, C]     bf16 (the projection, [d_in, d_out] layout: the frozen
//                         one with the trainable columns written in, or
//                         Swin's fully trainable attn.proj)
//   bias [H, N, N]  f32  (Swin: the gathered relative-position bias)
//   mask [nW, N, N] f32  (Swin, shifted blocks: the shift mask, 0 / -1e9,
//                         window b's plane at b mod nW; absent otherwise)
//   out  [B, N, C]  bf16 = concat_h(softmax(s_h) v_h) @ w,
//   s_h = (q_h k_h^T * scale + bias[h]) + mask[b mod nW]   (Swin)
//   s_h = q_h k_h^T * scale, masked to the row's segment     (ViT, seg > 0)
//
// with f32 scores, p normalised in f32 and rounded to bf16 before p v, the
// concatenated head outputs rounded to bf16 before the projection, and the
// projection accumulated in f32 and stored as bf16.  The projection's bias
// is added by the caller.  The kernel masks the ragged edge of N itself (a
// Swin window's 49 tokens are one 64-row tile, 15 rows zero-filled, masked
// and stored nowhere); no padding is needed.
//
// What bounds it on the H100: a Swin window is small (N=49): at stage 0 of
// a b16 batch (1024 windows, C=96) the work is 1.87 GFLOP against 39 MB,
// so its bound is bytes, and launch and per-block latency weigh more than
// tile speed.  The fusion keeps what the TPU kernel keeps out of device
// memory: the [B, N, C] attention output lives in shared memory (o_cat,
// 64 x C) and feeds the projection from there.
//
// Design (right first; wgmma/TMA and warp specialisation are later work):
//  * one block of 8 warps per (image or window, tile of 64 query rows).
//    The warps form two groups of 4, each group working on every other head
//    (an odd head count leaves group 1 one head short) with its own
//    shared-memory tiles and named barrier, so one group's loads overlap
//    the other's math.  In a group each warp owns 16 query rows.
//  * products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix operand loads;
//    scores, p and the head output stay in registers (FlashAttention-2
//    layout), tiles arrive by cp.async, double-buffered.
//  * softmax in two passes over the key tiles: pass 1 keeps each row's
//    running max and sum, pass 2 recomputes the scores and forms the
//    normalised p, so p is rounded to bf16 where the TPU kernel rounds it
//    and the p v accumulator never needs rescaling.  Masked scores are -inf;
//    a row with no valid column keeps max -inf, its reference point is 0 and
//    its p is 0, so exp(-inf - -inf) never occurs.  The Swin bias and mask
//    are read from device memory (L1/L2-resident: 28 KB and 614 KB at stage
//    0) where each score is formed.
//  * with seg > 0 only the key tiles that meet the block's segments are
//    visited.
//  * the projection: the two groups take alternate PW-column tiles of w
//    (PW = 64, or 32 when C is not a multiple of 64: Swin-T's stage 0 has
//    C = 96), streamed through shared memory in PW-row steps, with o_cat as
//    the A operand.

#include "mma_sm90.cuh"

namespace {

using namespace mma;

constexpr int BM = 64;               // query rows per block
constexpr int BN = 64;               // key rows per tile
constexpr int NT = 256;              // 8 warps = 2 groups of 4
constexpr int GT = 128;              // threads per group
constexpr int TILES_PER_GROUP = 5;   // q, k[2], v[2]

__host__ __device__ inline size_t smem_bytes_for(int C) {
  return (size_t)BM * (C + 8) * sizeof(bf16)                    // o_cat
       + 2 * (size_t)TILES_PER_GROUP * TILE * sizeof(bf16);      // tiles
}

// barrier over the 4 warps of group grp (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(grp + 1), "r"(GT) : "memory");
}

// a group's tile copy (see mma::issue_tile)
template <int COLS = 64, int ROWS = 64>
__device__ __forceinline__ void group_tile(bf16* dst, const bf16* src,
                                           long stride, int row0, int n_rows,
                                           int gtid) {
  mma::issue_tile<GT, COLS, ROWS>(dst, src, stride, row0, n_rows, gtid);
}

// DH: head dim (64 for every ViT builder, 32 for every Swin one).  BIAS:
// the Swin variant (bias, mask, nW read; seg unused).  PW: the projection's
// tile width.  The Swin blocks are small, so two may share an SM.
template <int DH, bool BIAS, int PW>
__global__ void __launch_bounds__(NT, DH == 64 ? 1 : 2)
fused_apla_attn_fwd_kernel(const bf16* __restrict__ qkv,
                           const bf16* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           bf16* __restrict__ out, int N, int C, int H,
                           float scale_log2, float scale, int seg, int nW) {
  static_assert(DH == 32 || DH == 64, "head dim 32 or 64");
  static_assert(PW == 32 || PW == 64, "projection tile 32 or 64");
  constexpr int KS = DH / 16;                // k-steps over the head dim
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
  const float* mask_w = (BIAS && mask != nullptr)
                            ? mask + (long)(b % nW) * N * N : nullptr;

  for (int h = grp; h < H; h += 2) {
    const bf16* qh = base + h * DH;
    const bf16* kh = base + C + h * DH;
    const bf16* vh = base + 2 * C + h * DH;
    const float* bias_h = BIAS ? bias + (long)h * N * N : nullptr;

    // ---- pass 1: running max and sum per row (log2 units) -------------
    group_sync(grp);                          // last head's tiles are free
    group_tile<DH>(qs, qh, rs, row0, N, gtid);
    group_tile<DH>(kbuf[0], kh, rs, kt0 * BN, N, gtid);
    cp_async_commit();
    uint32_t qa[KS][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int i = 0; i < n_kt; ++i) {
      if (i + 1 < n_kt) {
        group_tile<DH>(kbuf[(i + 1) & 1], kh, rs, (kt0 + i + 1) * BN, N,
                       gtid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                  qs + (wrow + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8);
      }
      float s[8][4];
      warp_scores(qa, kbuf[i & 1], lane, s);
      if constexpr (BIAS)
        scale_bias_mask<false>(s, (kt0 + i) * BN + 2 * t, r_lo, N, scale,
                               bias_h, mask_w);
      else
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
    float o[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    group_tile<DH>(kbuf[0], kh, rs, kt0 * BN, N, gtid);
    group_tile<DH>(vbuf[0], vh, rs, kt0 * BN, N, gtid);
    cp_async_commit();
    for (int i = 0; i < n_kt; ++i) {
      if (i + 1 < n_kt) {
        const int nb = (i + 1) & 1, r = (kt0 + i + 1) * BN;
        group_tile<DH>(kbuf[nb], kh, rs, r, N, gtid);
        group_tile<DH>(vbuf[nb], vh, rs, r, N, gtid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
      float s[8][4];
      warp_scores(qa, kbuf[i & 1], lane, s);
      if constexpr (BIAS)
        scale_bias_mask<false>(s, (kt0 + i) * BN + 2 * t, r_lo, N, scale,
                               bias_h, mask_w);
      else
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
        for (int nn = 0; nn < DH / 16; ++nn) {    // head dims 16nn .. +15
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
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(o_lo + 8 * j) = pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(o_hi + 8 * j) = pack_bf16(o[j][2], o[j][3]);
    }
  }
  __syncthreads();                            // o_cat holds every head

  // ---- projection: out[rows, nt*PW ..] = o_cat @ w[:, nt*PW ..] ----------
  const int n_k = C / PW;
  for (int nt = grp; nt < C / PW; nt += 2) {
    const bf16* wt = w + nt * PW;
    float acc[PW / 8][4];
#pragma unroll
    for (int j = 0; j < PW / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    group_sync(grp);
    group_tile<PW, PW>(kbuf[0], wt, C, 0, C, gtid);
    cp_async_commit();
    for (int i = 0; i < n_k; ++i) {
      if (i + 1 < n_k) {
        group_tile<PW, PW>(kbuf[(i + 1) & 1], wt, C, (i + 1) * PW, C, gtid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
      const bf16* ws = kbuf[i & 1];
#pragma unroll
      for (int kk = 0; kk < PW / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a[0], a[1], a[2], a[3],
                o_cat + (wrow + (lane & 15)) * ldo + i * PW + kk * 16
                      + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < PW / 16; ++nn) {
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
    bf16* dst = out + (long)b * N * C + nt * PW + 2 * t;
#pragma unroll
    for (int j = 0; j < PW / 8; ++j) {
      if (r_lo < N)
        *reinterpret_cast<uint32_t*>(dst + (long)r_lo * C + 8 * j) =
            pack_bf16(acc[j][0], acc[j][1]);
      if (r_hi < N)
        *reinterpret_cast<uint32_t*>(dst + (long)r_hi * C + 8 * j) =
            pack_bf16(acc[j][2], acc[j][3]);
    }
  }
}

// Opt one instantiation in to `bytes` of dynamic shared memory.
template <int DH, bool BIAS, int PW>
bool opt_in(int bytes) {
  return cudaFuncSetAttribute(fused_apla_attn_fwd_kernel<DH, BIAS, PW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes) == cudaSuccess;
}

// The device's per-block opt-in limit of dynamic shared memory, or -1.
int smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs at width C (bytes).
long long fused_swin_attn_fwd_smem_bytes(int C) {
  return (long long)smem_bytes_for(C);
}

// Opt the Swin window kernels in to the largest dynamic shared memory a
// block may have on the current device, `device`; returns that size in
// bytes, or -1.  Called once per device, before the first launch there.
int fused_swin_attn_fwd_prepare(int device) {
  const int v = smem_optin(device);
  return (v >= 0 && opt_in<32, true, 64>(v) && opt_in<32, true, 32>(v))
             ? v : -1;
}

// The Swin window kernel (head dim 32) on `stream`: bias [H, N, N] f32,
// mask [nW, N, N] f32 or null (a block that is not shifted).  Returns the
// cudaError_t of the launch.  The caller checks shapes: C == H * 32,
// 16-byte aligned contiguous tensors, the shared memory.
int fused_swin_attn_fwd(const void* qkv, const void* w, const void* bias,
                        const void* mask, void* out, int B, int N, int C,
                        int H, int nW, float scale, void* stream) {
  const size_t smem = smem_bytes_for(C);
  dim3 grid((N + BM - 1) / BM, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* w_ = static_cast<const bf16*>(w);
  const float* bias_ = static_cast<const float*>(bias);
  const float* mask_ = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 64 == 0)
    fused_apla_attn_fwd_kernel<32, true, 64><<<grid, NT, smem, s>>>(
        q, w_, bias_, mask_, o, N, C, H, scale * mma::LOG2E, scale, 0, nW);
  else
    fused_apla_attn_fwd_kernel<32, true, 32><<<grid, NT, smem, s>>>(
        q, w_, bias_, mask_, o, N, C, H, scale * mma::LOG2E, scale, 0, nW);
  return (int)cudaGetLastError();
}

}  // extern "C"
