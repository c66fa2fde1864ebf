// The attention backward of the Swin windows (fused_apla_attn_bwd.cu's
// fused_swin_attn_bwd, replacing pallas_apla_attn.py:_bwd_kernel_bias):
// FlashAttention-2's split of the work into a query side and a key side,
// with the TPU kernel's rounding points.  The ViTs at head dim 64 (the
// fused APLA backward and mha_bwd.cu) run attn_bwd_sm90.cuh, which keeps
// this body's sum orders; the templates below are instantiated at DH = 32
// with BIAS only.
//
// Layouts: qkv [B, N, 3C] bf16 packed (q | k | v, head h at columns
// h*DH .. h*DH+DH-1 of each third), dO [B, N, C] bf16, dqkv [B, N, 3C] bf16,
// stats [3, B, H, N] f32 scratch.  Per head, on the recomputed f32 p:
//
//   p  = softmax(mask(q k^T * scale))          (f32)
//   dv = bf16(p)^T dO,  dp = dO v^T,  ds = bf16((p * (dp - rowsum(dp * p)))
//        * scale),  dq = ds k,  dk = ds^T q    (f32 sums, bf16 out)
//
// rowsum(dp * p) is taken on the f32 p (not FlashAttention-2's
// rowsum(dO * o)).  Masked scores are -inf: columns past N and, when
// seg > 0, columns outside the row's segment of that length; a row with no
// valid column has p = 0.  With BIAS (Swin windows, DH = 32) the scores are
// (q k^T * scale + bias[h]) + mask[b mod nW] before the softmax (see
// mma::scale_bias_mask), and seg is unused.
//
//   query side: per (64-row query tile, head, image): softmax statistics,
//               rowsum(dp * p) (and, with WITH_O, o = bf16(bf16(p) v) into
//               o_cat for the APLA dW), then dq
//   key side:   per (64-row key tile, head, image): dk, dv, reading the
//               statistics the query side wrote
//
// Products use mma.sync m16n8k16 with ldmatrix operand loads; tiles arrive
// by cp.async, double-buffered.  What bounds it on the H100: the bytes (the
// bound chip_smoke.py phase 8a prints).  A window of 49 tokens fills one
// ragged 64-row tile, so each block runs one key tile per pass, and the
// work per byte is small.  The forward (TPU row 3) runs the same windows
// as many (window, head) items a block on wgmma and TMA
// (swin_attn_fwd.cu); this backward (row 4) is queued for that redesign
// in ROADMAP B.

#pragma once

#include "mma_sm90.cuh"

namespace {

using namespace mma;

constexpr int NT = 128;              // 4 warps, 16 rows each
constexpr int BM = 64;               // rows per tile

constexpr size_t QUERY_SMEM = 6 * TILE * sizeof(bf16);    // q dO k[2] v[2]
constexpr size_t KEY_SMEM = 6 * TILE * sizeof(bf16)       // k v q[2] dO[2]
                            + 2 * 3 * BM * sizeof(float); // stats[2]
constexpr size_t BWD_SMEM = KEY_SMEM > QUERY_SMEM ? KEY_SMEM : QUERY_SMEM;

template <int COLS = 64, int ROWS = 64>
__device__ __forceinline__ void issue(bf16* dst, const bf16* src, long stride,
                                      int row0, int n_rows, int tid) {
  issue_tile<NT, COLS, ROWS>(dst, src, stride, row0, n_rows, tid);
}

// scores of the tile whose first column is col0 (lane's 2t included) ->
// log2 units, masked (see the header comment); rows r_lo, r_lo + 8
template <bool BIAS, bool TRANS>
__device__ __forceinline__ void mask_tile(float (&s)[8][4], int col0,
                                          int r_lo, int n, float scale_log2,
                                          float scale, int lo0, int hi0,
                                          int lo1, int hi1, const float* bias,
                                          const float* mask) {
  if constexpr (BIAS)
    scale_bias_mask<TRANS>(s, col0, r_lo, n, scale, bias, mask);
  else
    scale_mask(s, col0, scale_log2, lo0, hi0, lo1, hi1);
}

// The segment [lo, hi) of valid columns for row r (all of [0, n) if seg = 0)
__device__ __forceinline__ void row_range(int r, int n, int seg, int& lo,
                                          int& hi) {
  lo = 0;
  hi = n;
  if (seg > 0) {
    lo = (r / seg) * seg;
    hi = min(n, lo + seg);
  }
}

// Tiles [t0, t1) of the other side that rows row0..row0+63 can see
__device__ __forceinline__ void tile_range(int row0, int n, int seg, int& t0,
                                           int& t1) {
  t0 = 0;
  t1 = (n + BM - 1) / BM;
  if (seg > 0) {
    const int last = min(row0 + BM, n) - 1;
    t0 = ((row0 / seg) * seg) / BM;
    t1 = (min(n, (last / seg + 1) * seg) + BM - 1) / BM;
  }
}

// ---- query side ----------------------------------------------------------
// stats [3][B*H*N]: reference point m (log2 units, 0 for an empty row),
// 1 / rowsum (0 for an empty row), D = rowsum(dp * p).  With WITH_O the
// head's o = bf16(bf16(p) v) goes to o_cat [B, N, C].
template <bool WITH_O, int DH, bool BIAS>
__global__ void __launch_bounds__(NT)
bwd_query_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                 bf16* __restrict__ o_cat, bf16* __restrict__ dqkv,
                 float* __restrict__ stats, const float* __restrict__ bias,
                 const float* __restrict__ mask, int B, int N, int C, int H,
                 float scale_log2, float scale, int seg, int nW) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ds_ = qs + TILE;                       // the dO tile
  bf16* kbuf[2] = {qs + 2 * TILE, qs + 3 * TILE};
  bf16* vbuf[2] = {qs + 4 * TILE, qs + 5 * TILE};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * BM;
  const long rs = 3L * C;
  const bf16* base = qkv + (long)b * N * rs;
  const bf16* qh = base + h * DH;
  const bf16* kh = base + C + h * DH;
  const bf16* vh = base + 2 * C + h * DH;
  const bf16* doh = dO + (long)b * N * C + h * DH;
  const int r_lo = row0 + wrow + g, r_hi = r_lo + 8;
  int lo0, hi0, lo1, hi1, kt0, kt1;
  row_range(r_lo, N, seg, lo0, hi0);
  row_range(r_hi, N, seg, lo1, hi1);
  tile_range(row0, N, seg, kt0, kt1);
  const int n_kt = kt1 - kt0;
  const float* bias_h = BIAS ? bias + (long)h * N * N : nullptr;
  const float* mask_w = (BIAS && mask != nullptr)
                            ? mask + (long)(b % nW) * N * N : nullptr;

  // ---- pass 1: running max and sum per row (log2 units) ----------------
  issue<DH>(qs, qh, rs, row0, N, tid);
  issue<DH>(ds_, doh, C, row0, N, tid);
  issue<DH>(kbuf[0], kh, rs, kt0 * BM, N, tid);
  cp_async_commit();
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  for (int i = 0; i < n_kt; ++i) {
    if (i + 1 < n_kt) {
      issue<DH>(kbuf[(i + 1) & 1], kh, rs, (kt0 + i + 1) * BM, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
      load_a_rows(qa, qs, wrow, lane);
      load_a_rows(da, ds_, wrow, lane);
    }
    float s[8][4];
    warp_scores(qa, kbuf[i & 1], lane, s);
    mask_tile<BIAS, false>(s, (kt0 + i) * BM + 2 * t, r_lo, N, scale_log2,
                           scale, lo0, hi0, lo1, hi1, bias_h, mask_w);
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
    __syncthreads();                           // tile i may be overwritten
  }
  const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
  const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;

  // ---- pass 2: D = rowsum(dp * p) (and o = bf16(pb v)) -----------------
  float acc[DH / 8][4];
  zero_acc(acc);
  float d0 = 0.0f, d1 = 0.0f;
  issue<DH>(kbuf[0], kh, rs, kt0 * BM, N, tid);
  issue<DH>(vbuf[0], vh, rs, kt0 * BM, N, tid);
  cp_async_commit();
  for (int i = 0; i < n_kt; ++i) {
    if (i + 1 < n_kt) {
      const int nb = (i + 1) & 1, r = (kt0 + i + 1) * BM;
      issue<DH>(kbuf[nb], kh, rs, r, N, tid);
      issue<DH>(vbuf[nb], vh, rs, r, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float p[8][4], dp[8][4];
    warp_scores(qa, kbuf[i & 1], lane, p);
    mask_tile<BIAS, false>(p, (kt0 + i) * BM + 2 * t, r_lo, N, scale_log2,
                           scale, lo0, hi0, lo1, hi1, bias_h, mask_w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = exp2f(p[j][0] - ref0) * inv0;
      p[j][1] = exp2f(p[j][1] - ref0) * inv0;
      p[j][2] = exp2f(p[j][2] - ref1) * inv1;
      p[j][3] = exp2f(p[j][3] - ref1) * inv1;
    }
    warp_scores(da, vbuf[i & 1], lane, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      d0 += dp[j][0] * p[j][0] + dp[j][1] * p[j][1];
      d1 += dp[j][2] * p[j][2] + dp[j][3] * p[j][3];
    }
    if (WITH_O) warp_mma_pv(p, vbuf[i & 1], lane, acc);
    __syncthreads();
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (WITH_O)
    store_rows_bf16(o_cat + ((long)b * N + row0 + wrow) * C + h * DH, C, acc,
                    r_lo, N, g, t);
  if (t == 0) {
    const long nstat = (long)B * H * N;
    const long i0 = ((long)b * H + h) * N;
    if (r_lo < N) {
      stats[i0 + r_lo] = ref0;
      stats[nstat + i0 + r_lo] = inv0;
      stats[2 * nstat + i0 + r_lo] = d0;
    }
    if (r_hi < N) {
      stats[i0 + r_hi] = ref1;
      stats[nstat + i0 + r_hi] = inv1;
      stats[2 * nstat + i0 + r_hi] = d1;
    }
  }

  // ---- pass 3: ds = bf16((p * (dp - D)) * scale), dq = ds k -------------
  zero_acc(acc);
  issue<DH>(kbuf[0], kh, rs, kt0 * BM, N, tid);
  issue<DH>(vbuf[0], vh, rs, kt0 * BM, N, tid);
  cp_async_commit();
  for (int i = 0; i < n_kt; ++i) {
    if (i + 1 < n_kt) {
      const int nb = (i + 1) & 1, r = (kt0 + i + 1) * BM;
      issue<DH>(kbuf[nb], kh, rs, r, N, tid);
      issue<DH>(vbuf[nb], vh, rs, r, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float p[8][4], dp[8][4];
    warp_scores(qa, kbuf[i & 1], lane, p);
    mask_tile<BIAS, false>(p, (kt0 + i) * BM + 2 * t, r_lo, N, scale_log2,
                           scale, lo0, hi0, lo1, hi1, bias_h, mask_w);
    warp_scores(da, vbuf[i & 1], lane, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = (exp2f(p[j][0] - ref0) * inv0 * (dp[j][0] - d0)) * scale;
      p[j][1] = (exp2f(p[j][1] - ref0) * inv0 * (dp[j][1] - d0)) * scale;
      p[j][2] = (exp2f(p[j][2] - ref1) * inv1 * (dp[j][2] - d1)) * scale;
      p[j][3] = (exp2f(p[j][3] - ref1) * inv1 * (dp[j][3] - d1)) * scale;
    }
    warp_mma_pv(p, kbuf[i & 1], lane, acc);    // ds (bf16) . k
    __syncthreads();
  }
  store_rows_bf16(dqkv + ((long)b * N + row0 + wrow) * rs + h * DH, rs, acc,
                  r_lo, N, g, t);
}

// ---- key side --------------------------------------------------------------
// Per key tile: for every query tile it can see, p^T and ds^T from the
// statistics of the query side, dv += pb^T dO and dk += ds^T q.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(NT)
bwd_key_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
               const float* __restrict__ stats, bf16* __restrict__ dqkv,
               const float* __restrict__ bias, const float* __restrict__ mask,
               int B, int N, int C, int H, float scale_log2, float scale,
               int seg, int nW) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE;
  bf16* qbuf[2] = {ks + 2 * TILE, ks + 3 * TILE};
  bf16* dbuf[2] = {ks + 4 * TILE, ks + 5 * TILE};
  float* sbuf = reinterpret_cast<float*>(ks + 6 * TILE);   // [2][3][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * BM;
  const long rs = 3L * C;
  const bf16* base = qkv + (long)b * N * rs;
  const bf16* qh = base + h * DH;
  const bf16* kh = base + C + h * DH;
  const bf16* vh = base + 2 * C + h * DH;
  const bf16* doh = dO + (long)b * N * C + h * DH;
  const long nstat = (long)B * H * N;
  const float* st = stats + ((long)b * H + h) * N;
  const int r_lo = key0 + wrow + g, r_hi = r_lo + 8;   // this thread's keys
  int lo0, hi0, lo1, hi1, qt0, qt1;
  row_range(r_lo, N, seg, lo0, hi0);
  row_range(r_hi, N, seg, lo1, hi1);
  tile_range(key0, N, seg, qt0, qt1);
  const int n_qt = qt1 - qt0;
  const float* bias_h = BIAS ? bias + (long)h * N * N : nullptr;
  const float* mask_w = (BIAS && mask != nullptr)
                            ? mask + (long)(b % nW) * N * N : nullptr;

  // statistics of query tile `qt` into sbuf[buf]: plain loads, made
  // visible by the barrier that precedes their use
  auto load_stats = [&](int buf, int qt) {
    for (int i = tid; i < 3 * BM; i += NT) {
      const int which = i / BM, q = qt * BM + i % BM;
      sbuf[buf * 3 * BM + i] = q < N ? st[which * nstat + q] : 0.0f;
    }
  };

  issue<DH>(ks, kh, rs, key0, N, tid);
  issue<DH>(vs, vh, rs, key0, N, tid);
  issue<DH>(qbuf[0], qh, rs, qt0 * BM, N, tid);
  issue<DH>(dbuf[0], doh, C, qt0 * BM, N, tid);
  cp_async_commit();
  load_stats(0, qt0);
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  float dk[DH / 8][4], dv[DH / 8][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int i = 0; i < n_qt; ++i) {
    if (i + 1 < n_qt) {
      const int nb = (i + 1) & 1, r = (qt0 + i + 1) * BM;
      issue<DH>(qbuf[nb], qh, rs, r, N, tid);
      issue<DH>(dbuf[nb], doh, C, r, N, tid);
      cp_async_commit();
      load_stats(nb, qt0 + i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
      load_a_rows(ka, ks, wrow, lane);
      load_a_rows(va, vs, wrow, lane);
    }
    const float* mref = sbuf + (i & 1) * 3 * BM;
    const float* il = mref + BM;
    const float* dd = mref + 2 * BM;
    float p[8][4], dp[8][4];
    warp_scores(ka, qbuf[i & 1], lane, p);         // s^T: keys x queries
    mask_tile<BIAS, true>(p, (qt0 + i) * BM + 2 * t, r_lo, N, scale_log2,
                          scale, lo0, hi0, lo1, hi1, bias_h, mask_w);
    warp_scores(va, dbuf[i & 1], lane, dp);        // dp^T = v dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;           // query within the tile
        p[j][e] = exp2f(p[j][e] - mref[c]) * il[c];
        p[j][2 + e] = exp2f(p[j][2 + e] - mref[c]) * il[c];
      }
    warp_mma_pv(p, dbuf[i & 1], lane, dv);         // dv += pb^T dO
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        p[j][e] = (p[j][e] * (dp[j][e] - dd[c])) * scale;
        p[j][2 + e] = (p[j][2 + e] * (dp[j][2 + e] - dd[c])) * scale;
      }
    warp_mma_pv(p, qbuf[i & 1], lane, dk);         // dk += ds^T q
    __syncthreads();
  }
  bf16* dst = dqkv + ((long)b * N + key0 + wrow) * rs + h * DH;
  store_rows_bf16(dst + C, rs, dk, r_lo, N, g, t);
  store_rows_bf16(dst + 2 * C, rs, dv, r_lo, N, g, t);
}

// Opt the two kernels in to their dynamic shared memory on `device`;
// returns the device's per-block opt-in limit in bytes, or -1.
template <bool WITH_O, int DH = 64, bool BIAS = false>
int attn_bwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  if ((size_t)v < BWD_SMEM) return v;
  if (cudaFuncSetAttribute(bwd_query_kernel<WITH_O, DH, BIAS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)QUERY_SMEM) != cudaSuccess ||
      cudaFuncSetAttribute(bwd_key_kernel<DH, BIAS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)KEY_SMEM) != cudaSuccess)
    return -1;
  return v;
}

// The query-side and key-side launches on `s`; returns the first nonzero
// cudaError_t of a launch, or 0 when both are queued.  With BIAS: bias
// [H, N, N] f32, mask [nW, N, N] f32 or null.
template <bool WITH_O, int DH = 64, bool BIAS = false>
int attn_bwd_launch(const bf16* qkv, const bf16* dO, bf16* o_cat, bf16* dqkv,
                    float* stats, int B, int N, int C, int H, float scale,
                    int seg, cudaStream_t s, const float* bias = nullptr,
                    const float* mask = nullptr, int nW = 1) {
  const dim3 att((N + BM - 1) / BM, H, B);
  bwd_query_kernel<WITH_O, DH, BIAS><<<att, NT, QUERY_SMEM, s>>>(
      qkv, dO, o_cat, dqkv, stats, bias, mask, B, N, C, H, scale * LOG2E,
      scale, seg, nW);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  bwd_key_kernel<DH, BIAS><<<att, NT, KEY_SMEM, s>>>(
      qkv, dO, stats, dqkv, bias, mask, B, N, C, H, scale * LOG2E, scale,
      seg, nW);
  return (int)cudaGetLastError();
}

}  // namespace
