// Fused APLA attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel apla_tpu/ops/pallas_apla_attn.py:_bwd_kernel
// (called through _call_bwd from the custom VJP's _fused_bwd).  Contract,
// exactly that kernel's, per image:
//
//   qkv [B, N, 3C] bf16, w [C, C] bf16 (assembled projection, [d_in, d_out]),
//   g   [B, N, C]  bf16 (cotangent of the projected output),
//   g_t [B, N, Kp] bf16 (g's trainable columns g[..., inds], zero-padded)
//
//   dO   = bf16(g w^T)                              [N, C]
//   per head h: p = softmax(mask(q k^T * scale)) in f32 (recomputed),
//     pb = bf16(p),  o = bf16(pb v),  dv = pb^T dO,  dp = dO v^T,
//     ds = bf16((p * (dp - rowsum(dp * p))) * scale),  dq = ds k,  dk = ds^T q
//   dqkv [B, N, 3C] bf16 = [dq | dk | dv]
//   dW_t [C, Kp]    f32  = sum over images and rows of o_cat^T g_t
//
// rounding where the TPU kernel rounds: dO, pb, o and ds are bf16, every
// product accumulates in f32, rowsum(dp * p) is taken on the f32 p (not
// FlashAttention-2's rowsum(dO * o)).  Masking as in the forward
// (fused_apla_attn_fwd.cu): -inf outside the row's segment and past N, a row
// with no valid column has p = 0.
//
// What bounds it on the H100: at the training shape (B=8 micro-batches of
// N=257, C=768, 12 heads) every product is a bf16 tensor-core product, so it
// is compute bound like the forward; it recomputes the scores three times
// (stats, o/rowsum, dq) on the query side and once on the key side.
//
// The TPU grid runs images in order and carries dW_t in VMEM across them;
// blocks on the card run in parallel, so the work is split in five launches
// (FlashAttention-2's split of the attention backward, plus two GEMMs):
//   1. gemm_nt:     dO = g w^T                       (64x64 tiles)
//   2. query side:  per (64-row query tile, head, image): softmax statistics,
//                   o (-> o_cat scratch), rowsum(dp * p), then dq
//   3. key side:    per (64-row key tile, head, image): dk, dv, reading the
//                   statistics written by 2
//   4. dW partials: o_cat^T g_t over chunks of rows, one f32 partial per
//                   chunk (no atomics)
//   5. dW reduce:   the partials summed in a fixed order: deterministic.
// Products use mma.sync m16n8k16 with ldmatrix operand loads; tiles arrive
// by cp.async, double-buffered.  wgmma/TMA are later work.

#include "mma_sm90.cuh"

namespace {

using namespace mma;

constexpr int NT = 128;              // 4 warps, 16 rows each
constexpr int BM = 64;               // rows per tile
constexpr int DH = 64;               // head dim

constexpr size_t QUERY_SMEM = 6 * TILE * sizeof(bf16);    // q dO k[2] v[2]
constexpr size_t KEY_SMEM = 6 * TILE * sizeof(bf16)       // k v q[2] dO[2]
                            + 2 * 3 * BM * sizeof(float); // stats[2]

__device__ __forceinline__ void issue(bf16* dst, const bf16* src, long stride,
                                      int row0, int n_rows, int tid) {
  issue_tile<NT>(dst, src, stride, row0, n_rows, tid);
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

// ---- 1. C[M, N] = bf16(A[M, K] B[N, K]^T), K and N multiples of 64 -------
__global__ void __launch_bounds__(NT)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
               bf16* __restrict__ Cm, int M, int N, int K) {
  __shared__ __align__(128) bf16 sa[2][TILE];
  __shared__ __align__(128) bf16 sb[2][TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * 64;
  const int nk = K / 64;
  float acc[8][4];
  zero_acc(acc);
  issue(sa[0], A, K, m0, M, tid);
  issue(sb[0], B, K, n0, N, tid);
  cp_async_commit();
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) {
      issue(sa[(i + 1) & 1], A + (i + 1) * 64, K, m0, M, tid);
      issue(sb[(i + 1) & 1], B + (i + 1) * 64, K, n0, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t a[4][4];
    load_a_rows(a, sa[i & 1], wrow, lane);
    warp_mma_nt(a, sb[i & 1], lane, acc);
    __syncthreads();
  }
  store_rows_bf16(Cm + (long)(m0 + wrow) * N + n0, N, acc, m0 + wrow + g, M,
                  g, t);
}

// ---- 2. query side -------------------------------------------------------
// stats [3][B*H*N]: reference point m (log2 units, 0 for an empty row),
// 1 / rowsum (0 for an empty row), D = rowsum(dp * p)
__global__ void __launch_bounds__(NT)
bwd_query_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                 bf16* __restrict__ o_cat, bf16* __restrict__ dqkv,
                 float* __restrict__ stats, int B, int N, int C, int H,
                 float scale_log2, float scale, int seg) {
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

  // ---- pass 1: running max and sum per row (log2 units) ----------------
  issue(qs, qh, rs, row0, N, tid);
  issue(ds_, doh, C, row0, N, tid);
  issue(kbuf[0], kh, rs, kt0 * BM, N, tid);
  cp_async_commit();
  uint32_t qa[4][4], da[4][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  for (int i = 0; i < n_kt; ++i) {
    if (i + 1 < n_kt) {
      issue(kbuf[(i + 1) & 1], kh, rs, (kt0 + i + 1) * BM, N, tid);
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
    scale_mask(s, (kt0 + i) * BM + 2 * t, scale_log2, lo0, hi0, lo1, hi1);
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

  // ---- pass 2: o = bf16(pb v), D = rowsum(dp * p) ----------------------
  float acc[8][4];
  zero_acc(acc);
  float d0 = 0.0f, d1 = 0.0f;
  issue(kbuf[0], kh, rs, kt0 * BM, N, tid);
  issue(vbuf[0], vh, rs, kt0 * BM, N, tid);
  cp_async_commit();
  for (int i = 0; i < n_kt; ++i) {
    if (i + 1 < n_kt) {
      const int nb = (i + 1) & 1, r = (kt0 + i + 1) * BM;
      issue(kbuf[nb], kh, rs, r, N, tid);
      issue(vbuf[nb], vh, rs, r, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float p[8][4], dp[8][4];
    warp_scores(qa, kbuf[i & 1], lane, p);
    scale_mask(p, (kt0 + i) * BM + 2 * t, scale_log2, lo0, hi0, lo1, hi1);
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
    warp_mma_pv(p, vbuf[i & 1], lane, acc);
    __syncthreads();
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
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
  issue(kbuf[0], kh, rs, kt0 * BM, N, tid);
  issue(vbuf[0], vh, rs, kt0 * BM, N, tid);
  cp_async_commit();
  for (int i = 0; i < n_kt; ++i) {
    if (i + 1 < n_kt) {
      const int nb = (i + 1) & 1, r = (kt0 + i + 1) * BM;
      issue(kbuf[nb], kh, rs, r, N, tid);
      issue(vbuf[nb], vh, rs, r, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float p[8][4], dp[8][4];
    warp_scores(qa, kbuf[i & 1], lane, p);
    scale_mask(p, (kt0 + i) * BM + 2 * t, scale_log2, lo0, hi0, lo1, hi1);
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

// ---- 3. key side ---------------------------------------------------------
// Per key tile: for every query tile it can see, p^T and ds^T from the
// statistics of pass 2, dv += pb^T dO and dk += ds^T q.
__global__ void __launch_bounds__(NT)
bwd_key_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
               const float* __restrict__ stats, bf16* __restrict__ dqkv,
               int B, int N, int C, int H, float scale_log2, float scale,
               int seg) {
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

  // statistics of query tile `qt` into sbuf[buf]: plain loads, made
  // visible by the barrier that precedes their use
  auto load_stats = [&](int buf, int qt) {
    for (int i = tid; i < 3 * BM; i += NT) {
      const int which = i / BM, q = qt * BM + i % BM;
      sbuf[buf * 3 * BM + i] = q < N ? st[which * nstat + q] : 0.0f;
    }
  };

  issue(ks, kh, rs, key0, N, tid);
  issue(vs, vh, rs, key0, N, tid);
  issue(qbuf[0], qh, rs, qt0 * BM, N, tid);
  issue(dbuf[0], doh, C, qt0 * BM, N, tid);
  cp_async_commit();
  load_stats(0, qt0);
  uint32_t ka[4][4], va[4][4];
  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int i = 0; i < n_qt; ++i) {
    if (i + 1 < n_qt) {
      const int nb = (i + 1) & 1, r = (qt0 + i + 1) * BM;
      issue(qbuf[nb], qh, rs, r, N, tid);
      issue(dbuf[nb], doh, C, r, N, tid);
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
    scale_mask(p, (qt0 + i) * BM + 2 * t, scale_log2, lo0, hi0, lo1, hi1);
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

// ---- 4. dW_t partials: part[z] = o_cat[rows of chunk z]^T g_t[same rows] --
__global__ void __launch_bounds__(NT)
dw_partial_kernel(const bf16* __restrict__ o, const bf16* __restrict__ gt,
                  float* __restrict__ part, int M, int C, int Kp,
                  int chunk_rows) {
  __shared__ __align__(128) bf16 so[2][TILE];
  __shared__ __align__(128) bf16 sg[2][TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * 64;
  const int m_begin = blockIdx.z * chunk_rows;
  const int m_end = min(M, m_begin + chunk_rows);
  const int n_steps = (m_end - m_begin + BM - 1) / BM;
  float acc[8][4];
  zero_acc(acc);
  if (n_steps > 0) {
    issue(so[0], o + i0, C, m_begin, m_end, tid);
    issue(sg[0], gt + j0, Kp, m_begin, m_end, tid);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      const int r = m_begin + (s + 1) * BM;
      issue(so[(s + 1) & 1], o + i0, C, r, m_end, tid);
      issue(sg[(s + 1) & 1], gt + j0, Kp, r, m_end, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ot = so[s & 1];
    const bf16* gtt = sg[s & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {            // rows 16kk..+15 of the step
      // A = o^T: the warp's 16 columns of o as rows, transposed on load
      uint32_t a[4];
      ldsm_x4_t(a[0], a[1], a[2], a[3],
                ot + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * LDT + wrow
                   + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  gtt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT
                      + nn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nn], a, b0, b1);
        mma_bf16(acc[2 * nn + 1], a, b2, b3);
      }
    }
    __syncthreads();
  }
  float* dst = part + ((long)blockIdx.z * C + i0 + wrow + g) * Kp + j0 + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][0],
                                                          acc[j][1]);
    *reinterpret_cast<float2*>(dst + 8 * Kp + 8 * j) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// ---- 5. dW_t = sum of the partials, chunk 0 first -------------------------
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long n,
                                 int n_chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += part[(long)c * n + i];
  out[i] = s;
}

}  // namespace

extern "C" {

// Opt the two attention kernels in to their dynamic shared memory on the
// current device, `device`; returns the device's per-block opt-in limit in
// bytes, or -1.  Called once per device, before the first launch there.
int fused_apla_attn_bwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  if ((size_t)v < KEY_SMEM || (size_t)v < QUERY_SMEM) return v;
  if (cudaFuncSetAttribute(bwd_query_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)QUERY_SMEM) != cudaSuccess ||
      cudaFuncSetAttribute(bwd_key_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)KEY_SMEM) != cudaSuccess)
    return -1;
  return v;
}

// Largest dynamic shared memory of the five launches (bytes).
long long fused_apla_attn_bwd_smem_bytes() {
  return (long long)(KEY_SMEM > QUERY_SMEM ? KEY_SMEM : QUERY_SMEM);
}

// The five launches on `stream`; returns the first nonzero cudaError_t of
// a launch, or 0 when all are queued.  The caller checks shapes (C == H*64,
// Kp a multiple of 64, 16-byte aligned contiguous tensors) and allocates
// the scratch: dO and o_cat [B, N, C] bf16, stats [3, B, H, N] f32, part
// [n_chunks, C, Kp] f32, with n_chunks * chunk_rows >= B * N.
int fused_apla_attn_bwd(const void* qkv, const void* w, const void* g,
                        const void* gt, void* dqkv, void* dwt, void* dO,
                        void* o_cat, void* stats, void* part, int B, int N,
                        int C, int H, int Kp, float scale, int seg,
                        int chunk_rows, int n_chunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * N;
  const bf16* qkv_ = static_cast<const bf16*>(qkv);
  bf16* dO_ = static_cast<bf16*>(dO);
  bf16* o_ = static_cast<bf16*>(o_cat);
  bf16* dqkv_ = static_cast<bf16*>(dqkv);
  float* stats_ = static_cast<float*>(stats);
  int err;

  gemm_nt_kernel<<<dim3(C / 64, (M + BM - 1) / BM), NT, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(w), dO_, M, C, C);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  const dim3 att((N + BM - 1) / BM, H, B);
  bwd_query_kernel<<<att, NT, QUERY_SMEM, s>>>(
      qkv_, dO_, o_, dqkv_, stats_, B, N, C, H, scale * LOG2E, scale, seg);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  bwd_key_kernel<<<att, NT, KEY_SMEM, s>>>(
      qkv_, dO_, stats_, dqkv_, B, N, C, H, scale * LOG2E, scale, seg);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  float* part_ = static_cast<float*>(part);
  dw_partial_kernel<<<dim3(C / 64, Kp / 64, n_chunks), NT, 0, s>>>(
      o_, static_cast<const bf16*>(gt), part_, M, C, Kp, chunk_rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  const long n = (long)C * Kp;
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part_, static_cast<float*>(dwt), n, n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
