// The attention backward at head dim 64 for Hopper (sm_90a), shared by the
// fused APLA backward (fused_apla_attn_bwd.cu, replacing
// pallas_apla_attn.py:_bwd_kernel and pallas_apla_attn_long.py:
// _bwda_kernel / _bwdb_kernel) and the plain multi-head attention backward
// (mha_bwd.cu, replacing pallas_mha.py:_bwd_kernel): FlashAttention-2's
// split of the work into a query side and a key side, with the TPU
// kernels' rounding points.  (The Swin windows, head dim 32 with bias and
// mask, have their own kernel: swin_attn_bwd.cu.)
//
// Layouts: qkv [B, N, 3C] bf16 packed (q | k | v, head h at columns
// h*64 .. h*64+63 of each third), dO [B, N, C] bf16, dqkv [B, N, 3C] bf16,
// stats [B, H, n_t, 3, 64] f32 scratch (n_t = ceil(N / 64): per 64-row
// query tile the rows' reference point m, 1 / rowsum and D, 768 bytes the
// key side loads with one bulk copy).  Per head, on the recomputed f32 p:
//
//   p  = softmax(mask(q k^T * scale))          (f32)
//   dv = bf16(p)^T dO,  dp = dO v^T,  ds = bf16((p * (dp - rowsum(dp * p)))
//        * scale),  dq = ds k,  dk = ds^T q    (f32 sums, bf16 out)
//
// rowsum(dp * p) is taken on the f32 p.  Masked scores are -inf: columns
// past N and, when seg > 0, columns outside the row's segment of that
// length; a row with no valid column has p = 0.
//
//   query side: per (64-row query tile, head, image), three passes over the
//               key tiles: softmax statistics; rowsum(dp * p) (and, with
//               WITH_O, o = bf16(bf16(p) v) into o_cat for the APLA dW);
//               dq.  It writes the statistics of all 64 rows (0 past N).
//   key side:   per (64-row key tile, head, image), one pass over the query
//               tiles: dk and dv from the statistics.
//
// Bits: every sum is the order of the mma.sync kernels these replace (the
// first port's attn_bwd.cuh at head dim 64): the statistics online over
// the key tiles in order, each thread's columns in j order, then quad_max /
// quad_sum; D as `d += dp0 * p0 + dp1 * p1` in (tile, j) order, then
// quad_sum; p = exp2f(s - ref) * inv and ds = bf16((p * (dp - D)) *
// scale) as the same source expressions; dq over the key tiles in order,
// dk and dv over the query tiles in order, each in one f32 accumulator
// with k16 steps in increasing order from +0.  A wgmma accumulator gives each thread the
// rows and columns of an mma.sync m16n8 fragment (sm90_async.cuh), so each
// per-thread order carries over; dq, dk, dv equal the earlier kernels' bit
// for bit (tools/compare_mha_fwd.py --kernel bwd / mha_bwd).
//
// What bounds it on the H100: the products and the arithmetic between
// them.  Per head and image the query side multiplies q k^T three times,
// dO v^T twice, p v (fused only) and ds k once; the key side k q^T, v dO^T,
// pb^T dO and ds^T q once each: 11 products of 2 * 64 * 64 * 64 per pair
// of tiles where the bound counts six.  Each warpgroup runs them as a
// chain (products, wait, the softmax arithmetic on their f32 results,
// products), so the tensor cores idle while a warpgroup computes unless
// another block's products fill the gap: two blocks an SM where the other
// side is resident (shared memory), three where it streams (registers).
// Keeping a pass's f32 scores for the next would save products, but they
// are 32 f32 a thread per key tile, over what registers and shared memory
// hold beside the resident tiles; issuing the next tile's products before
// this tile's arithmetic, or two key tiles to a group of wgmmas, needs two
// sets of scores live at once (227-255 registers): ptxas then serialised
// the wgmmas (C7515) or spilled, and both ran slower on the H100 than this
// design (PERF.md §6).  So the scores are recomputed, with their bits, and
// each product is a wgmma, each tile's load one TMA box:
//  * one warpgroup (128 threads) per block; a block takes a run of `tiles`
//    own tiles (query tiles on the query side, key tiles on the key side)
//    of one (image, head), laid out by ops/mha.py:bwd_plan.
//  * the other side's tiles stay resident in shared memory when they fit
//    two blocks an SM (N <= 320: K and V on the query side; Q, dO and the
//    statistics on the key side), loaded once per block, each behind its
//    own mbarrier; longer N streams them through a ring of `slots` stages
//    in the order the passes use them (the query side's first pass loads K
//    alone), refilled by thread 0 as stages free up.
//  * all loads are TMA boxes of 64 rows x 64 columns with the 128-byte
//    swizzle, issued by thread 0 through 3-D tensor maps over qkv and dO
//    (rows past N zero-filled, never the next image's); the key side's
//    statistics by a bulk copy.  The own tile is loaded again for the next
//    own tile as soon as the last product that reads it has retired.
//  * score-like products (q k^T, dO v^T; k q^T, v dO^T) read both operands
//    from shared memory, K-major; the products with p or ds as A (p v, ds
//    k; pb^T dO, ds^T q) take it from registers (the f32 accumulator,
//    rounded to bf16 and packed), with the other operand the same tile
//    read MN-major.  No atomics: reruns are bit-equal.
//  * results are stored from the fragments (rows past N skipped).

#pragma once

#include "sm90_async.cuh"

#include <math.h>

namespace attn90 {

using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int NT = 128;                      // one warpgroup
constexpr int BM = 64;                       // rows per tile
constexpr int DH = 64;                       // head dim
constexpr int TILE_BYTES = BM * DH * 2;      // 8 KB
constexpr int PAIR_BYTES = 2 * TILE_BYTES;   // K and V, or Q and dO
constexpr int STAT_BYTES = 3 * BM * 4;       // m, 1 / l, D of a query tile
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory after aligning the base to 1024 bytes: the own pair, then
// `slots` pairs of the other side, (key side) `slots` statistics blocks,
// then the barriers: the own tile's, then one per slot (the query side
// resident: K and V of each slot apart, 2 x slots); 256 bytes hold them.
// ops/mha.py:bwd_smem computes the size the launch asks for.
struct Plan {
  int B, N, H, C, seg;
  float scale_log2, scale;
  int n_t;          // ceil(N / 64): query tiles = key tiles
  int tiles;        // own tiles per block
  int groups;       // blocks per (image, head)
  int resident;     // the other side's tiles all in slots
  int slots;        // n_t (resident) or the ring's stages
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
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

// scores -> log2 units, -inf outside [lo, hi) of the fragment's row; the
// fragment's columns are col0 + 8j + e (col0 includes the lane's 2t)
__device__ __forceinline__ void scale_mask(float (&s)[32], int col0,
                                           float scale_log2, int lo0, int hi0,
                                           int lo1, int hi1) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      s[4 * j + e] = (col >= lo0 && col < hi0) ? s[4 * j + e] * scale_log2
                                               : -INFINITY;
      s[4 * j + 2 + e] = (col >= lo1 && col < hi1)
                             ? s[4 * j + 2 + e] * scale_log2 : -INFINITY;
    }
}

// scores -> log2 units in a tile with no masked column (seg = 0 and the
// tile inside N): the same product as scale_mask's, rounded on its own
// (__fmul_rn is never contracted into a later add), without the compares
__device__ __forceinline__ void scale_only(float (&s)[32], float scale_log2) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = __fmul_rn(s[e], scale_log2);
}

// 2^x by the special-function unit, results below 2^-126 flushed to 0.
// Only the softmax statistics use it: there each exponential is added to
// a sum that is at least 1 (the row maximum's own 2^0) before it is read,
// so a flushed one gives the same l, bit for bit, as exp2f.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s = a b^T over the 64 head columns: a and b K-major 64 x 64 tiles
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* a,
                                       const uint8_t* b) {
  const uint64_t da = desc_kmajor(a), db = desc_kmajor(b);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<64>(s, da + 2 * kk, db + 2 * kk, kk > 0);   // +32 bytes
}

// f32 fragments (64 x 64) -> bf16 A operands of four k16 steps
__device__ __forceinline__ void to_a(const float (&p)[32],
                                     uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(p, kk, pa[kk]);
}

// acc += A (registers, 64 x 64) . tile (64 rows of the contraction x the
// 64 head columns, read MN-major)
__device__ __forceinline__ void pv(float (&acc)[32],
                                   const uint32_t (&pa)[4][4],
                                   const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs64(acc, pa[kk], desc_mnmajor(tile + kk * 16 * 128));
}

// The warp's 16 x 64 f32 fragments as bf16 at dst (its first row, column
// 0; row stride ld), rows at or past n_rows skipped.
__device__ __forceinline__ void store_rows(bf16* dst, long ld,
                                           const float (&acc)[32], int r_lo,
                                           int n_rows, int g, int t) {
  bf16* lo = dst + (long)g * ld + 2 * t;
  bf16* hi = lo + 8 * ld;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(lo + 8 * j) =
          pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    if (r_lo + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(hi + 8 * j) =
          pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- query side ----------------------------------------------------------
// Thread 0's position in the streamed sequence of K/V uses: per own query
// tile, pass 0 the K tiles it sees, then passes 1 and 2 their K and V.
struct QUses {
  int qt, q1, pass, kt, k1;
  __device__ void start(const Plan& p, int q0, int q_end) {
    qt = q0;
    q1 = q_end;
    pass = 0;
    tile_range(qt * BM, p.N, p.seg, kt, k1);
  }
  __device__ bool valid() const { return qt < q1; }
  __device__ void next(const Plan& p) {
    if (++kt < k1) return;
    if (pass < 2) {
      ++pass;
      int x;
      tile_range(qt * BM, p.N, p.seg, kt, x);
      return;
    }
    pass = 0;
    if (++qt < q1) tile_range(qt * BM, p.N, p.seg, kt, k1);
  }
};

// qkvmap: qkv as [B][N][3C], domap: dO as [B][N][C], boxes {64, 64, 1}.
template <bool WITH_O>
__global__ void __launch_bounds__(NT)
bwd_query_kernel(const __grid_constant__ CUtensorMap qkvmap,
                 const __grid_constant__ CUtensorMap domap,
                 bf16* __restrict__ o_cat, bf16* __restrict__ dqkv,
                 float* __restrict__ stats, const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint8_t* own = sm;                          // q, then dO
  uint8_t* slot0 = sm + PAIR_BYTES;           // slot s: K, then V
  uint64_t* obar = reinterpret_cast<uint64_t*>(slot0 + p.slots * PAIR_BYTES);
  uint64_t* kbar = obar + 1;                  // [slot]
  uint64_t* vbar = kbar + p.slots;            // [slot] (resident)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % p.groups, bh = blockIdx.x / p.groups;
  const int h = bh % p.H, b = bh / p.H;
  const int q0 = grp * p.tiles, q1 = min(p.n_t, q0 + p.tiles);
  const int D = p.slots, N = p.N, seg = p.seg;
  const float sl2 = p.scale_log2, scale = p.scale;
  const long rs = 3L * p.C;
  // key tile kt has no masked column for any row
  auto full = [&](int kt) { return seg == 0 && (kt + 1) * BM <= N; };

  auto load_own = [&](int qt) {               // thread 0
    mbar_expect_tx(obar, PAIR_BYTES);
    tma_load_3d(own, &qkvmap, obar, h * DH, qt * BM, b);
    tma_load_3d(own + TILE_BYTES, &domap, obar, h * DH, qt * BM, b);
  };
  QUses uc = {};
  auto issue_use = [&](int use) {             // thread 0: uc's use
    const int st = use % D;
    uint8_t* slot = slot0 + st * PAIR_BYTES;
    mbar_expect_tx(kbar + st, uc.pass ? PAIR_BYTES : TILE_BYTES);
    tma_load_3d(slot, &qkvmap, kbar + st, p.C + h * DH, uc.kt * BM, b);
    if (uc.pass)
      tma_load_3d(slot + TILE_BYTES, &qkvmap, kbar + st, 2 * p.C + h * DH,
                  uc.kt * BM, b);
    uc.next(p);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * D; ++i) mbar_init(obar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int issued = 0;
  if (tid == 0) {
    load_own(q0);
    if (p.resident) {
      int k0, k1, kx;
      tile_range(q0 * BM, N, seg, k0, kx);
      tile_range((q1 - 1) * BM, N, seg, kx, k1);
      for (int w = 0; w < 2; ++w)
        for (int kt = k0; kt < k1; ++kt) {
          uint64_t* bar = (w ? vbar : kbar) + kt;
          mbar_expect_tx(bar, TILE_BYTES);
          tma_load_3d(slot0 + kt * PAIR_BYTES + w * TILE_BYTES, &qkvmap, bar,
                      (1 + w) * p.C + h * DH, kt * BM, b);
        }
    } else {
      uc.start(p, q0, q1);
      for (; issued < D && uc.valid(); ++issued) issue_use(issued);
    }
  }

  int use = 0;                                // streamed uses consumed
  // the slot of key tile kt in pass `pass`, its tiles waited for
  auto acquire = [&](int kt, int pass) -> const uint8_t* {
    if (p.resident) {
      mbar_wait(kbar + kt, 0);
      if (pass) mbar_wait(vbar + kt, 0);
      return slot0 + kt * PAIR_BYTES;
    }
    const int st = use % D;
    mbar_wait(kbar + st, (use / D) & 1);
    return slot0 + st * PAIR_BYTES;
  };
  auto release = [&]() {                      // after the use's wgmmas
    if (p.resident) return;
    ++use;
    named_sync(1, NT);
    if (tid == 0 && uc.valid()) issue_use(issued++);
  };

  int u = 0;                                  // own tiles done
  for (int qt = q0; qt < q1; ++qt, ++u) {
    mbar_wait(obar, u & 1);
    const uint8_t* qs = own;
    const uint8_t* ds_ = own + TILE_BYTES;    // the dO tile
    int k0, k1;
    tile_range(qt * BM, N, seg, k0, k1);
    const int r_lo = qt * BM + warp * 16 + g, r_hi = r_lo + 8;
    int lo0, hi0, lo1, hi1;
    row_range(r_lo, N, seg, lo0, hi0);
    row_range(r_hi, N, seg, lo1, hi1);

    // ---- pass 1: running max and sum per row (log2 units) --------------
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int kt = k0; kt < k1; ++kt) {
      const uint8_t* kv = acquire(kt, 0);
      float s[32];
      wgmma_fence();
      scores(s, qs, kv);
      wgmma_commit();
      wgmma_wait0();
      release();
      if (full(kt)) scale_only(s, sl2);
      else scale_mask(s, kt * BM + 2 * t, sl2, lo0, hi0, lo1, hi1);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float ref0 = (mn0 == -INFINITY) ? 0.0f : mn0;
      const float ref1 = (mn1 == -INFINITY) ? 0.0f : mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum0 += ex2(s[4 * j] - ref0) + ex2(s[4 * j + 1] - ref0);
        sum1 += ex2(s[4 * j + 2] - ref1) + ex2(s[4 * j + 3] - ref1);
      }
      l0 = l0 * ex2(m0 - ref0) + quad_sum(sum0);
      l1 = l1 * ex2(m1 - ref1) + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
    }
    const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
    const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;

    // ---- pass 2: D = rowsum(dp * p) (and o = bf16(pb v)) ---------------
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    float d0 = 0.0f, d1 = 0.0f;
    for (int kt = k0; kt < k1; ++kt) {
      const uint8_t* kv = acquire(kt, 1);
      float pr[32], dp[32];
      wgmma_fence();
      scores(pr, qs, kv);
      scores(dp, ds_, kv + TILE_BYTES);
      wgmma_commit();
      wgmma_wait0();
      if (full(kt)) scale_only(pr, sl2);
      else scale_mask(pr, kt * BM + 2 * t, sl2, lo0, hi0, lo1, hi1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pr[4 * j] = exp2f(pr[4 * j] - ref0) * inv0;
        pr[4 * j + 1] = exp2f(pr[4 * j + 1] - ref0) * inv0;
        pr[4 * j + 2] = exp2f(pr[4 * j + 2] - ref1) * inv1;
        pr[4 * j + 3] = exp2f(pr[4 * j + 3] - ref1) * inv1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d0 += dp[4 * j] * pr[4 * j] + dp[4 * j + 1] * pr[4 * j + 1];
        d1 += dp[4 * j + 2] * pr[4 * j + 2] + dp[4 * j + 3] * pr[4 * j + 3];
      }
      if (WITH_O) {
        uint32_t pa[4][4];
        to_a(pr, pa);
        wgmma_fence();
        pv(acc, pa, kv + TILE_BYTES);         // o += bf16(p) v
        wgmma_commit();
        wgmma_wait0();
      }
      release();
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (WITH_O)
      store_rows(o_cat + ((long)b * N + qt * BM + warp * 16) * p.C + h * DH,
                 p.C, acc, r_lo, N, g, t);
    if (t == 0) {                             // all 64 rows; 0 past N
      float* st = stats + ((long)bh * p.n_t + qt) * 3 * BM;
      const int rr = warp * 16 + g;
      const bool in0 = r_lo < N, in1 = r_hi < N;
      st[rr] = in0 ? ref0 : 0.0f;
      st[BM + rr] = in0 ? inv0 : 0.0f;
      st[2 * BM + rr] = in0 ? d0 : 0.0f;
      st[rr + 8] = in1 ? ref1 : 0.0f;
      st[BM + rr + 8] = in1 ? inv1 : 0.0f;
      st[2 * BM + rr + 8] = in1 ? d1 : 0.0f;
    }

    // ---- pass 3: ds = bf16((p * (dp - D)) * scale), dq = ds k ----------
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    for (int kt = k0; kt < k1; ++kt) {
      const uint8_t* kv = acquire(kt, 2);
      float pr[32], dp[32];
      wgmma_fence();
      scores(pr, qs, kv);
      scores(dp, ds_, kv + TILE_BYTES);
      wgmma_commit();
      wgmma_wait0();
      if (kt == k1 - 1 && qt + 1 < q1) {      // q and dO read for the last
        named_sync(2, NT);                    // time: load the next tile's
        if (tid == 0) load_own(qt + 1);
      }
      if (full(kt)) scale_only(pr, sl2);
      else scale_mask(pr, kt * BM + 2 * t, sl2, lo0, hi0, lo1, hi1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pr[4 * j] = (exp2f(pr[4 * j] - ref0) * inv0 * (dp[4 * j] - d0))
                    * scale;
        pr[4 * j + 1] =
            (exp2f(pr[4 * j + 1] - ref0) * inv0 * (dp[4 * j + 1] - d0))
            * scale;
        pr[4 * j + 2] =
            (exp2f(pr[4 * j + 2] - ref1) * inv1 * (dp[4 * j + 2] - d1))
            * scale;
        pr[4 * j + 3] =
            (exp2f(pr[4 * j + 3] - ref1) * inv1 * (dp[4 * j + 3] - d1))
            * scale;
      }
      uint32_t dsa[4][4];
      to_a(pr, dsa);
      wgmma_fence();
      pv(acc, dsa, kv);                       // dq += bf16(ds) k
      wgmma_commit();
      wgmma_wait0();
      release();
    }
    store_rows(dqkv + ((long)b * N + qt * BM + warp * 16) * rs + h * DH, rs,
               acc, r_lo, N, g, t);
  }
}

// ---- key side --------------------------------------------------------------
// Thread 0's position in the streamed sequence of Q/dO uses: per own key
// tile, the query tiles it sees.
struct KUses {
  int kt, k1, qt, q1;
  __device__ void start(const Plan& p, int k0, int k_end) {
    kt = k0;
    k1 = k_end;
    tile_range(kt * BM, p.N, p.seg, qt, q1);
  }
  __device__ bool valid() const { return kt < k1; }
  __device__ void next(const Plan& p) {
    if (++qt < q1) return;
    if (++kt < k1) tile_range(kt * BM, p.N, p.seg, qt, q1);
  }
};

// Per key tile: for every query tile it can see, p^T and ds^T from the
// statistics of the query side, dv += pb^T dO and dk += ds^T q.
__global__ void __launch_bounds__(NT)
bwd_key_kernel(const __grid_constant__ CUtensorMap qkvmap,
               const __grid_constant__ CUtensorMap domap,
               const float* __restrict__ stats, bf16* __restrict__ dqkv,
               const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint8_t* own = sm;                          // k, then v
  uint8_t* slot0 = sm + PAIR_BYTES;           // slot s: Q, then dO
  float* stat0 = reinterpret_cast<float*>(slot0 + p.slots * PAIR_BYTES);
  uint64_t* obar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(stat0) + p.slots * STAT_BYTES);
  uint64_t* bar = obar + 1;                   // [slot]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % p.groups, bh = blockIdx.x / p.groups;
  const int h = bh % p.H, b = bh / p.H;
  const int k0 = grp * p.tiles, k1 = min(p.n_t, k0 + p.tiles);
  const int D = p.slots, N = p.N, seg = p.seg;
  const float sl2 = p.scale_log2, scale = p.scale;
  const long rs = 3L * p.C;
  const float* st_h = stats + (long)bh * p.n_t * 3 * BM;
  // query tile qt has no masked column for any key
  auto full = [&](int qt) { return seg == 0 && (qt + 1) * BM <= N; };

  auto load_own = [&](int kt) {               // thread 0
    mbar_expect_tx(obar, PAIR_BYTES);
    tma_load_3d(own, &qkvmap, obar, p.C + h * DH, kt * BM, b);
    tma_load_3d(own + TILE_BYTES, &qkvmap, obar, 2 * p.C + h * DH, kt * BM,
                b);
  };
  auto load_slot = [&](int slot, int qt) {    // thread 0: Q, dO, stats
    uint64_t* bb = bar + slot;
    mbar_expect_tx(bb, PAIR_BYTES + STAT_BYTES);
    uint8_t* dst = slot0 + slot * PAIR_BYTES;
    tma_load_3d(dst, &qkvmap, bb, h * DH, qt * BM, b);
    tma_load_3d(dst + TILE_BYTES, &domap, bb, h * DH, qt * BM, b);
    bulk_load(stat0 + slot * 3 * BM, st_h + qt * 3 * BM, STAT_BYTES, bb);
  };
  KUses uc = {};

  if (tid == 0) {
    for (int i = 0; i < 1 + D; ++i) mbar_init(obar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int issued = 0;
  if (tid == 0) {
    load_own(k0);
    if (p.resident) {
      int a0, a1, ax;
      tile_range(k0 * BM, N, seg, a0, ax);
      tile_range((k1 - 1) * BM, N, seg, ax, a1);
      for (int qt = a0; qt < a1; ++qt) load_slot(qt, qt);
    } else {
      uc.start(p, k0, k1);
      for (; issued < D && uc.valid(); ++issued) {
        load_slot(issued % D, uc.qt);
        uc.next(p);
      }
    }
  }

  int use = 0;
  int u = 0;                                  // own tiles done
  for (int kt = k0; kt < k1; ++kt, ++u) {
    mbar_wait(obar, u & 1);
    int a0, a1;
    tile_range(kt * BM, N, seg, a0, a1);
    const int r_lo = kt * BM + warp * 16 + g, r_hi = r_lo + 8;  // keys
    int lo0, hi0, lo1, hi1;
    row_range(r_lo, N, seg, lo0, hi0);
    row_range(r_hi, N, seg, lo1, hi1);
    float dk[32], dv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.0f;
    for (int qt = a0; qt < a1; ++qt) {
      int sl;
      if (p.resident) {
        sl = qt;
        mbar_wait(bar + sl, 0);
      } else {
        sl = use % D;
        mbar_wait(bar + sl, (use / D) & 1);
      }
      const uint8_t* qd = slot0 + sl * PAIR_BYTES;
      const float* mref = stat0 + sl * 3 * BM;
      const float* il = mref + BM;
      const float* dd = mref + 2 * BM;
      float pr[32], dp[32];
      wgmma_fence();
      scores(pr, own, qd);                    // s^T: keys x queries
      scores(dp, own + TILE_BYTES, qd + TILE_BYTES);   // dp^T = v dO^T
      wgmma_commit();
      wgmma_wait0();
      if (qt == a1 - 1 && kt + 1 < k1) {      // k and v read for the last
        named_sync(2, NT);                    // time: load the next tile's
        if (tid == 0) load_own(kt + 1);
      }
      if (full(qt)) scale_only(pr, sl2);
      else scale_mask(pr, qt * BM + 2 * t, sl2, lo0, hi0, lo1, hi1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;    // query within the tile
          pr[4 * j + e] = exp2f(pr[4 * j + e] - mref[c]) * il[c];
          pr[4 * j + 2 + e] = exp2f(pr[4 * j + 2 + e] - mref[c]) * il[c];
        }
      uint32_t pa[4][4];
      to_a(pr, pa);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          pr[4 * j + e] = (pr[4 * j + e] * (dp[4 * j + e] - dd[c])) * scale;
          pr[4 * j + 2 + e] =
              (pr[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dd[c])) * scale;
        }
      uint32_t dsa[4][4];
      to_a(pr, dsa);
      wgmma_fence();
      pv(dv, pa, qd + TILE_BYTES);            // dv += pb^T dO
      pv(dk, dsa, qd);                        // dk += ds^T q
      wgmma_commit();
      wgmma_wait0();
      if (!p.resident) {
        ++use;
        named_sync(1, NT);
        if (tid == 0 && uc.valid()) {
          load_slot(issued % D, uc.qt);
          uc.next(p);
          ++issued;
        }
      }
    }
    bf16* dst = dqkv + ((long)b * N + kt * BM + warp * 16) * rs + h * DH;
    store_rows(dst + p.C, rs, dk, r_lo, N, g, t);
    store_rows(dst + 2 * p.C, rs, dv, r_lo, N, g, t);
  }
}

// ---- host ------------------------------------------------------------------

// Opt the kernels in to `bytes` of dynamic shared memory; 0 or a
// cudaError_t.
template <bool WITH_O>
int set_smem(int bytes) {
  int err = (int)cudaFuncSetAttribute(
      (const void*)bwd_query_kernel<WITH_O>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        (const void*)bwd_key_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// The launch plan of ops/mha.py:bwd_plan, as the C entries take it: own
// tiles per block, resident, slots, each side's dynamic shared memory.
struct LaunchPlan {
  int tiles, resident, slots, q_smem, k_smem;
};

// Bits of a C entry's `parts`: which of its launches it queues (all of
// them on the training path; one at a time to time them apart).
constexpr int PART_DO = 1, PART_QUERY = 2, PART_KEY = 4, PART_DW = 8;

// The query-side and key-side launches on `s` (those `parts` names): 0
// when queued, a cudaError_t of a launch, or 1000 + the CUresult of a
// tensor map that could not be encoded.
template <bool WITH_O>
int launch(const bf16* qkv, const bf16* dO, bf16* o_cat, bf16* dqkv,
           float* stats, int B, int N, int C, int H, float scale, int seg,
           const LaunchPlan& lp, int parts, cudaStream_t s) {
  CUtensorMap qkvmap, domap;
  int err = encode_bf16_3d(&qkvmap, qkv, 3ull * C, N, B, 6ull * C,
                           6ull * C * N, BM);
  if (err == 0)
    err = encode_bf16_3d(&domap, dO, C, N, B, 2ull * C, 2ull * C * N, BM);
  if (err != 0) return 1000 + err;
  Plan p;
  p.B = B;
  p.N = N;
  p.H = H;
  p.C = C;
  p.seg = seg;
  p.scale_log2 = scale * LOG2E;
  p.scale = scale;
  p.n_t = (N + BM - 1) / BM;
  p.resident = lp.resident;
  p.slots = lp.slots;
  p.tiles = lp.tiles;
  p.groups = (p.n_t + p.tiles - 1) / p.tiles;
  const int blocks = B * H * p.groups;
  if (parts & PART_QUERY) {
    bwd_query_kernel<WITH_O><<<blocks, NT, lp.q_smem, s>>>(
        qkvmap, domap, o_cat, dqkv, stats, p);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (parts & PART_KEY) {
    bwd_key_kernel<<<blocks, NT, lp.k_smem, s>>>(qkvmap, domap, stats, dqkv,
                                                 p);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace attn90
