// Swin window attention backward for Hopper (sm_90a): dO = g w^T, then per
// window and head the attention's gradients and the scratch o, then dW =
// o_cat^T g over every window's rows.
//
// Replaces apla_tpu/ops/pallas_apla_attn.py:_bwd_kernel_bias (called
// through _call_bwd_swin from the custom VJP's _fused_swin_bwd), the ViT
// backward kernel's body with the relative-position bias and the shift
// mask added to the scores, the whole projection trainable (g_t = g,
// Kp = C).  Contract, that kernel's:
//
//   qkv  [B, N, 3C] bf16 (B = images x windows, image outermost; C = H * 32)
//   w    [C, C]     bf16 (attn.proj, [d_in, d_out] layout)
//   g    [B, N, C]  bf16 (cotangent of the projected output)
//   bias [H, N, N]  f32, mask [nW, N, N] f32 (window b's plane b mod nW;
//                   absent in a block that is not shifted)
//
//   dO = bf16(g w^T)
//   per window b and head h, on the recomputed f32 p:
//     p  = softmax((q k^T * scale + bias[h]) + mask[b mod nW])
//     pb = bf16(p),  o = bf16(pb v),  dv = pb^T dO,  dp = dO v^T,
//     ds = bf16((p * (dp - rowsum(dp * p))) * scale),  dq = ds k,
//     dk = ds^T q                               (f32 sums, bf16 out)
//   dqkv [B, N, 3C] bf16 = [dq | dk | dv],  dW [C, C] f32 = sum of o_cat^T g
//
// Bits: dqkv and dW are those of the first port's kernel (fused_apla_attn_
// bwd.cu on attn_bwd.cuh's mma.sync query and key sides) to the last bit
// (tools/compare_mha_fwd.py --kernel swin_bwd counts the equal values).
// Every sum keeps its order: the scores as swin_sm90.cuh forms them; the
// row statistics online over the key tiles, each thread's columns in j
// order, then quad_max / quad_sum; D as `d += dp0 * p0 + dp1 * p1` in
// (tile, j) order, then quad_sum; p = exp2f(s - ref) * inv and ds =
// bf16((p * (dp - D)) * scale) as the same expressions; dq over the key
// tiles, dk and dv over the query tiles, each in one f32 accumulator from
// +0 in increasing k16 steps of 64-row tiles; dO over C and each dW
// partial over its chunk of rows (the chunks of ops/fused_apla_attn.py:
// dw_chunks) in increasing k16 steps, the partials summed in chunk order.
// That kernel's key side formed s^T = k q^T and dp^T = v dO^T; here dk and
// dv take pb and ds as the query side formed them, transposed through
// shared memory: the same 32 products an element, with the operands of
// each swapped, give the same f32 (the compare tool shows them equal).
//
// What bounds it on the H100: a window is small (N = 49).  At stage 0 of a
// b16 Swin-T batch (1024 windows, C = 96, 3 heads) the call reads qkv, g,
// w, the bias and mask planes and writes dqkv and dW, 68 MB: 0.0203 ms at
// 3.35 TB/s, against 4.7 GFLOP of products (0.0047 ms).  What it executes
// per (window, head) item is a chain: two score products, the softmax on
// their f32 results, two products with p and ds from registers, two with
// them from shared memory, each 64 x 64 x 32 or 64 x 32 x 64.  The first
// port ran that chain three times on a query side (K loaded again and the
// scores formed again in each pass) and a fourth on a key side a launch
// later, each reading the item's 2 x 49 x 49 bias and mask terms again.
//
// Design, three launches queued by one C call (`parts` picks any of them,
// so that each can be timed apart):
//  1. dO = g w^T: gemm_sm90.cuh's GEMM with g K-major and w read in place
//     as the K-major B; its 64-column boxes zero-fill past C, so C = 96
//     runs two zero k16 steps after the six real ones, which add +0.
//  2. the attention, one warpgroup (128 threads) a block, items (window,
//     head) laid out by ops/fused_swin_attn.py:swin_bwd_plan, a window's
//     heads next to each other (they share its mask plane).  Head-dim-32
//     tiles are TMA boxes of 32 columns x 64 rows with the 64-byte swizzle
//     through 3-D maps over qkv, dO, o_cat and dqkv: rows past N are
//     zero-filled on load and clipped on store, never the next window's.
//     - "row" kernel, N <= 64 (one tile: every Swin-T window, 7 x 7 or
//       8 x 8): an item's q, k, v and dO tiles arrive once, on one
//       mbarrier, into one of two sets (the next item's load while this
//       one computes).  One pass: s = q k^T and dp = dO v^T (wgmma
//       m64n64k16, K-major from shared memory) while the thread's bias and
//       mask terms go into registers, read once; the statistics, p, D, ds
//       in registers; o = pb v and dq = ds k with pb and ds from registers
//       as the A operand (v and k MN-major); pb and ds staged in shared
//       memory (bf16, swizzled, two 32-column halves) as the MN-major A of
//       dv = pb^T dO and dk = ds^T q.  o, dq, dk and dv are staged where
//       pb and ds were and stored by four TMA stores.  No statistics leave
//       the block.  49 KB of shared memory and at most 128 registers give
//       four blocks an SM.  What bounds it (PERF.md §6, row 4): the chain of
//       each item, in which the bias and mask terms' scattered __ldg and
//       the output stores weigh most.
//     - "tiles" kernel, N > 64 (windows of 9 x 9 and up): one item a
//       block, all of its q, k, v and dO tiles resident; for each query
//       tile three passes over the key tiles (the statistics online, then
//       D and o, then dq), the statistics kept in shared memory; then for
//       each key tile one pass over the query tiles (dk, dv as above).
//       Shared memory bounds it at 12 tiles (N <= 768).
//  3. dW = o_cat^T g: gemm_sm90.cuh's GEMM with both MN-major over the
//     B * N rows in chunks, one f32 partial a chunk (the store clips rows
//     and columns past C), then dw_reduce_kernel sums them in chunk order.

#include "swin_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

using namespace swin90;

// `parts` of the C entry
constexpr int PART_DO = 1, PART_ATTN = 2, PART_DW = 4;

// An item's tiles, in this order in a row kernel's set and, n_t of each,
// in the tiles kernel's resident block
constexpr int TQ = 0, TK = 1, TV = 2, TDO = 3;
constexpr int SET_BYTES = 4 * TILE_BYTES;      // 16 KB
// pb or ds staged: 64 query rows x 64 key columns, two 32-column halves
constexpr int STAGED_BYTES = 2 * TILE_BYTES;   // 8 KB

// Shared memory (after aligning the base to 1024 bytes; the sizes are
// ops/fused_swin_attn.py:_bwd_smem's): the row kernel's `sets` sets, pb
// and ds (then the four output tiles o, dq, dk, dv), one barrier a set;
// the tiles kernel's 4 n_t tiles, pb, ds, one output tile, the statistics
// [n_t][3][64] f32 (ref, 1 / l, D of each query row), one barrier.

struct Plan {
  int N, H, C, nW;
  float scale;
  int n_t;              // ceil(N / 64): query tiles = key tiles
  int items;            // B * H (window b, head h at b H + h)
  int items_per_block;  // row kernel
  int sets;             // row kernel: input sets (1, or 2 to prefetch)
  const float* bias;    // [H, N, N]
  const float* mask;    // [nW, N, N] or null
};

__device__ __forceinline__ const float* bias_of(const Plan& p, int h) {
  return p.bias + (long)h * p.N * p.N;
}

__device__ __forceinline__ const float* mask_of(const Plan& p, int b) {
  return p.mask != nullptr ? p.mask + (long)(b % p.nW) * p.N * p.N
                           : nullptr;
}

// thread 0: rows rt * 64 .. + 63 of head h of window b, the tile `which`
// (q, k, v of qkv; dO) into `dst`, counted on `bar`
__device__ __forceinline__ void load_tile(uint8_t* dst, int which,
                                          const CUtensorMap* qkvmap,
                                          const CUtensorMap* domap,
                                          uint64_t* bar, const Plan& p,
                                          int h, int rt, int b) {
  if (which == TDO)
    tma_load_3d(dst, domap, bar, h * DH, rt * BM, b);
  else
    tma_load_3d(dst, qkvmap, bar, which * p.C + h * DH, rt * BM, b);
}

// The row statistics of one key tile's scores s (log2 units), as the
// first port's first pass took them over its only tile (the sum against
// the row maximum), and p = 2^(s - max) / sum in place.
__device__ __forceinline__ void softmax_one_tile(float (&s)[32]) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float ref0 = (mx0 == -INFINITY) ? 0.0f : mx0;
  const float ref1 = (mx1 == -INFINITY) ? 0.0f : mx1;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = exp2f(s[e] - ((e & 2) ? ref1 : ref0));
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  const float l0 = quad_sum(sum0), l1 = quad_sum(sum1);
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] *= (e & 2) ? inv1 : inv0;
}

// d (rows r, r + 8) += rowsum(dp * p) over one key tile, in j order
__device__ __forceinline__ void add_rowsum(float& d0, float& d1,
                                           const float (&dp)[32],
                                           const float (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    d0 += dp[4 * j] * p[4 * j] + dp[4 * j + 1] * p[4 * j + 1];
    d1 += dp[4 * j + 2] * p[4 * j + 2] + dp[4 * j + 3] * p[4 * j + 3];
  }
}

// An f32 accumulator (64 x 64) rounded to bf16 as four k16 A operands
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(x, kk, a[kk]);
}

// The bf16 A operands of a 64 x 64 tile (query rows, key columns) written
// into shared memory at `dst` as two 64-byte-swizzled halves of 32 key
// columns: the MN-major A (rows = the contraction) of a product over the
// queries.  a[kk]: rows g, g + 8 of the warp, columns 16 kk + 2t (+ 8).
__device__ __forceinline__ void stage_a(const uint32_t (&a)[4][4],
                                        uint8_t* dst, int tid) {
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint8_t* half = dst + (kk >> 1) * TILE_BYTES;
    const int col = (kk & 1) * 16 + 2 * t;
    *reinterpret_cast<uint32_t*>(half + swz64(r0, col)) = a[kk][0];
    *reinterpret_cast<uint32_t*>(half + swz64(r0 + 8, col)) = a[kk][1];
    *reinterpret_cast<uint32_t*>(half + swz64(r0, col + 8)) = a[kk][2];
    *reinterpret_cast<uint32_t*>(half + swz64(r0 + 8, col + 8)) = a[kk][3];
  }
}

// acc (64 x 32) += A^T B over the 64 query rows: A staged by stage_a
// (MN-major: its 32-column halves 4 KB apart, the descriptor's leading
// byte offset; 8-row groups 512 bytes apart), B a 64 x 32 tile of the
// queries (MN-major).  A k16 step is 16 rows of both: 1024 bytes.
__device__ __forceinline__ void transposed_product(float (&acc)[16],
                                                   const uint8_t* a,
                                                   const uint8_t* b) {
  const uint64_t da = desc_sw64(a, TILE_BYTES, 512);
  const uint64_t db = desc_mnmajor64(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_t<32, 1, 1>(acc, da + kk * 64, db + kk * 64, 1);
}

// acc (64 x 32) += A B with A from registers (four k16 steps over 64 key
// rows) and B a 64 x 32 tile of the keys (MN-major)
__device__ __forceinline__ void register_product(float (&acc)[16],
                                                 const uint32_t (&a)[4][4],
                                                 const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs32(acc, a[kk], desc_mnmajor64(b + kk * 16 * DH * 2));
}

__device__ __forceinline__ void zero(float (&acc)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
}

// ---------------------------------------------------------------------------
// Row kernel: N <= 64.  Thread 0 issues the loads (an item's four tiles on
// its set's barrier) and the stores.  Barriers: one per set.  pb and ds
// are staged where the item's four output tiles are staged next, so a
// block takes 49 KB of shared memory, and the registers (at most 128)
// leave four blocks an SM.
__global__ void __launch_bounds__(NT, 4)
swin_bwd_row_kernel(const __grid_constant__ CUtensorMap qkvmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap omap,
                    const __grid_constant__ CUtensorMap dmap, const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint8_t* pb_s = sm + p.sets * SET_BYTES;
  uint8_t* ds_s = pb_s + STAGED_BYTES;
  uint8_t* out = pb_s;                       // o, dq, dk, dv once read
  uint64_t* bar = reinterpret_cast<uint64_t*>(ds_s + STAGED_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int it0 = blockIdx.x * p.items_per_block;
  const int it1 = min(p.items, it0 + p.items_per_block);

  // thread 0: the four tiles of item `it` into set `set`
  auto load_item = [&](int it, int set) {
    uint8_t* dst = sm + set * SET_BYTES;
    mbar_expect_tx(bar + set, SET_BYTES);
#pragma unroll
    for (int w = 0; w < 4; ++w)
      load_tile(dst + w * TILE_BYTES, w, &qkvmap, &domap, bar + set, p,
                it % p.H, 0, it / p.H);
  };

  if (tid == 0) {
    for (int i = 0; i < p.sets; ++i) mbar_init(bar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_item(it0, 0);
    if (p.sets == 2 && it0 + 1 < it1) load_item(it0 + 1, 1);
  }

  const int r_lo = warp * 16 + g;
  for (int it = it0; it < it1; ++it) {
    const int j = it - it0;
    const int set = p.sets == 2 ? (j & 1) : 0;
    const uint32_t parity = (p.sets == 2 ? (j >> 1) : j) & 1;
    const int b = it / p.H, h = it % p.H;
    const float* bias_h = bias_of(p, h);
    const float* mask_w = mask_of(p, b);
    const uint8_t* in = sm + set * SET_BYTES;

    // s = q k^T, the bias and mask terms read meanwhile; then dp = dO v^T
    // while the softmax is taken
    float s[32], dp[32];
    mbar_wait(bar + set, parity);
    wgmma_fence();
    scores_n<DH, 64>(s, desc_kmajor64(in + TQ * TILE_BYTES),
                     desc_kmajor64(in + TK * TILE_BYTES));
    wgmma_commit();
    {
      float bt[32], mt[32];
      fetch_terms<64>(bt, mt, 0, r_lo, t, p.N, bias_h, mask_w);
      wgmma_wait0();
      add_terms<64>(s, bt, mt, 0, r_lo, t, p.N, p.scale, mask_w != nullptr);
    }
    wgmma_fence();
    scores_n<DH, 64>(dp, desc_kmajor64(in + TDO * TILE_BYTES),
                     desc_kmajor64(in + TV * TILE_BYTES));
    wgmma_commit();

    // p (rows past N: 0), D = rowsum(dp * p), ds = (p (dp - D)) * scale
    softmax_one_tile(s);
    wgmma_wait0();
    float d0 = 0.0f, d1 = 0.0f;
    add_rowsum(d0, d1, dp, s);
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    uint32_t pa[4][4], da[4][4];
    to_a(s, pa);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = (s[e] * (dp[e] - ((e & 2) ? d1 : d0))) * p.scale;
    to_a(dp, da);

    // pb and ds staged in shared memory once the previous item's stores
    // have read its output tiles there, then one group: o = pb v and
    // dq = ds k with pb and ds from registers, dv = pb^T dO and dk = ds^T q
    // from shared memory
    if (tid == 0) tma_store_wait_read();
    named_sync(1, NT);
    stage_a(pa, pb_s, tid);
    stage_a(da, ds_s, tid);
    fence_proxy_async();
    named_sync(1, NT);
    float o[16], dq[16], dk[16], dv[16];
    zero(o);
    zero(dq);
    zero(dk);
    zero(dv);
    wgmma_fence();
    register_product(o, pa, in + TV * TILE_BYTES);
    register_product(dq, da, in + TK * TILE_BYTES);
    transposed_product(dv, pb_s, in + TDO * TILE_BYTES);
    transposed_product(dk, ds_s, in + TQ * TILE_BYTES);
    wgmma_commit();
    wgmma_wait0();

    // the four output tiles, staged over pb and ds once every thread's
    // products have read them; then the set is free for the item after
    // the next
    named_sync(1, NT);
    stage_tile(o, out, tid);
    stage_tile(dq, out + TILE_BYTES, tid);
    stage_tile(dk, out + 2 * TILE_BYTES, tid);
    stage_tile(dv, out + 3 * TILE_BYTES, tid);
    fence_proxy_async();
    named_sync(1, NT);
    if (tid == 0) {
      tma_store_3d(&omap, out, h * DH, 0, b);
#pragma unroll
      for (int w = 0; w < 3; ++w)
        tma_store_3d(&dmap, out + (1 + w) * TILE_BYTES, w * p.C + h * DH, 0,
                     b);
      tma_store_commit();
      const int next = it + p.sets;
      if (next < it1) load_item(next, set);
    }
  }
  if (tid == 0) tma_store_wait_all();
}

// ---------------------------------------------------------------------------
// Tiles kernel: any N (the plan takes it past one tile); one item (window,
// head) a block, every tile of it resident, loaded at once on one barrier.
__global__ void __launch_bounds__(NT, 2)
swin_bwd_tiles_kernel(const __grid_constant__ CUtensorMap qkvmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap omap,
                      const __grid_constant__ CUtensorMap dmap,
                      const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  const int n = p.n_t;
  uint8_t* pb_s = sm + 4 * n * TILE_BYTES;
  uint8_t* ds_s = pb_s + STAGED_BYTES;
  uint8_t* out = ds_s + STAGED_BYTES;
  float* stats = reinterpret_cast<float*>(out + TILE_BYTES);  // [n][3][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(stats + n * 3 * BM);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float* bias_h = bias_of(p, h);
  const float* mask_w = mask_of(p, b);
  auto tile = [&](int which, int i) -> uint8_t* {
    return sm + (which * n + i) * TILE_BYTES;
  };
  // s = q_i k_j^T (and dp = dO_i v_j^T) to log2 units with the terms
  auto scores = [&](float (&s)[32], float (&dp)[32], int i, int j,
                    bool with_dp) {
    wgmma_fence();
    scores_n<DH, 64>(s, desc_kmajor64(tile(TQ, i)),
                     desc_kmajor64(tile(TK, j)));
    if (with_dp)
      scores_n<DH, 64>(dp, desc_kmajor64(tile(TDO, i)),
                       desc_kmajor64(tile(TV, j)));
    wgmma_commit();
    wgmma_wait0();
    bias_mask<64>(s, j, i * BM + warp * 16 + g, t, p.N, p.scale, bias_h,
                  mask_w);
  };
  // one output tile: staged once the previous store has read the staging
  auto put = [&](const float (&acc)[16], const CUtensorMap* map, int c0,
                 int rt) {
    if (tid == 0) tma_store_wait_read();
    named_sync(1, NT);
    stage_tile(acc, out, tid);
    fence_proxy_async();
    named_sync(1, NT);
    if (tid == 0) {
      tma_store_3d(map, out, c0, rt * BM, b);
      tma_store_commit();
    }
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 4 * n * TILE_BYTES);
    for (int which = 0; which < 4; ++which)
      for (int i = 0; i < n; ++i)
        load_tile(tile(which, i), which, &qkvmap, &domap, bar, p, h, i, b);
  }
  mbar_wait(bar, 0);

  // the query orientation: per query tile the statistics, D and o, dq
  for (int qi = 0; qi < n; ++qi) {
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float s[32], dp[32];
    for (int kj = 0; kj < n; ++kj) {
      scores(s, dp, qi, kj, false);
      online_stats<false>(s, m0, m1, l0, l1);
    }
    const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
    const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;

    float acc[16], d0 = 0.0f, d1 = 0.0f;
    zero(acc);
    for (int kj = 0; kj < n; ++kj) {                // D and o = pb v
      scores(s, dp, qi, kj, true);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = exp2f(s[e] - ((e & 2) ? ref1 : ref0)) * ((e & 2) ? inv1 : inv0);
      add_rowsum(d0, d1, dp, s);
      uint32_t pa[4][4];
      to_a(s, pa);
      wgmma_fence();
      register_product(acc, pa, tile(TV, kj));
      wgmma_commit();
      wgmma_wait0();
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    put(acc, &omap, h * DH, qi);

    zero(acc);
    for (int kj = 0; kj < n; ++kj) {                // dq = ds k
      scores(s, dp, qi, kj, true);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = (exp2f(s[e] - ((e & 2) ? ref1 : ref0)) *
                 ((e & 2) ? inv1 : inv0) * (dp[e] - ((e & 2) ? d1 : d0))) *
                p.scale;
      uint32_t da[4][4];
      to_a(dp, da);
      wgmma_fence();
      register_product(acc, da, tile(TK, kj));
      wgmma_commit();
      wgmma_wait0();
    }
    put(acc, &dmap, h * DH, qi);
    if (t == 0) {
      float* st = stats + qi * 3 * BM;
      const int r = warp * 16 + g;
      st[r] = ref0;
      st[BM + r] = inv0;
      st[2 * BM + r] = d0;
      st[r + 8] = ref1;
      st[BM + r + 8] = inv1;
      st[2 * BM + r + 8] = d1;
    }
  }
  named_sync(1, NT);                                // the statistics

  // the key orientation: per key tile dv = pb^T dO and dk = ds^T q over
  // the query tiles, pb and ds formed in the query orientation again
  for (int kj = 0; kj < n; ++kj) {
    float dk[16], dv[16];
    zero(dk);
    zero(dv);
    for (int qi = 0; qi < n; ++qi) {
      const float* st = stats + qi * 3 * BM;
      const int r = warp * 16 + g;
      const float ref0 = st[r], inv0 = st[BM + r], d0 = st[2 * BM + r];
      const float ref1 = st[r + 8], inv1 = st[BM + r + 8];
      const float d1 = st[2 * BM + r + 8];
      float s[32], dp[32];
      scores(s, dp, qi, kj, true);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = exp2f(s[e] - ((e & 2) ? ref1 : ref0)) * ((e & 2) ? inv1 : inv0);
        dp[e] = (s[e] * (dp[e] - ((e & 2) ? d1 : d0))) * p.scale;
      }
      uint32_t pa[4][4], da[4][4];
      to_a(s, pa);
      to_a(dp, da);
      named_sync(1, NT);                  // the last products read pb, ds
      stage_a(pa, pb_s, tid);
      stage_a(da, ds_s, tid);
      fence_proxy_async();
      named_sync(1, NT);
      wgmma_fence();
      transposed_product(dv, pb_s, tile(TDO, qi));
      transposed_product(dk, ds_s, tile(TQ, qi));
      wgmma_commit();
      wgmma_wait0();
    }
    put(dk, &dmap, p.C + h * DH, kj);
    put(dv, &dmap, 2 * p.C + h * DH, kj);
  }
  if (tid == 0) tma_store_wait_all();
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                       Plan);

}  // namespace

extern "C" {

// Opt the kernels (the two attention kernels, the two GEMMs) in to the
// device's per-block shared memory limit on the current device, `device`;
// returns that limit in bytes, or -1.  Called once per device, before the
// first launch there.
int swin_attn_bwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  if (set_smem(swin_bwd_row_kernel, v) || set_smem(swin_bwd_tiles_kernel, v)
      || gemm90::set_smem<0, 0, false>(v) || gemm90::set_smem<1, 1, true>(v))
    return -1;
  return v;
}

// The launches that `parts` names, on `stream`: PART_DO the dO GEMM (g, w
// -> dO), PART_ATTN the attention (qkv, dO, bias, mask -> dqkv, o_cat),
// PART_DW the dW partials and their sum (o_cat, g -> part -> dw).  `shape`
// holds the shape and the plans of ops/fused_swin_attn.py, 17 ints:
// {B, N, C, H, nW, tiles kernel, items per block, sets, attention shared
// memory, then the dO GEMM's and the dW GEMM's tile width, stages and
// shared memory, then the dW chunks' rows and count}.  bias [H, N, N] f32,
// mask [nW, N, N] f32 or null.  Scratch the caller allocates: dO and o_cat
// [B, N, C] bf16, part [n_chunks, C, C] f32.  Returns 0 when queued, a
// cudaError_t of a launch, 1000 + the CUresult of a tensor map that could
// not be encoded, or 2000 for a GEMM tile width with no kernel.  The
// caller checks shapes: C == H * 32, 16-byte aligned contiguous tensors,
// the plans' shared memory within the device's limit, every chunk of rows
// a multiple of 64 and non-empty.
int swin_attn_bwd(const void* qkv, const void* w, const void* g,
                  const void* bias, const void* mask, void* dqkv, void* dw,
                  void* dO, void* o_cat, void* part, const int* shape,
                  float scale, int parts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int B = shape[0], N = shape[1], C = shape[2], H = shape[3];
  const int nW = shape[4];
  const int* attn = shape + 5;
  const int* do_gemm = shape + 9;
  const int* dw_gemm = shape + 12;
  const int chunk_rows = shape[15], n_chunks = shape[16];
  const uint64_t row = 2ull * C, M = (uint64_t)B * N;
  int err = 0;
  if (parts & PART_DO) {
    // dO [M, C] = g [M, C] w^T: w [C, C] row-major is w^T's K-major form
    CUtensorMap amap, bmap, cmap;
    err = encode_bf16_3d(&amap, g, C, M, 1, row, row * M, gemm90::BM);
    if (err == 0)
      err = encode_bf16_3d(&bmap, w, C, C, 1, row, row * C, do_gemm[0]);
    if (err == 0) err = encode_bf16_3d(&cmap, dO, C, M, 1, row, row * M, 64);
    if (err != 0) return 1000 + err;
    gemm90::Args a;
    a.K = C;
    a.chunk = C;
    a.stages = do_gemm[1];
    a.M = (int)M;
    a.N = C;
    a.out = nullptr;
    if ((err = gemm90::launch<0, 0, false>(amap, bmap, cmap, a, do_gemm[0],
                                            1, do_gemm[2], s)) != 0)
      return err;
  }
  if (parts & PART_ATTN) {
    CUtensorMap qkvmap, domap, omap, dmap;
    err = encode_dh32(&qkvmap, qkv, 3ull * C, N, B);
    if (err == 0) err = encode_dh32(&domap, dO, C, N, B);
    if (err == 0) err = encode_dh32(&omap, o_cat, C, N, B);
    if (err == 0) err = encode_dh32(&dmap, dqkv, 3ull * C, N, B);
    if (err != 0) return 1000 + err;
    Plan p;
    p.N = N;
    p.H = H;
    p.C = C;
    p.nW = nW;
    p.scale = scale;
    p.n_t = (N + BM - 1) / BM;
    p.items = B * H;
    p.items_per_block = attn[1];
    p.sets = attn[2];
    p.bias = static_cast<const float*>(bias);
    p.mask = static_cast<const float*>(mask);
    const int blocks =
        attn[0] ? p.items
                : (p.items + p.items_per_block - 1) / p.items_per_block;
    const Kernel k = attn[0] ? swin_bwd_tiles_kernel : swin_bwd_row_kernel;
    k<<<blocks, NT, attn[3], s>>>(qkvmap, domap, omap, dmap, p);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (parts & PART_DW) {
    // part[z] [C, C] = o_cat[chunk z]^T g[chunk z]: both row-major over the
    // M rows, so o_cat^T is an MN-major A and g an MN-major B
    CUtensorMap amap, bmap;
    err = encode_bf16_3d(&amap, o_cat, C, M, 1, row, row * M, 64);
    if (err == 0) err = encode_bf16_3d(&bmap, g, C, M, 1, row, row * M, 64);
    if (err != 0) return 1000 + err;
    gemm90::Args a;
    a.K = (int)M;
    a.chunk = chunk_rows;
    a.stages = dw_gemm[1];
    a.M = C;
    a.N = C;
    a.out = static_cast<float*>(part);
    if ((err = gemm90::launch<1, 1, true>(amap, bmap, amap, a, dw_gemm[0],
                                           n_chunks, dw_gemm[2], s)) != 0)
      return err;
    return gemm90::reduce_chunks(static_cast<const float*>(part),
                                 static_cast<float*>(dw), (long)C * C,
                                 n_chunks, s);
  }
  return 0;
}

}  // extern "C"
