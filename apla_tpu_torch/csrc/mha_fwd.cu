// Memory-efficient multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel apla_tpu/ops/pallas_mha.py:_fwd_kernel (called
// through _call_fwd from vmem_mha / _vmem_mha_padded).  Contract, that
// kernel's, per image and head, on the packed activations:
//
//   qkv [B, N, 3C] bf16 (as the frozen qkv matmul emits it; C = H * 64)
//   out [B, N, C]  bf16, head h at columns h*64 .. h*64+63:
//       out_h = bf16(bf16(softmax(mask(q_h k_h^T * scale))) v_h)
//
// with f32 scores, masked columns (past N; outside the row's segment of
// length seg when seg > 0) at weight exactly 0, p normalised in f32 and
// rounded to bf16 before p v, p v accumulated in f32 and rounded once.  The
// TPU kernel pads N to a multiple of 16 and masks the padding columns; here
// TMA zero-fills the rows past N of every box (the tensor map is 3-D,
// [B, N, 3C], so a box never reaches the next image), the scores of columns
// past N are -inf by index, and the store clips rows past N: the caller
// passes q, k, v as the qkv matmul wrote them, with no transpose and no
// padding copy.
//
// What bounds it on the H100: at the served shape (B=64, N=257, C=768) it
// reads qkv and writes out, 4 [B, N, C] bf16 tensors (101 MB, 0.030 ms at
// 3.35 TB/s), against 4 N^2 C FLOP per image (13.0 GFLOP, 0.013 ms): the
// bytes.  The TPU kernel holds a head's q, k and v in VMEM at once; the
// design below does the same per block, so each head's K and V cross from
// memory to the SM once per block.  What bounds this design instead is each
// warpgroup's chain per query tile: q k^T, then the softmax (one or two
// exp2 per score on the SM's 16-a-cycle special-function units, and about
// six other operations), then p v, then the store; two blocks share an SM,
// so one's softmax runs beside the other's products.
//
// Design:
//  * one warpgroup (128 threads) per block, 64 query rows at a time; a
//    block takes a run of work items, an item being (image, head, a group
//    of query tiles), laid out by the launch plan of ops/mha.py (fwd_plan):
//    at b64 one item per block covers all of a head's query tiles; at b1
//    and b8 the query tiles are split over blocks, which then read the
//    head's K and V again from L2; at N <= 64 a block runs through many
//    items with two K/V sets, loading the next head's while it computes.
//  * all loads are TMA boxes of 64 rows x 64 columns (128-byte swizzle)
//    issued by thread 0 and counted on mbarriers, one per tile, so the
//    first products start when the first key tile is in; the q tiles are
//    double buffered, so the next tile's copy overlaps this one's work.
//    (Persistent blocks of two consumer warpgroups fed by a producer warp,
//    or by a thread that polls, ran slower: with a third warpgroup the
//    compiler caps a thread at 168 registers and the score row spills, and
//    two warpgroups an SM is what two blocks already give.)
//  * products by wgmma: s = q k^T with q and k K-major in shared memory;
//    o += p v with p from registers (the f32 score accumulator, normalised,
//    rounded to bf16 and packed, is the A operand) and v MN-major in shared
//    memory, so p never goes through shared memory.
//  * "row" kernel, N <= 320 (five key tiles): the head's K and V stay
//    resident in shared memory and the whole score row of the 64 query
//    rows is held in registers (up to 5 x 32 f32 per thread), as the TPU
//    kernel holds the whole row in VMEM: the scores are computed once and
//    p = exp(s - max) / sum in f32 is rounded to bf16 where the TPU rounds
//    it.  The sum is taken as the two-pass kernel below takes it, tile by
//    tile against the running maximum, so that both kernels give the same
//    p, and the same output, to the last bit: a first-step training loss
//    at random weights moves by 1e-4 when p's last bits change (PERF.md
//    §6).  A tile whose running maximum is already the row's, for every
//    row of the warp, shares its exponentials with p; the others cost one
//    more each.  The last key tile is multiplied only as
//    wide as N needs (n = 16, 32, 48 or 64 columns; at N = 257 that is 16
//    of 64), and p v only over its k16 steps; a warp whose 16 rows all lie
//    past N skips the softmax.  One instantiation per (tiles, last width),
//    so every product is a straight run of wgmmas.
//  * "two-pass" kernel, N > 320: softmax in two passes over the key tiles:
//    pass 1 keeps each row's running max and sum, pass 2 recomputes the
//    scores and forms the normalised p, so p is rounded at the same point.
//    Key tiles go two to a group of wgmmas.  K and V stay resident when
//    all of the head's tiles fit (N <= 768), and pass 2 reuses what pass 1
//    brought in; longer N streams through a ring of K/V tiles, pass 1
//    loading only K.
//  * a row with no valid column keeps max -inf, its reference point is 0
//    and its p is 0, so exp(-inf - -inf) never occurs.  With seg > 0 the
//    two-pass kernel multiplies only the key tiles that meet a query
//    tile's segments; the row kernel multiplies the whole row and masks.
//  * the output tile is staged in shared memory (swizzled) and written by
//    one TMA store, which clips the rows past N.
//
// The two tensor maps are encoded on the host at every call (the pointers
// change; cuTensorMapEncodeTiled, found through the runtime), a host cost
// phase 7a times.

#include "attn_fwd_sm90.cuh"

namespace {

using namespace attn90;
typedef __nv_bfloat16 bf16;

constexpr int DH = 64;                  // head dim
constexpr int TILE_BYTES = BM * DH * 2; // 8 KB
constexpr int ROW_KT = 5;               // key tiles of the row kernel

// Shared memory (after aligning the base to 1024 bytes): two q tiles, the
// output tile, `slots` K/V slots (K then V, 16 KB each), then the barriers.
constexpr int Q_OFF = 0;
constexpr int O_OFF = 2 * TILE_BYTES;
constexpr int KV_OFF = 3 * TILE_BYTES;
constexpr int SLOT_BYTES = 2 * TILE_BYTES;

struct Plan {
  int B, N, H, C, seg;
  float scale_log2;
  int n_t;              // ceil(N / 64): query tiles = key tiles
  int q_tiles;          // query tiles per item
  int groups;           // items per (image, head)
  int items;            // B * H * groups
  int items_per_block;
  int kv_sets;          // row kernel: K/V sets (1, or 2 to prefetch)
  int slots;            // K/V slots in shared memory
  int resident;         // two-pass kernel: all key tiles resident
};

struct Item {
  int b, h, q0, q1;
};

__device__ __forceinline__ Item item_of(const Plan& p, int it) {
  Item r;
  const int grp = it % p.groups, bh = it / p.groups;
  r.h = bh % p.H;
  r.b = bh / p.H;
  r.q0 = grp * p.q_tiles;
  r.q1 = min(p.n_t, r.q0 + p.q_tiles);
  return r;
}

// key tiles [k0, k1) that some row of query tile qt can see
__device__ __forceinline__ void key_range(const Plan& p, int qt, int& k0,
                                          int& k1) {
  if (p.seg <= 0) {
    k0 = 0;
    k1 = p.n_t;
    return;
  }
  const int row0 = qt * BM, last = min(row0 + BM, p.N) - 1;
  k0 = ((row0 / p.seg) * p.seg) / BM;
  k1 = (min(p.N, (last / p.seg + 1) * p.seg) + BM - 1) / BM;
}

// valid key range [lo, hi) of row r
__device__ __forceinline__ void row_range(const Plan& p, int r, int& lo,
                                          int& hi) {
  if (p.seg <= 0) {
    lo = 0;
    hi = p.N;
  } else {
    lo = (r / p.seg) * p.seg;
    hi = min(p.N, lo + p.seg);
  }
}

// Scores of key tile kt to log2 units; -inf outside the row's range.
__device__ __forceinline__ void scale_mask(float (&s)[32], int kt, int t,
                                           float sl2, int lo0, int hi0,
                                           int lo1, int hi1) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = kt * BM + 8 * j + 2 * t + e;
      s[4 * j + e] = (col >= lo0 && col < hi0) ? s[4 * j + e] * sl2
                                               : -INFINITY;
      s[4 * j + 2 + e] = (col >= lo1 && col < hi1) ? s[4 * j + 2 + e] * sl2
                                                   : -INFINITY;
    }
}

// Stage the 64 x 64 output tile (swizzled, bf16) and store it with TMA;
// `tid` is the thread's index in its warpgroup, `bar` the warpgroup's named
// barrier.
__device__ __forceinline__ void store_tile(const float (&o)[32], uint8_t* ob,
                                           const CUtensorMap* omap, int h,
                                           int qt, int b, int tid, int bar) {
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  if (tid == 0) tma_store_wait_read();        // the previous tile's store
  named_sync(bar, NT);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(ob + swz128(r0, col)) =
        pack_bf16x2(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(ob + swz128(r0 + 8, col)) =
        pack_bf16x2(o[4 * j + 2], o[4 * j + 3]);
  }
  fence_proxy_async();
  named_sync(bar, NT);
  if (tid == 0) {
    tma_store_3d(omap, ob, h * DH, qt * BM, b);
    tma_store_commit();
  }
}

// Walks the query tiles of a run of items in order (thread 0's prefetch).
struct QCursor {
  int it, it1, qt, q1, b, h;
  __device__ void start(const Plan& p, int first, int end) {
    it = first;
    it1 = end;
    set(p);
  }
  __device__ void set(const Plan& p) {
    if (it < it1) {
      const Item r = item_of(p, it);
      qt = r.q0;
      q1 = r.q1;
      b = r.b;
      h = r.h;
    }
  }
  __device__ bool valid() const { return it < it1; }
  __device__ void next(const Plan& p) {
    if (++qt >= q1) {
      ++it;
      set(p);
    }
  }
};

// ---------------------------------------------------------------------------
// Row kernel: N in (64 (NKT - 1), 64 NKT], the last key tile TAILN wide
// (16, 32, 48 or 64 columns, N rounded up to 16); K/V resident, the score
// row in registers.  Every product is a straight run of wgmmas (no branch
// between them), so they pipeline.  With seg > 0 every key tile is
// multiplied and the mask zeroes what a row cannot see.  Thread 0 issues
// the loads: K then V of an item, a barrier per tile (the first products
// start when the first key tile is in), and the q tiles double buffered.
// Barriers: q[2], then K and V of each slot.
template <int NKT, int TAILN>
__global__ void __launch_bounds__(NT)
mha_row_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap omap, const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + KV_OFF +
                                               p.slots * SLOT_BYTES);
  uint64_t* kbar = qbar + 2;                  // [slot]
  uint64_t* vbar = kbar + p.slots;            // [slot]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int it0 = blockIdx.x * p.items_per_block;
  const int it1 = min(p.items, it0 + p.items_per_block);

  // K, then V, of item `it` into K/V set `set`, a barrier per tile
  auto load_kv = [&](int it, int set) {
    const Item r = item_of(p, it);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        const int slot = set * NKT + kt;
        uint64_t* bar = (w ? vbar : kbar) + slot;
        mbar_expect_tx(bar, TILE_BYTES);
        tma_load_3d(sm + KV_OFF + slot * SLOT_BYTES + w * TILE_BYTES, &qmap,
                    bar, (1 + w) * p.C + r.h * DH, kt * BM, r.b);
      }
  };

  QCursor cur;
  if (tid == 0) {
    for (int i = 0; i < 2 + 2 * p.slots; ++i) mbar_init(qbar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    cur.start(p, it0, it1);
    load_q<DH>(sm, qbar, &qmap, cur.h, cur.qt, cur.b, 0);
    cur.next(p);
    load_kv(it0, 0);
    if (cur.valid()) {
      load_q<DH>(sm, qbar, &qmap, cur.h, cur.qt, cur.b, 1);
      cur.next(p);
    }
    if (p.kv_sets == 2 && it0 + 1 < it1) load_kv(it0 + 1, 1);
  }
  const float sl2 = p.scale_log2;
  const bool tail_masked = (NKT - 1) * BM + TAILN != p.N;

  int u = 0;                                  // query tiles done
  for (int it = it0; it < it1; ++it) {
    const int j = it - it0;
    const int set = p.kv_sets == 2 ? (j & 1) : 0;
    const uint32_t kv_parity = (p.kv_sets == 2 ? (j >> 1) : j) & 1;
    if (j > 0 && tid == 0) {
      // the previous item's tiles are done (its last store staged after
      // every thread's final wgmma wait)
      if (p.kv_sets == 1) load_kv(it, 0);
      else if (it + 1 < it1) load_kv(it + 1, (j + 1) & 1);
    }
    const Item r = item_of(p, it);
    const uint8_t* kv = sm + KV_OFF + set * NKT * SLOT_BYTES;
    for (int qt = r.q0; qt < r.q1; ++qt, ++u) {
      const int buf = u & 1;
      const int r_lo = qt * BM + warp * 16 + g, r_hi = r_lo + 8;
      int lo0, hi0, lo1, hi1;
      row_range(p, r_lo, lo0, hi0);
      row_range(p, r_hi, lo1, hi1);

      // s = q k^T for every key tile, one group of wgmmas
      float s[NKT][32];
      mbar_wait(qbar + buf, (u >> 1) & 1);
      const uint64_t dq = desc_kmajor(sm + Q_OFF + buf * TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NKT; ++i) {
        mbar_wait(kbar + set * NKT + i, kv_parity);
        const uint64_t dk = desc_kmajor(kv + i * SLOT_BYTES);
        if (i == NKT - 1) scores_n<DH, TAILN>(s[i], dq, dk);
        else scores_n<DH, 64>(s[i], dq, dk);
      }
      wgmma_commit();
      wgmma_wait0();
      if (tid == 0 && cur.valid()) {          // q buffer free: prefetch
        load_q<DH>(sm, qbar, &qmap, cur.h, cur.qt, cur.b, buf);
        cur.next(p);
      }

      // softmax over the whole row, in log2 units; a warp whose 16 rows
      // all lie past N only weighs nothing
      uint32_t pa[NKT][4][4];
      if (qt * BM + warp * 16 < p.N) {
        // scores to log2 units, each tile's row maxima, the row maximum
        float tm0[NKT], tm1[NKT];
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < NKT; ++i) {
          const int wd = i == NKT - 1 ? TAILN : 64;
          if (p.seg > 0 || (i == NKT - 1 && tail_masked)) {
            scale_mask(s[i], i, t, sl2, lo0, hi0, lo1, hi1);
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (e < wd / 2) s[i][e] *= sl2;
          }
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int j2 = 0; j2 < 8; ++j2)
            if (j2 < wd / 8) {
              mx0 = fmaxf(mx0, fmaxf(s[i][4 * j2], s[i][4 * j2 + 1]));
              mx1 = fmaxf(mx1, fmaxf(s[i][4 * j2 + 2], s[i][4 * j2 + 3]));
            }
          tm0[i] = quad_max(mx0);
          tm1[i] = quad_max(mx1);
          m0 = fmaxf(m0, tm0[i]);
          m1 = fmaxf(m1, tm1[i]);
        }
        const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
        const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
        // The sum as the two-pass kernels take it, tile by tile against
        // the running maximum r: l = l * 2^(r_old - r) + sum 2^(s - r),
        // so p = 2^(s - max) / l is the same number to the last bit.  Once
        // r is the row maximum for every row of the warp, 2^(s - r) is the
        // numerator of p itself and is computed once.
        float l0 = 0.0f, l1 = 0.0f, r0 = -INFINITY, r1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < NKT; ++i) {
          const int wd = i == NKT - 1 ? TAILN : 64;
          const float mn0 = fmaxf(r0, tm0[i]), mn1 = fmaxf(r1, tm1[i]);
          const float rf0 = (mn0 == -INFINITY) ? 0.0f : mn0;
          const float rf1 = (mn1 == -INFINITY) ? 0.0f : mn1;
          float sum0 = 0.0f, sum1 = 0.0f;
          if (__all_sync(0xffffffffu, rf0 == ref0 && rf1 == ref1)) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (e < wd / 2)
                s[i][e] = ex2(s[i][e] - ((e & 2) ? ref1 : ref0));
#pragma unroll
            for (int j2 = 0; j2 < 8; ++j2)
              if (j2 < wd / 8) {
                sum0 += s[i][4 * j2] + s[i][4 * j2 + 1];
                sum1 += s[i][4 * j2 + 2] + s[i][4 * j2 + 3];
              }
          } else {
#pragma unroll
            for (int j2 = 0; j2 < 8; ++j2)
              if (j2 < wd / 8) {
                sum0 += ex2(s[i][4 * j2] - rf0)
                        + ex2(s[i][4 * j2 + 1] - rf0);
                sum1 += ex2(s[i][4 * j2 + 2] - rf1)
                        + ex2(s[i][4 * j2 + 3] - rf1);
              }
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (e < wd / 2)
                s[i][e] = ex2(s[i][e] - ((e & 2) ? ref1 : ref0));
          }
          l0 = l0 * ex2(r0 - rf0) + quad_sum(sum0);
          l1 = l1 * ex2(r1 - rf1) + quad_sum(sum1);
          r0 = mn0;
          r1 = mn1;
        }
        const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
        const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
        // p = exp2(s - ref) / sum, rounded to bf16: the A operand of p v
#pragma unroll
        for (int i = 0; i < NKT; ++i) {
          const int wd = i == NKT - 1 ? TAILN : 64;
#pragma unroll
          for (int e = 0; e < 32; ++e)
            if (e < wd / 2) s[i][e] *= (e & 2) ? inv1 : inv0;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < wd / 16) acc_to_a(s[i], kk, pa[i][kk]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < NKT; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            pa[i][kk][0] = pa[i][kk][1] = pa[i][kk][2] = pa[i][kk][3] = 0u;
      }
      // o = bf16(p) v, one group of wgmmas
      float o[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) o[e] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NKT; ++i) {
        const int wd = i == NKT - 1 ? TAILN : 64;
        mbar_wait(vbar + set * NKT + i, kv_parity);
        const bf16* vs =
            reinterpret_cast<const bf16*>(kv + i * SLOT_BYTES + TILE_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < wd / 16)
            wgmma_rs64(o, pa[i][kk], desc_mnmajor(vs + kk * 16 * DH));
      }
      wgmma_commit();
      wgmma_wait0();
      store_tile(o, sm + O_OFF, &omap, r.h, qt, r.b, tid, 1);
    }
  }
  if (tid == 0) tma_store_wait_all();
}

// ---------------------------------------------------------------------------
// Two-pass kernel: any N; one item per block; key tiles taken two at a time
// (one group of wgmmas; an odd last tile is paired with itself and its
// second copy weighs nothing).  Resident: every key tile of the item in
// slot kt, K and V each behind their own barrier.  Streamed: a ring of
// `slots` stages over the sequence of uses (per query tile: pass 1 K tiles
// k0..k1-1, then pass 2 K and V tiles), refilled by thread 0 as stages free
// up.  Barriers: q[2], then K[slots] and V[slots] (resident) or one per
// ring stage.
struct UseCursor {         // thread 0's position in the streamed sequence
  int qt, q1, pass, kt, k1;
  __device__ void start(const Plan& p, int q0, int q_end) {
    qt = q0;
    q1 = q_end;
    pass = 0;
    key_range(p, qt, kt, k1);
  }
  __device__ bool valid() const { return qt < q1; }
  __device__ void next(const Plan& p) {
    if (++kt < k1) return;
    if (pass == 0) {
      pass = 1;
      int k1x;
      key_range(p, qt, kt, k1x);
      return;
    }
    pass = 0;
    if (++qt < q1) key_range(p, qt, kt, k1);
  }
};

// p = exp2(s - ref) * inv, rounded to bf16 and packed as the A operand
// (zero when !live)
__device__ __forceinline__ void p_operand(float (&s)[32], float ref0,
                                          float ref1, float inv0, float inv1,
                                          bool live, uint32_t (&pa)[4][4]) {
  if (!live) {
    inv0 = 0.0f;
    inv1 = 0.0f;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e)
    s[e] = ex2(s[e] - ((e & 2) ? ref1 : ref0)) * ((e & 2) ? inv1 : inv0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, pa[kk]);
}

__global__ void __launch_bounds__(NT)
mha_two_pass_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap omap, const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + KV_OFF +
                                               p.slots * SLOT_BYTES);
  uint64_t* kbar = qbar + 2;                  // [slot], or [ring stage]
  uint64_t* vbar = kbar + p.slots;            // [slot] (resident)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Item r = item_of(p, blockIdx.x);
  const int D = p.slots;
  const float sl2 = p.scale_log2;

  UseCursor uc = {};
  auto issue_use = [&](int use) {             // thread 0: uc's use
    const int st = use % D;
    uint8_t* slot = sm + KV_OFF + st * SLOT_BYTES;
    mbar_expect_tx(kbar + st, uc.pass ? SLOT_BYTES : TILE_BYTES);
    tma_load_3d(slot, &qmap, kbar + st, p.C + r.h * DH, uc.kt * BM, r.b);
    if (uc.pass)
      tma_load_3d(slot + TILE_BYTES, &qmap, kbar + st, 2 * p.C + r.h * DH,
                  uc.kt * BM, r.b);
    uc.next(p);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 + 2 * p.slots; ++i) mbar_init(qbar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  QCursor qc;
  int issued = 0;
  if (tid == 0) {
    qc.start(p, blockIdx.x, blockIdx.x + 1);
    for (int buf = 0; buf < 2 && qc.valid(); ++buf) {
      load_q<DH>(sm, qbar, &qmap, qc.h, qc.qt, qc.b, buf);
      qc.next(p);
    }
    if (p.resident) {
      int k0, k1, kx;
      key_range(p, r.q0, k0, kx);
      key_range(p, r.q1 - 1, kx, k1);
      for (int w = 0; w < 2; ++w)
        for (int kt = k0; kt < k1; ++kt) {
          uint64_t* bar = (w ? vbar : kbar) + kt;
          mbar_expect_tx(bar, TILE_BYTES);
          tma_load_3d(sm + KV_OFF + kt * SLOT_BYTES + w * TILE_BYTES, &qmap,
                      bar, (1 + w) * p.C + r.h * DH, kt * BM, r.b);
        }
    } else {
      uc.start(p, r.q0, r.q1);
      for (; issued < D && uc.valid(); ++issued) issue_use(issued);
    }
  }

  int use = 0;                                // streamed uses consumed
  // the K/V slot of key tile kt, the i-th use from here, its K waited for
  auto acquire = [&](int kt, int i) -> const uint8_t* {
    if (p.resident) {
      mbar_wait(kbar + kt, 0);
      return sm + KV_OFF + kt * SLOT_BYTES;
    }
    const int c = use + i, st = c % D;
    mbar_wait(kbar + st, (c / D) & 1);
    return sm + KV_OFF + st * SLOT_BYTES;
  };
  auto release = [&](int n) {                 // after the uses' wgmmas
    if (p.resident) return;
    use += n;
    named_sync(2, NT);
    if (tid == 0)
      for (int i = 0; i < n && uc.valid(); ++i) issue_use(issued++);
  };

  int u = 0;
  for (int qt = r.q0; qt < r.q1; ++qt, ++u) {
    const int buf = u & 1;
    mbar_wait(qbar + buf, (u >> 1) & 1);
    const uint64_t dq = desc_kmajor(sm + Q_OFF + buf * TILE_BYTES);
    int k0, k1;
    key_range(p, qt, k0, k1);
    const int r_lo = qt * BM + warp * 16 + g, r_hi = r_lo + 8;
    int lo0, hi0, lo1, hi1;
    row_range(p, r_lo, lo0, hi0);
    row_range(p, r_hi, lo1, hi1);

    // pass 1: running max and sum per row (log2 units)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int kt = k0; kt < k1; kt += 2) {
      const bool two = kt + 1 < k1;
      const uint8_t* sa = acquire(kt, 0);
      const uint8_t* sb = two ? acquire(kt + 1, 1) : sa;
      float s[2][32];
      wgmma_fence();
      scores_n<DH, 64>(s[0], dq, desc_kmajor(sa));
      scores_n<DH, 64>(s[1], dq, desc_kmajor(sb));
      wgmma_commit();
      wgmma_wait0();
      release(two ? 2 : 1);
      scale_mask(s[0], kt, t, sl2, lo0, hi0, lo1, hi1);
      online_stats<true>(s[0], m0, m1, l0, l1);
      if (two) {
        scale_mask(s[1], kt + 1, t, sl2, lo0, hi0, lo1, hi1);
        online_stats<true>(s[1], m0, m1, l0, l1);
      }
    }

    // pass 2: p = exp(s - max) / sum in bf16, o += p v
    const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
    const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.0f;
    for (int kt = k0; kt < k1; kt += 2) {
      const bool two = kt + 1 < k1;
      const uint8_t* sa = acquire(kt, 0);
      const uint8_t* sb = two ? acquire(kt + 1, 1) : sa;
      float s[2][32];
      wgmma_fence();
      scores_n<DH, 64>(s[0], dq, desc_kmajor(sa));
      scores_n<DH, 64>(s[1], dq, desc_kmajor(sb));
      wgmma_commit();
      wgmma_wait0();
      uint32_t pa[2][4][4];
      scale_mask(s[0], kt, t, sl2, lo0, hi0, lo1, hi1);
      p_operand(s[0], ref0, ref1, inv0, inv1, true, pa[0]);
      scale_mask(s[1], kt + 1, t, sl2, lo0, hi0, lo1, hi1);
      p_operand(s[1], ref0, ref1, inv0, inv1, two, pa[1]);
      if (p.resident) {
        mbar_wait(vbar + kt, 0);
        if (two) mbar_wait(vbar + kt + 1, 0);
      }
      const bf16* va = reinterpret_cast<const bf16*>(sa + TILE_BYTES);
      const bf16* vb = reinterpret_cast<const bf16*>(sb + TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs64(o, pa[0][kk], desc_mnmajor(va + kk * 16 * DH));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs64(o, pa[1][kk], desc_mnmajor(vb + kk * 16 * DH));
      wgmma_commit();
      wgmma_wait0();
      release(two ? 2 : 1);
    }
    if (tid == 0 && qc.valid()) {             // q buffer free: prefetch
      load_q<DH>(sm, qbar, &qmap, qc.h, qc.qt, qc.b, buf);
      qc.next(p);
    }
    store_tile(o, sm + O_OFF, &omap, r.h, qt, r.b, tid, 1);
  }
  if (tid == 0) tma_store_wait_all();
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, Plan);

// The row kernels, [NKT - 1][TAILN / 16 - 1]
template <int NKT>
Kernel row_kernel(int tail) {
  return tail == 1 ? mha_row_kernel<NKT, 16>
         : tail == 2 ? mha_row_kernel<NKT, 32>
         : tail == 3 ? mha_row_kernel<NKT, 48>
                     : mha_row_kernel<NKT, 64>;
}

Kernel row_kernel_for(int N) {
  static const Kernel table[ROW_KT][4] = {
#define ROWS(n) {row_kernel<n>(1), row_kernel<n>(2), row_kernel<n>(3), \
                 row_kernel<n>(4)}
      ROWS(1), ROWS(2), ROWS(3), ROWS(4), ROWS(5)
#undef ROWS
  };
  const int nkt = (N + BM - 1) / BM;
  const int tail = ((N - (nkt - 1) * BM) + 15) / 16;
  return table[nkt - 1][tail - 1];
}

}  // namespace

extern "C" {

// Opt the kernels in to the device's per-block shared memory limit on the
// current device, `device`; returns that limit in bytes, or -1.  Called once
// per device, before the first launch there.
int mha_fwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  for (int n = 1; n <= ROW_KT * BM; n += 16)
    if (set_smem(row_kernel_for(n), v)) return -1;
  if (set_smem(mha_two_pass_kernel, v)) return -1;
  return v;
}

// One launch on `stream` with the plan of ops/mha.py:fwd_plan: `two_pass`
// 0 the row kernel (N <= 320), 1 the two-pass kernel; returns 0 when
// queued, a cudaError_t of the launch, or 1000 + the CUresult of a tensor
// map that could not be encoded.  The caller checks shapes: C == H * 64,
// 16-byte aligned contiguous tensors, the plan's shared memory within the
// device's limit.
int mha_fwd(const void* qkv, void* out, int B, int N, int C, int H,
            float scale, int seg, int two_pass, int q_tiles,
            int items_per_block, int kv_sets, int slots, int resident,
            int smem_bytes, void* stream) {
  CUtensorMap qmap, omap;
  int err = encode_bf16_3d(&qmap, qkv, 3ull * C, N, B, 6ull * C,
                           6ull * C * N, BM);
  if (err == 0)
    err = encode_bf16_3d(&omap, out, C, N, B, 2ull * C, 2ull * C * N, BM);
  if (err != 0) return 1000 + err;
  Plan p;
  p.B = B;
  p.N = N;
  p.H = H;
  p.C = C;
  p.seg = seg;
  p.scale_log2 = scale * LOG2E;
  p.n_t = (N + BM - 1) / BM;
  p.q_tiles = q_tiles;
  p.groups = (p.n_t + q_tiles - 1) / q_tiles;
  p.items = B * H * p.groups;
  p.items_per_block = items_per_block;
  p.kv_sets = kv_sets;
  p.slots = slots;
  p.resident = resident;
  const int blocks = (p.items + items_per_block - 1) / items_per_block;
  const Kernel k = two_pass ? mha_two_pass_kernel : row_kernel_for(N);
  k<<<blocks, NT, smem_bytes, (cudaStream_t)stream>>>(qmap, omap, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
