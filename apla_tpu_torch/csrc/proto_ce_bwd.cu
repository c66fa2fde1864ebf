// Prototype cross-entropy backward for Hopper (sm_90a): the gradients of
// proto_ce_fwd.cu's ce with respect to the student rows and the student
// prototype layer, recomputing the logits from the saved row statistics.
//
// Replaces the TPU kernels apla_tpu/ops/pallas_proto_ce.py:_dxs_kernel and
// _dws_kernel (both called through _proto_ce_bwd).  Contract, theirs:
//
//   the forward's inputs, lse_s, lse_t [R] f32 and the cotangent g [R] f32
//   p_s = exp(s - lse_s),  p_t = exp(t - lse_t)   (logits recomputed in f32)
//   ds  = bf16(g (p_s - p_t) / tau_s)             [R, K], never stored whole
//   dxs = ds ws^T                                  [R, D] f32
//   dws = xs^T ds                                  [D, K] f32
//
// with columns at or past K giving p = 0 and rows at or past R nothing.
// A row whose g / tau_s is 0 gets ds = 0 whatever its exponentials give:
// past R its lse are placeholders, and 0 * inf would put a NaN into dws.
// The teacher side (xt, wt, c, tau_t) gets no gradient.  D is 256.
//
// What bounds them on the H100: each recomputes both logit blocks (4 R D K
// FLOP) and takes one more product (2 R D K), so 6 R D K = 1.65e12 FLOP at
// the iBOT site (R = 16384, K = 65536): >= 1.67 ms each at 989 TFLOP/s;
// the weights are 2 x 33.5 MB, so the tensor cores bound both.  Each also
// takes 2 R K exp2f, about a third of that time on the SMs' special
// function units, which has to overlap the products.  Measured on the H100
// (PERF.md §6): the 32-wide logit products (wgmma m64n32, A re-read from
// shared memory for every 32 columns) run well below the tensor cores'
// rate, and a warpgroup's tile is a chain (products, then its ds), so two
// warpgroups a block overlap each other's chains; 32 columns are what the
// registers allow beside the [64, 256] f32 accumulator, and shared memory
// holds three such stages beside the resident tiles.
//
// Design: the attention backward's two sides at "head dim" 256 with two
// logit sets and no row reduction (the lse are saved).  A block is one
// producer warpgroup (one thread issues the loads; with two consumers it
// gives up its registers to them by setmaxnreg) and `groups` (1 or 2)
// consumer warpgroups; each warpgroup owns a 64-wide tile of its side
// (warpgroup w of block b: tile b + w * blocks_x, so that the rows with
// g != 0, which the collate puts first, spread over the blocks), the block
// streams the other side in 32-wide tiles through a TMA ring of `stages`,
// and each tile's ds stays in registers as the A operand of the product:
//  * dxs (the query side): a warpgroup's xs and xt rows stay resident
//    ([64, 256] each, four 64-column boxes, 128-byte swizzle); ws and wt
//    stream as [256, 32] boxes (64-byte swizzle).  s = xs ws and t = xt wt
//    are wgmma m64n32 (A K-major, B MN-major), ds [64, 32] is formed in
//    registers, dxs += ds ws^T is wgmma m64n256 with ds as the register A
//    and the same ws box read K-major.  A warpgroup whose 64 rows all have
//    g = 0 writes zeros and takes no tile.
//  * dws (the key side), as its transpose: dws^T [64 columns, 256] += ds^T
//    xs.  A warpgroup's ws and wt columns stay resident ([256, 64] boxes,
//    read MN-major as the A of s^T = ws^T xs^T); xs and xt stream as four
//    [32, 64] boxes each (read K-major for the logits, MN-major for the
//    product).  A row tile whose 32 rows all have g = 0 is skipped by the
//    producer (no load) and the consumers (no product); its ds are 0, so
//    the sums are those of the tiles taken, to the bit.
//  * the producer warp also writes each stage's side data beside it (dxs:
//    the tile's 32 centers; dws: its rows' lse and g / tau_s), so the
//    consumers read them from shared memory and not by global loads in
//    the chain of each tile.
//  * each warpgroup issues tile i's product and tile i + 1's logits as one
//    group of wgmmas, then forms tile i + 1's ds while the other
//    warpgroup's products run; every stage is released once both
//    warpgroups' products that read it have retired.  (Turns enforced by
//    named barriers, FlashAttention 3's ping-pong, and the product issued
//    among the logits instead of before them each ran slower on the H100.)
//  * when one side gives too few blocks, the other side's range is split
//    into partials at split_work's 64-wide boundaries (ops/proto_ce.py:
//    proto_bwd_plan), summed in a fixed order by sum_partials_kernel: no
//    atomics, so reruns are bit-equal.
//
// Bits: the values of the mma.sync kernels these replace.  Each
// logit is a D = 256 contraction in increasing k16 order, the first step
// overwriting the accumulator (what adding it to +0 gives, but for the
// sign of a zero, which no later step reads: s * ks and exp2f see the
// same value); s * ks, (t - c) * kt and -inf past K behind the same
// select, then ds = gs * (exp2f(s - ls2) - exp2f(t - lt2)) as the same
// source expression; dxs sums over K and dws over R in one f32
// accumulator each with k16 steps in increasing order (a wgmma
// accumulator gives each thread an mma.sync fragment's rows and columns,
// sm90_async.cuh), the first step overwriting it and +0 added at the end,
// as a sum started from +0 gives; partials at the same boundaries.
// Skipped work contributes +-0 terms only, so a dws or dxs value can
// differ from the earlier kernel's in the sign of a zero at most.

#include "proto_ce_sm90.cuh"

namespace {

using namespace proto;

constexpr int OWN_BYTES = OWN * D * 2;     // 32 KB: one x or w own tile
constexpr int BOX_X = OWN * 64 * 2;        // dxs: an own box [64, 64]
constexpr int BOX_XS = BT * 64 * 2;        // dws: a streamed box [32, 64]
constexpr int STAT_BYTES = BT * 16;        // a stage's side data
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* c;
  const float* lse_s;
  const float* lse_t;
  const float* g;
  float* out;                 // [splits][R][D] or [splits][D][K]
  int R, K;
  int per;                    // 64-wide units of the loop a split
  int blocks_x, stages;
  float ks, kt, inv_ts;       // log2(e) / tau_s, log2(e) / tau_t, 1 / tau_s
};

// Shared memory after aligning the base to 1024 bytes: the own tiles
// (x or w: per warpgroup the s tile, then the t tile), the ring's stages,
// the stages' side data (dxs: the tile's 32 centers; dws: per row {lse_s,
// lse_t} in log2 units and g / tau_s), then the barriers: resident,
// full[stages], empty[stages].
__host__ __device__ constexpr int smem_bytes(int groups, int stages) {
  return 1024 + groups * 2 * OWN_BYTES + stages * (STAGE_BYTES + STAT_BYTES)
         + 256;
}

// gs = g / tau_s of `row` (0 at or past R), as the products read it.
__device__ __forceinline__ float row_gs(const Args& a, int row) {
  return row < a.R ? __ldg(a.g + row) * a.inv_ts : 0.f;
}

// The scaled logits and ds of one fragment value (the expressions of the
// mma.sync kernels' scale_logits and store_ds): s, t the raw logits, cv
// the column's center, ok whether the column is inside K, ls2 / lt2 the
// row's lse in log2 units, gs its g / tau_s.  Both exponentials are taken
// for every value and the row's gs chooses
// by a select the compiler cannot turn into a branch: a branch around each
// value's exponentials serialised the 32 values of a thread (their chains
// of MUFU latency no longer interleaved).  The select keeps whatever the
// unused side holds (an overflow or NaN of a placeholder lse) out of ds.
__device__ __forceinline__ float ds_of(float s, float t, float cv, bool ok,
                                       float ls2, float lt2, float gs,
                                       float ks, float kt) {
  s = ok ? s * ks : -INFINITY;
  t = ok ? (t - cv) * kt : -INFINITY;
  const float e = gs * (exp2f(s - ls2) - exp2f(t - lt2));  // 0 past K
  float d;
  asm("{\n .reg .pred p;\n setp.neu.f32 p, %2, 0f00000000;\n"
      " selp.f32 %0, %1, 0f00000000, p;\n}\n"
      : "=f"(d) : "f"(e), "f"(gs));
  return d;
}

// `d` as a value the compiler cannot see through: the resident tiles'
// descriptors are then formed next to each tile's wgmmas, base + an
// immediate, instead of 32 loop-invariant 64-bit values held in registers
// for the whole loop (which spilled).
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// The first k16 step overwrote the accumulator (a zeroed one, written by
// ordinary instructions, makes ptxas serialise the wgmmas); adding +0 at
// the end gives what a sum started from +0 gives, -0 included.
__device__ __forceinline__ void add_zero(float (&acc)[128]) {
#pragma unroll
  for (int e = 0; e < 128; ++e) {
    asm volatile("" : "+f"(acc[e])::"memory");
    acc[e] += 0.0f;
  }
}

// ---- dxs -------------------------------------------------------------------

// s = xs ws, t = xt wt over the 256 columns of D for the warpgroup's 64
// rows x the stage's 32 columns (xs, xt: four K-major [64, 64] boxes;
// the stage: ws then wt, [256, 32] MN-major)
__device__ __forceinline__ void dxs_logits(float (&s)[16], float (&t)[16],
                                           const uint8_t* xs,
                                           const uint8_t* xt,
                                           const uint8_t* stage) {
  // descriptor units are 16 bytes
  const uint64_t ds_ = opaque(desc_kmajor(xs)), dt_ = opaque(desc_kmajor(xt));
  const uint64_t bs = desc_mnmajor64(stage);
  const uint64_t bt = desc_mnmajor64(stage + HALF_STAGE);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {   // the two chains interleaved
    wgmma_ss_t<32, 0, 1>(s, ds_ + (kk >> 2) * (BOX_X >> 4) + 2 * (kk & 3),
                         bs + kk * (16 * BT * 2 >> 4), kk > 0);
    wgmma_ss_t<32, 0, 1>(t, dt_ + (kk >> 2) * (BOX_X >> 4) + 2 * (kk & 3),
                         bt + kk * (16 * BT * 2 >> 4), kk > 0);
  }
}

// xsmap, xtmap: [R, 256] bf16, boxes {64, 64}; wsmap, wtmap: [256, K] bf16,
// boxes {32, 256} with the 64-byte swizzle.  Blocks: x over the row tiles
// (warpgroup w: tile blockIdx.x + w * blocks_x), y over the splits of K.
template <int WG>
__global__ void __launch_bounds__((WG + 1) * WG_THREADS, 1)
proto_ce_dxs_kernel(const __grid_constant__ CUtensorMap xsmap,
                    const __grid_constant__ CUtensorMap xtmap,
                    const __grid_constant__ CUtensorMap wsmap,
                    const __grid_constant__ CUtensorMap wtmap,
                    const Args a) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint8_t* ring = sm + WG * 2 * OWN_BYTES;
  float* cen = reinterpret_cast<float*>(ring + a.stages * STAGE_BYTES);
  uint64_t* rbar = reinterpret_cast<uint64_t*>(
      ring + a.stages * (STAGE_BYTES + STAT_BYTES));
  uint64_t* full = rbar + 1;
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid / WG_THREADS;
  const int n_rt = (a.R + OWN - 1) / OWN;
  const int c_begin = blockIdx.y * a.per * UNIT;
  const int n = (min(a.K, c_begin + a.per * UNIT) - c_begin + BT - 1) / BT;
  float* out = a.out + (long)blockIdx.y * a.R * D;

  // warpgroups whose rows exist and have a g != 0
  int live = 0;
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    const int tile = blockIdx.x + w * a.blocks_x;
    if (tile >= n_rt) continue;
    const bool any = row_gs(a, tile * OWN + lane) != 0.f
                     || row_gs(a, tile * OWN + 32 + lane) != 0.f;
    if (__any_sync(FULL, any)) live |= 1 << w;
  }
  if (wg < WG && !(live >> wg & 1)) {     // all g = 0: dxs = +0
    const int tile = blockIdx.x + wg * a.blocks_x;
    if (tile < n_rt)
      for (int i = tid % WG_THREADS; i < OWN * D / 4; i += WG_THREADS) {
        const int row = tile * OWN + i / (D / 4);
        if (row < a.R)
          reinterpret_cast<float4*>(out + (long)row * D)[i % (D / 4)] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
  }
  if (live == 0) return;
  const int n_live = __popc(live);

  if (tid == 0) {
    mbar_init(rbar, 1);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 32);            // the producer warp's lanes
      mbar_init(empty + s, 4 * n_live);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WG) {                         // the producer warpgroup
    producer_regs<WG>();
    if (tid % WG_THREADS >= 32) return;   // its first warp fills the ring
    if (lane == 0) {
      mbar_expect_tx(rbar, n_live * 2 * OWN_BYTES);
      for (int w = 0; w < WG; ++w) {
        if (!(live >> w & 1)) continue;
        const int row0 = (blockIdx.x + w * a.blocks_x) * OWN;
        uint8_t* own = sm + w * 2 * OWN_BYTES;
        for (int j = 0; j < D / 64; ++j) {
          tma_load_3d(own + j * BOX_X, &xsmap, rbar, 64 * j, row0, 0);
          tma_load_3d(own + OWN_BYTES + j * BOX_X, &xtmap, rbar, 64 * j,
                      row0, 0);
        }
      }
    }
    stream_w(ring, cen, full, empty, &wsmap, &wtmap, a.c, a.K, c_begin, n,
             a.stages, lane);
    return;
  }
  consumer_regs<WG>();
  if (!(live >> wg & 1)) return;

  const int warp = (tid % WG_THREADS) >> 5, g = lane >> 2, t = lane & 3;
  const int r_lo = (blockIdx.x + wg * a.blocks_x) * OWN + warp * 16 + g;
  float ls2[2], lt2[2], gs[2];            // rows r_lo, r_lo + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    const bool ok = row < a.R;
    ls2[r] = ok ? __ldg(a.lse_s + row) * LOG2E : 0.f;
    lt2[r] = ok ? __ldg(a.lse_t + row) * LOG2E : 0.f;
    gs[r] = row_gs(a, row);
  }
  const uint8_t* xs = sm + wg * 2 * OWN_BYTES;
  const uint8_t* xt = xs + OWN_BYTES;

  float acc[128], s[16], tv[16];
  mbar_wait(rbar, 0);
  mbar_wait(full, 0);
  wgmma_fence();
  dxs_logits(s, tv, xs, xt, ring);
  wgmma_commit();
  wgmma_wait0();
  Ring r = {0, 0};                        // tile i's slot
  for (int i = 0; i < n; ++i) {
    const uint8_t* stage = ring + r.slot * STAGE_BYTES;
    const float* cs = cen + r.slot * BT;
    const int st = r.slot;
    r.next(a.stages);
    const int col0 = c_begin + BT * i + 2 * t;
    // ds of tile i in place of s: s[4j + e] is row r_lo (e < 2) or
    // r_lo + 8, column col0 + 8j + (e & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 cv = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[4 * j + e] = ds_of(s[4 * j + e], tv[4 * j + e],
                             (e & 1) ? cv.y : cv.x,
                             col0 + 8 * j + (e & 1) < a.K, ls2[r], lt2[r],
                             gs[r], a.ks, a.kt);
      }
    }
    uint32_t dsa[2][4];
    acc_to_a(s, 0, dsa[0]);
    acc_to_a(s, 1, dsa[1]);
    // dxs[rows, d] += sum_k ds[rows, k] ws[d, k]: the ws box read K-major
    const uint64_t db = desc_kmajor64(stage);
    auto product = [&](int kk) {
      wgmma_rs256<0>(acc, dsa[kk], db + 2 * kk, i > 0 || kk > 0);
    };
    wgmma_fence();
    product(0);
    product(1);
    if (i + 1 < n) {                      // tile i + 1's logits, same group
      mbar_wait(full + r.slot, r.phase);
      dxs_logits(s, tv, xs, xt, ring + r.slot * STAGE_BYTES);
    }
    wgmma_commit();
    wgmma_wait0();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  add_zero(acc);

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r_lo < a.R)
      *reinterpret_cast<float2*>(out + (long)r_lo * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r_lo + 8 < a.R)
      *reinterpret_cast<float2*>(out + (long)(r_lo + 8) * D + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- dws -------------------------------------------------------------------

// Lane l's g / tau_s in row tile i of the chunk (tile i at rows r_begin +
// 32 i; 0 past the chunk's n tiles).
__device__ __forceinline__ float peek_gs(const Args& a, int i, int n,
                                         int r_begin, int lane) {
  return i < n ? row_gs(a, r_begin + i * BT + lane) : 0.f;
}

// The first row tile at or after tile i with a row whose g / tau_s is not
// 0, or n; gi is the lane's peek_gs of tile i, read ahead of the call.
// Every warp of the block walks the same sequence.  Past a dead tile, 32
// tiles a step (lane l reads tile i + l's rows).
__device__ __forceinline__ int next_live(const Args& a, int i, int n,
                                         int r_begin, int lane, float gi) {
  if (i >= n) return n;
  if (__any_sync(FULL, gi != 0.f)) return i;
  for (i = i + 1; i < n; i += 32) {
    bool any = false;
    if (i + lane < n) {
      const int row0 = r_begin + (i + lane) * BT;
      const int cnt = min(BT, a.R - row0);
#pragma unroll 8
      for (int q = 0; q < cnt; ++q)
        any |= __ldg(a.g + row0 + q) * a.inv_ts != 0.f;
    }
    const unsigned m = __ballot_sync(FULL, any);
    if (m) return i + __ffs(m) - 1;
  }
  return n;
}

// s^T = ws^T xs^T, t^T = wt^T xt^T for the warpgroup's 64 columns x the
// stage's 32 rows (ws, wt: [256, 64] MN-major; the stage: xs, then xt,
// four K-major [32, 64] boxes each)
__device__ __forceinline__ void dws_logits(float (&s)[16], float (&t)[16],
                                           const uint8_t* ws,
                                           const uint8_t* wt,
                                           const uint8_t* stage) {
  // descriptor units are 16 bytes
  const uint64_t as = opaque(desc_mnmajor(ws)), at = opaque(desc_mnmajor(wt));
  const uint64_t bs = desc_kmajor(stage);
  const uint64_t bt = desc_kmajor(stage + HALF_STAGE);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {   // the two chains interleaved
    wgmma_ss_t<32, 1, 0>(s, as + kk * (16 * 128 >> 4),
                         bs + (kk >> 2) * (BOX_XS >> 4) + 2 * (kk & 3),
                         kk > 0);
    wgmma_ss_t<32, 1, 0>(t, at + kk * (16 * 128 >> 4),
                         bt + (kk >> 2) * (BOX_XS >> 4) + 2 * (kk & 3),
                         kk > 0);
  }
}

// wsmap, wtmap: [256, K] bf16, boxes {64, 256}; xsmap, xtmap: [R, 256]
// bf16, boxes {64, 32}; 128-byte swizzle.  Blocks: x over the column tiles
// (warpgroup w: tile blockIdx.x + w * blocks_x), y over the chunks of rows.
template <int WG>
__global__ void __launch_bounds__((WG + 1) * WG_THREADS, 1)
proto_ce_dws_kernel(const __grid_constant__ CUtensorMap xsmap,
                    const __grid_constant__ CUtensorMap xtmap,
                    const __grid_constant__ CUtensorMap wsmap,
                    const __grid_constant__ CUtensorMap wtmap,
                    const Args a) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint8_t* ring = sm + WG * 2 * OWN_BYTES;
  float4* stat = reinterpret_cast<float4*>(ring + a.stages * STAGE_BYTES);
  uint64_t* rbar = reinterpret_cast<uint64_t*>(stat + a.stages * BT);
  uint64_t* full = rbar + 1;
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid / WG_THREADS;
  const int n_kt = (a.K + OWN - 1) / OWN;
  const int r_begin = blockIdx.y * a.per * UNIT;
  const int n = (min(a.R, r_begin + a.per * UNIT) - r_begin + BT - 1) / BT;
  float* out = a.out + (long)blockIdx.y * D * a.K;

  int live = 0;                           // warpgroups whose columns exist
#pragma unroll
  for (int w = 0; w < WG; ++w)
    if (blockIdx.x + w * a.blocks_x < n_kt) live |= 1 << w;
  const int first = next_live(a, 0, n, r_begin, lane,
                              peek_gs(a, 0, n, r_begin, lane));
  if (first == n) {                       // all g = 0: dws = +0
    if (wg < WG && (live >> wg & 1)) {
      const int col0 = (blockIdx.x + wg * a.blocks_x) * OWN;
      for (int i = tid % WG_THREADS; i < D * OWN; i += WG_THREADS) {
        const int col = col0 + i % OWN;
        if (col < a.K) out[(long)(i / OWN) * a.K + col] = 0.f;
      }
    }
    return;
  }
  const int n_live = __popc(live);

  if (tid == 0) {
    mbar_init(rbar, 1);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 32);            // the producer warp's lanes
      mbar_init(empty + s, 4 * n_live);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WG) {                         // the producer warpgroup
    producer_regs<WG>();
    if (tid % WG_THREADS >= 32) return;   // its first warp walks the tiles
    if (lane == 0) {
      mbar_expect_tx(rbar, n_live * 2 * OWN_BYTES);
      for (int w = 0; w < WG; ++w) {
        if (!(live >> w & 1)) continue;
        const int col0 = (blockIdx.x + w * a.blocks_x) * OWN;
        uint8_t* own = sm + w * 2 * OWN_BYTES;
        tma_load_3d(own, &wsmap, rbar, col0, 0, 0);
        tma_load_3d(own + OWN_BYTES, &wtmap, rbar, col0, 0, 0);
      }
    }
    int u = 0;                            // the whole warp walks the tiles
    Ring r = {0, 0};
    for (int i = first; i < n; ++u, r.next(a.stages),
         i = next_live(a, i + 1, n, r_begin, lane,
                       peek_gs(a, i + 1, n, r_begin, lane))) {
      if (u >= a.stages) mbar_wait(empty + r.slot, r.phase ^ 1);
      // lane l: row l's statistics, then its arrival on the slot
      const int row0 = r_begin + BT * i, row = row0 + lane;
      const bool in = row < a.R;
      stat[r.slot * BT + lane] =
          make_float4(in ? __ldg(a.lse_s + row) * LOG2E : 0.f,
                      in ? __ldg(a.lse_t + row) * LOG2E : 0.f,
                      row_gs(a, row), 0.f);
      if (lane == 0) {
        uint8_t* st = ring + r.slot * STAGE_BYTES;
        mbar_expect_tx(full + r.slot, STAGE_BYTES);
        for (int j = 0; j < D / 64; ++j) {
          tma_load_3d(st + j * BOX_XS, &xsmap, full + r.slot, 64 * j, row0,
                      0);
          tma_load_3d(st + HALF_STAGE + j * BOX_XS, &xtmap, full + r.slot,
                      64 * j, row0, 0);
        }
      } else {
        mbar_arrive(full + r.slot);
      }
    }
    return;
  }
  consumer_regs<WG>();
  if (!(live >> wg & 1)) return;

  const int warp = (tid % WG_THREADS) >> 5, g = lane >> 2, t = lane & 3;
  // the fragment's accumulator rows are the columns k_lo and k_lo + 8
  const int k_lo = (blockIdx.x + wg * a.blocks_x) * OWN + warp * 16 + g;
  bool ok[2];
  float cv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ok[r] = k_lo + 8 * r < a.K;
    cv[r] = ok[r] ? __ldg(a.c + k_lo + 8 * r) : 0.f;
  }
  const uint8_t* ws = sm + wg * 2 * OWN_BYTES;
  const uint8_t* wt = ws + OWN_BYTES;
  float acc[128], s[16], tv[16];
  float g_ahead = peek_gs(a, first + 1, n, r_begin, lane);
  mbar_wait(rbar, 0);
  mbar_wait(full, 0);
  wgmma_fence();
  dws_logits(s, tv, ws, wt, ring);
  wgmma_commit();
  wgmma_wait0();
  int u = 0;
  Ring r = {0, 0};                        // tile i's slot
  for (int i = first; i < n; ++u) {
    const uint8_t* stage = ring + r.slot * STAGE_BYTES;
    const float4* rows = stat + r.slot * BT;
    const int st = r.slot;
    r.next(a.stages);
    // ds^T of tile i in place of s: s[4j + e] is column k_lo (e < 2) or
    // k_lo + 8, tile row 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 q = rows[8 * j + 2 * t + e];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          s[4 * j + 2 * r + e] = ds_of(s[4 * j + 2 * r + e],
                                       tv[4 * j + 2 * r + e], cv[r], ok[r],
                                       q.x, q.y, q.z, a.ks, a.kt);
      }
    uint32_t dsa[2][4];
    acc_to_a(s, 0, dsa[0]);
    acc_to_a(s, 1, dsa[1]);
    // dws^T[k, d] += sum_r ds[r, k] xs[r, d]: the xs boxes read MN-major
    const uint64_t db = desc_sw128(stage, BOX_XS, 1024);
    auto product = [&](int kk) {
      wgmma_rs256<1>(acc, dsa[kk], db + kk * (16 * 128 >> 4),
                     u > 0 || kk > 0);
    };
    // the next live tile, and the g of the tile after it, read while the
    // wgmmas run
    const int nxt = next_live(a, i + 1, n, r_begin, lane, g_ahead);
    if (nxt < n) g_ahead = peek_gs(a, nxt + 1, n, r_begin, lane);
    wgmma_fence();
    product(0);
    product(1);
    if (nxt < n) {                        // the next live tile's logits
      mbar_wait(full + r.slot, r.phase);
      dws_logits(s, tv, ws, wt, ring + r.slot * STAGE_BYTES);
    }
    wgmma_commit();
    wgmma_wait0();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    i = nxt;
  }
  add_zero(acc);

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k_lo + 8 * (e >> 1);
      if (ok[e >> 1])
        out[(long)(8 * j + 2 * t + (e & 1)) * a.K + k] = acc[4 * j + e];
    }
}

// out[i] = sum over p = 0 .. P-1, in order, of part[p * n + i].
__global__ void sum_partials_kernel(const float* __restrict__ part, int P,
                                    long n, float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = part[i];
  for (int p = 1; p < P; ++p) acc += part[(long)p * n + i];
  out[i] = acc;
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                       Args);

template <bool DXS>
Kernel kernel_for(int groups) {
  if (DXS)
    return groups == 2 ? proto_ce_dxs_kernel<2> : proto_ce_dxs_kernel<1>;
  return groups == 2 ? proto_ce_dws_kernel<2> : proto_ce_dws_kernel<1>;
}

// dxs (DXS) or dws on `stream`: the four tensor maps, the kernel, and with
// plan.splits > 1 the fixed-order sum of the partials.  0 when queued, a
// cudaError_t of a launch, 1000 + the CUresult of a map that could not be
// encoded, or 2000 for a plan the kernels do not take.
template <bool DXS>
int launch(const void* xs, const void* ws, const void* xt, const void* wt,
           const void* c, const void* lse_s, const void* lse_t,
           const void* g, void* dst, void* part, int R, int K,
           const int* plan_ints, float inv_ts, float tau_t, void* stream) {
  const Plan p = Plan::from(plan_ints);
  if (!p.valid(smem_bytes(p.groups, p.stages))) return 2000;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap maps[4];
  const bf16* x[2] = {static_cast<const bf16*>(xs),
                      static_cast<const bf16*>(xt)};
  const bf16* w[2] = {static_cast<const bf16*>(ws),
                      static_cast<const bf16*>(wt)};
  int err = 0;
  for (int i = 0; i < 2 && err == 0; ++i)
    err = encode_3d(maps + i, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x[i], D, R,
                    1, 2ull * D, 2ull * D * R, 64, DXS ? OWN : BT);
  for (int i = 0; i < 2 && err == 0; ++i)
    err = DXS ? encode_w_stream(maps + 2 + i, w[i], K)
              : encode_3d(maps + 2 + i, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          w[i], K, D, 1, 2ull * K, 2ull * K * D, 64, D);
  if (err != 0) return 1000 + err;
  Args a;
  a.c = static_cast<const float*>(c);
  a.lse_s = static_cast<const float*>(lse_s);
  a.lse_t = static_cast<const float*>(lse_t);
  a.g = static_cast<const float*>(g);
  a.out = static_cast<float*>(p.splits > 1 ? part : dst);
  a.R = R;
  a.K = K;
  a.per = p.per;
  a.blocks_x = p.blocks_x;
  a.stages = p.stages;
  a.ks = inv_ts * LOG2E;
  a.kt = LOG2E / tau_t;
  a.inv_ts = inv_ts;
  kernel_for<DXS>(p.groups)<<<dim3(p.blocks_x, p.splits),
                              (p.groups + 1) * WG_THREADS, p.smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  err = (int)cudaGetLastError();
  if (err != 0 || p.splits == 1) return err;
  const long total = DXS ? (long)R * D : (long)D * K;
  sum_partials_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a.out, p.splits, total, static_cast<float*>(dst));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Opt the four kernels in to the device's per-block opt-in limit of
// dynamic shared memory on the current device, `device`; returns the
// limit in bytes, or -1.
int proto_ce_bwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  for (int groups = 1; groups <= 2; ++groups)
    if (cudaFuncSetAttribute((const void*)kernel_for<true>(groups),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             v) != cudaSuccess
        || cudaFuncSetAttribute((const void*)kernel_for<false>(groups),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                v) != cudaSuccess)
      return -1;
  return v;
}

// dxs [R, D] f32 on `stream`, by the launch plan `plan` (groups, stages,
// splits, per, smem, blocks_x).  splits > 1: the K range is split over
// blocks, each writing its partial to part [splits, R, D], summed in order
// into dxs.  Returns 0 or an error code (launch above).
int proto_ce_dxs(const void* xs, const void* ws, const void* xt,
                 const void* wt, const void* c, const void* lse_s,
                 const void* lse_t, const void* g, void* dxs, void* part,
                 int R, int K, const int* plan, float inv_ts, float tau_t,
                 void* stream) {
  return launch<true>(xs, ws, xt, wt, c, lse_s, lse_t, g, dxs, part, R, K,
                      plan, inv_ts, tau_t, stream);
}

// dws [D, K] f32 on `stream`, likewise; splits > 1: the rows are split
// into chunks, each writing its partial to part [splits, D, K].
int proto_ce_dws(const void* xs, const void* ws, const void* xt,
                 const void* wt, const void* c, const void* lse_s,
                 const void* lse_t, const void* g, void* dws, void* part,
                 int R, int K, const int* plan, float inv_ts, float tau_t,
                 void* stream) {
  return launch<false>(xs, ws, xt, wt, c, lse_s, lse_t, g, dws, part, R, K,
                       plan, inv_ts, tau_t, stream);
}

}  // extern "C"
