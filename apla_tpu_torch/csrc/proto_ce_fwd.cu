// Prototype cross-entropy forward for Hopper (sm_90a): the DINOv2 head's
// prototype projection and the row-wise teacher/student cross-entropy in one
// pass, without the [R, K] logits ever reaching device memory.
//
// Replaces the TPU kernel apla_tpu/ops/pallas_proto_ce.py:_fwd_kernel
// (called through _proto_ce_fwd).  Contract, that kernel's function with its
// rounding points:
//
//   xs, xt [R, D] bf16, ws, wt [D, K] bf16, c [K] f32, tau_t, tau_s
//   s = (xs ws) / tau_s,  t = (xt wt - c) / tau_t    (f32 logits)
//   lse_s = logsumexp_k s,  lse_t = logsumexp_k t,
//   ce = lse_s - sum_k softmax(t)_k s_k                       3 x [R] f32
//
// with f32 products of the bf16 inputs, the sums of exp clamped at 1e-30
// before the log, and columns at or past K out of both softmaxes (their
// cross term is 0, not NaN).  D is 256 (every DINOv2 recipe's bottleneck).
//
// What bounds it on the H100: 4 R D K FLOP of bf16 products (1.10e12 at the
// iBOT site R = 16384, K = 65536: >= 1.11 ms at 989 TFLOP/s) against two
// 33.5 MB weights and 16 MB of rows, so the tensor cores bound it.  It also
// takes 2 R K exp2f and some 25 other instructions a (row, column) on the
// SMs' issue slots, about as long as the products: the two have to overlap.
// The weights (67 MB) do not fit the 50 MB L2, and every block streams all
// of its K range of them, so the rows a block owns set the L2 -> SM bytes
// (measured, PERF.md §6: 8.6 GB a call at 128 rows a block, read at half
// the rate that blocks of 64 rows reach, so L2 does not bound it).
//
// Design: a block is one producer warpgroup (one warp streams, the rest
// leave; with two consumers it gives its registers to them by setmaxnreg)
// and `groups` (1 or 2) consumer warpgroups, each owning 64 rows
// (warpgroup w of block b: row tile b + w * blocks_x); ops/proto_ce.py:
// proto_fwd_plan lays them out.
//  * a consumer loads its xs and xt rows once, from global memory straight
//    into registers as the A operand of wgmma (2 x 64 registers a thread),
//    so shared memory holds only the ring: ws and wt stream through it as
//    [256, 32] boxes (proto_ce_sm90.cuh:stream_w, the producer writing each
//    stage's centers beside it);
//  * per streamed tile, s = xs ws and t = xt wt are two chains of 16 wgmma
//    m64n32k16 with A from registers (RS: only the 32-column B is read from
//    shared memory, 64 FLOP a byte), then the tile is folded into the
//    running statistics and the next tile's products issued: within a
//    warpgroup a chain, so the two warpgroups of a block take turns on the
//    tensor cores.  (Measured slower on the H100: 64-wide tiles, and a
//    second accumulator set with tile i + 1's products in flight during
//    tile i's fold, for which ptxas waited on every wgmma.)  A tile wholly
//    inside K folds without the selects that mask columns past it.
//  * when the rows alone give too few blocks for the SMs (the DINO sites,
//    R = 128 or 1024) the K range is split over blocks at split_work's
//    64-wide boundaries; proto_ce_combine_kernel, a programmatic dependent
//    launch, merges the partials.  With one split the block merges its
//    rows' two states itself: one launch.
//
// Bits: those of the mma.sync kernel this replaces, whose block of 8 warps
// split each 64-column tile between two warp halves, each folding its 32
// columns of every tile into a running state of its own.  Here tile i of a
// split's 32-column stream is that kernel's half i & 1 of its tile i / 2,
// so it goes to state i & 1; a wgmma accumulator gives each thread an
// mma.sync fragment's rows and columns (sm90_async.cuh), each logit is a
// D = 256 contraction in increasing k16 order (the first step overwriting
// the accumulator: what adding it to +0 gives, but for the sign of a zero,
// which s * ks and exp2f do not see), and `fold` is that kernel's
// scale_logits and per-tile update, expression for expression (the selects
// keep nvcc from contracting s * ks - m into an fma; inside K, __fmul_rn
// does).  A tile wholly past K, which that kernel folded as all -inf,
// leaves a state as it was, so it is not streamed.  The partials, 2 a split, are merged in that kernel's order
// by the same expressions (merge_partials), in the epilogue or a second
// launch; reruns are bit-equal.

#include "proto_ce_sm90.cuh"

namespace {

using namespace proto;

constexpr float LN2 = 0.6931471805599453f;
constexpr int KSTEPS = D / 16;             // k16 steps of a logit

struct FwdArgs {
  const bf16* xs;             // [R, 256]
  const bf16* xt;
  const float* c;             // [K]
  float* part;                // [5][2 * splits][R], with splits > 1
  float* ce;                  // [R] each, with one split
  float* lse_s;
  float* lse_t;
  int R, K;
  int per;                    // 64-wide units of K a split
  int blocks_x, stages, splits;
  float ks, kt;               // log2(e) / tau_s, log2(e) / tau_t
};

// Shared memory after aligning the base to 1024 bytes: the ring's stages,
// their centers, then the barriers full[stages], empty[stages].
__host__ __device__ constexpr int smem_bytes(int stages) {
  return 1024 + stages * (STAGE_BYTES + BT * 4) + 256;
}

// A running state of a thread's rows r_lo, r_lo + 8 (index r) in log2
// units: the max and sum of exp of s and of t, and the cross term
// sum exp(t - m_t) s.
struct State {
  float m_s[2], l_s[2], m_t[2], l_t[2], a_t[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_s[r] = m_t[r] = -INFINITY;
      l_s[r] = l_t[r] = a_t[r] = 0.f;
    }
  }

  // value q of row r: m_s, l_s, m_t, l_t, a_t (a partial's planes)
  __device__ __forceinline__ float get(int q, int r) const {
    return q == 0 ? m_s[r] : q == 1 ? l_s[r] : q == 2 ? m_t[r]
           : q == 3 ? l_t[r] : a_t[r];
  }
};

// x rows r_lo and r_lo + 8 (zeros at or past R) as the register A operand
// of a wgmma's 16 k16 steps, the mma.sync m16n8k16 A layout: xa[kk][0] row
// r_lo, columns 16 kk + 2t and + 1, [1] the same on row r_lo + 8, [2] and
// [3] the columns 8 on.
__device__ __forceinline__ void load_rows(uint32_t (&xa)[KSTEPS][4],
                                          const bf16* x, int r_lo, int R,
                                          int t) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(x);
  const bool ok_lo = r_lo < R, ok_hi = r_lo + 8 < R;
  const long lo = (long)r_lo * (D / 2) + t, hi = lo + 8 * (D / 2);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    xa[kk][0] = ok_lo ? __ldg(w + lo + 8 * kk) : 0u;
    xa[kk][1] = ok_hi ? __ldg(w + hi + 8 * kk) : 0u;
    xa[kk][2] = ok_lo ? __ldg(w + lo + 8 * kk + 4) : 0u;
    xa[kk][3] = ok_hi ? __ldg(w + hi + 8 * kk + 4) : 0u;
  }
}

// s = xs ws, t = xt wt for the warpgroup's 64 rows x the stage's 32 columns
// (the stage: ws then wt, [256, 32] MN-major), the two chains interleaved.
__device__ __forceinline__ void logits(float (&s)[16], float (&t)[16],
                                       const uint32_t (&xa)[KSTEPS][4],
                                       const uint32_t (&ta)[KSTEPS][4],
                                       const uint8_t* stage) {
  // descriptor units are 16 bytes; a k16 step is 16 rows of 64 bytes
  const uint64_t bs = desc_mnmajor64(stage);
  const uint64_t bt = desc_mnmajor64(stage + HALF_STAGE);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_rs32(s, xa[kk], bs + kk * (16 * BT * 2 >> 4), kk > 0);
    wgmma_rs32(t, ta[kk], bt + kk * (16 * BT * 2 >> 4), kk > 0);
  }
}

// Fold one streamed tile into state `st`: s[4j + e], t[4j + e] are the raw
// logits of row r_lo (e < 2) or r_lo + 8 at column col0 + 8j + (e & 1)
// (col0 = the tile's column + 2t), cv[j] the centers of columns col0 + 8j
// and + 1, lim the split's end.  The mma.sync kernel's scale_logits, then
// its update per row: the tile's max (each thread's 8 values, then the
// quad), the sums of exp2 in (j, e) order, then the quad's.  INSIDE: every
// column is below lim, and the selects go: the products are rounded as
// they were (__fmul_rn, which nvcc does not contract), and et * s is then
// finite, so the cross term adds it whatever et is (a +-0 term leaves a
// sum started at +0 as it is).
template <bool INSIDE>
__device__ __forceinline__ void fold(State& st, float (&s)[16],
                                     float (&tv)[16], const float2 (&cv)[4],
                                     int col0, int lim, float ks, float kt) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float c = e ? cv[j].y : cv[j].x;
      if (INSIDE) {
        s[4 * j + e] = __fmul_rn(s[4 * j + e], ks);
        s[4 * j + 2 + e] = __fmul_rn(s[4 * j + 2 + e], ks);
        tv[4 * j + e] = __fmul_rn(tv[4 * j + e] - c, kt);
        tv[4 * j + 2 + e] = __fmul_rn(tv[4 * j + 2 + e] - c, kt);
        continue;
      }
      const bool ok = col0 + 8 * j + e < lim;
      s[4 * j + e] = ok ? s[4 * j + e] * ks : -INFINITY;
      s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] * ks : -INFINITY;
      tv[4 * j + e] = ok ? (tv[4 * j + e] - c) * kt : -INFINITY;
      tv[4 * j + 2 + e] = ok ? (tv[4 * j + 2 + e] - c) * kt : -INFINITY;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx_s = -INFINITY, mx_t = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx_s = fmaxf(mx_s, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx_t = fmaxf(mx_t, fmaxf(tv[4 * j + 2 * r], tv[4 * j + 2 * r + 1]));
    }
    const float ns = fmaxf(st.m_s[r], quad_max(mx_s));
    const float nt = fmaxf(st.m_t[r], quad_max(mx_t));
    // a tile whose columns are all past K keeps max -inf: its reference
    // point is 0 and every exp is 0, never exp(-inf - -inf)
    const float rs = (ns == -INFINITY) ? 0.f : ns;
    const float rt = (nt == -INFINITY) ? 0.f : nt;
    float sum_s = 0.f, sum_t = 0.f, cross = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        sum_s += exp2f(s[4 * j + e] - rs);
        const float et = exp2f(tv[4 * j + e] - rt);
        sum_t += et;
        if (INSIDE)
          cross += __fmul_rn(et, s[4 * j + e]);
        else
          cross += et > 0.f ? et * s[4 * j + e] : 0.f;   // s = -inf past K
      }
    const float sc_t = exp2f(st.m_t[r] - rt);
    st.l_s[r] = st.l_s[r] * exp2f(st.m_s[r] - rs) + quad_sum(sum_s);
    st.l_t[r] = st.l_t[r] * sc_t + quad_sum(sum_t);
    st.a_t[r] = st.a_t[r] * sc_t + quad_sum(cross);
    st.m_s[r] = ns;
    st.m_t[r] = nt;
  }
}

// Merge P partial states of a row, in order p = 0 .. P-1, into its ce,
// lse_s and lse_t; v(q, p) is value q of partial p (State::get's order).
template <class V>
__device__ __forceinline__ void merge_partials(V v, int P, float* ce,
                                               float* lse_s, float* lse_t) {
  float ms = -INFINITY, mt = -INFINITY;
  for (int p = 0; p < P; ++p) {
    ms = fmaxf(ms, v(0, p));
    mt = fmaxf(mt, v(2, p));
  }
  const float rs = (ms == -INFINITY) ? 0.f : ms;
  const float rt = (mt == -INFINITY) ? 0.f : mt;
  float ls = 0.f, lt = 0.f, a = 0.f;
  for (int p = 0; p < P; ++p) {
    ls += v(1, p) * exp2f(v(0, p) - rs);
    const float sc = exp2f(v(2, p) - rt);
    lt += v(3, p) * sc;
    a += v(4, p) * sc;
  }
  ls = fmaxf(ls, 1e-30f);
  lt = fmaxf(lt, 1e-30f);
  const float s_lse = (rs + log2f(ls)) * LN2;
  *lse_s = s_lse;
  *lse_t = (rt + log2f(lt)) * LN2;
  *ce = s_lse - (a / lt) * LN2;
}

// wsmap, wtmap: [256, K] bf16, boxes {32, 256} (encode_w_stream).  Blocks:
// x over the row tiles (warpgroup w: tile blockIdx.x + w * blocks_x), y
// over the splits of K.
template <int WG>
__global__ void __launch_bounds__((WG + 1) * WG_THREADS, 1)
proto_ce_fwd_kernel(const __grid_constant__ CUtensorMap wsmap,
                    const __grid_constant__ CUtensorMap wtmap,
                    const FwdArgs a) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* ring = aligned_smem(raw_smem);
  float* cen = reinterpret_cast<float*>(ring + a.stages * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(cen + a.stages * BT);
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid / WG_THREADS;
  const int n_rt = (a.R + OWN - 1) / OWN;
  const int c_begin = blockIdx.y * a.per * UNIT;
  const int lim = min(a.K, c_begin + a.per * UNIT);   // the split's end
  const int n = (lim - c_begin + BT - 1) / BT;
  int n_live = 0;                         // warpgroups whose rows exist
#pragma unroll
  for (int w = 0; w < WG; ++w)
    if (blockIdx.x + w * a.blocks_x < n_rt) ++n_live;

  // a consumer's rows, from global memory into registers: with one
  // consumer warpgroup they land while the barriers are set up; with two
  // they wait for setmaxnreg (held across it, they spilled)
  const int warp = (tid % WG_THREADS) >> 5, t = lane & 3;
  const int tile = blockIdx.x + wg * a.blocks_x;
  const int r_lo = tile * OWN + warp * 16 + (lane >> 2);
  uint32_t xa[KSTEPS][4], ta[KSTEPS][4];
  if (WG == 1 && wg == 0 && tile < n_rt) {
    load_rows(xa, a.xs, r_lo, a.R, t);
    load_rows(ta, a.xt, r_lo, a.R, t);
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 32);            // the producer warp's lanes
      mbar_init(empty + s, 4 * n_live);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  if (tid == WG * WG_THREADS) {
    tma_prefetch_map(&wsmap);
    tma_prefetch_map(&wtmap);
  }
  // the partials' merge may be scheduled (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __syncthreads();

  if (wg == WG) {                         // the producer warpgroup
    producer_regs<WG>();
    if (tid % WG_THREADS >= 32) return;   // its first warp fills the ring
    stream_w(ring, cen, full, empty, &wsmap, &wtmap, a.c, a.K, c_begin, n,
             a.stages, lane);
    return;
  }
  consumer_regs<WG>();
  if (tile >= n_rt) return;
  if (WG == 2) {
    load_rows(xa, a.xs, r_lo, a.R, t);
    load_rows(ta, a.xt, r_lo, a.R, t);
  }
  State st[2];                            // tiles i with i & 1 = 0, 1
  st[0].init();
  st[1].init();
  float s[16], tv[16];
  Ring fill = {0, 0}, use = {0, 0};       // the slots to issue and to fold
  auto issue = [&] {                      // the next tile's logits
    mbar_wait(full + fill.slot, fill.phase);
    wgmma_fence();
    logits(s, tv, xa, ta, ring + fill.slot * STAGE_BYTES);
    wgmma_commit();
    fill.next(a.stages);
  };
  // tile i's products done: release its stage and fold it into sv, then
  // issue tile i + 1's (in one block with the fold, whose last steps, the
  // quads' shuffles and the state's update, then overlap the products)
  auto step = [&](int i, State& sv) {
    wgmma_wait0();
    float2 cv[4];
    const float* cs = cen + use.slot * BT + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cv[j] = *reinterpret_cast<const float2*>(cs + 8 * j);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + use.slot);   // the stage is read
    use.next(a.stages);
    const int col = c_begin + BT * i;
    if (col + BT <= lim)
      fold<true>(sv, s, tv, cv, col + 2 * t, lim, a.ks, a.kt);
    else
      fold<false>(sv, s, tv, cv, col + 2 * t, lim, a.ks, a.kt);
    if (i + 1 < n) issue();
  };
  issue();
  for (int i = 0; i < n; ++i) {
    if (i & 1)                            // st[] indexed by constants only
      step(i, st[1]);
    else
      step(i, st[0]);
  }

  if (t != 0) return;                     // the quad holds one row's state
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = r_lo + 8 * q;
    if (row >= a.R) continue;
    if (a.splits == 1) {
      merge_partials([&](int v, int p) { return st[p].get(v, q); }, 2,
                     a.ce + row, a.lse_s + row, a.lse_t + row);
      continue;
    }
    const long plane = 2L * a.splits * a.R;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = a.part + (long)(2 * blockIdx.y + h) * a.R + row;
#pragma unroll
      for (int v = 0; v < 5; ++v) dst[v * plane] = st[h].get(v, q);
    }
  }
}

// Merge the P partials of each row, in order, into ce, lse_s, lse_t.  A
// programmatic dependent of the main kernel: it waits for that grid's end.
__global__ void proto_ce_combine_kernel(const float* __restrict__ part, int P,
                                        int R, float* __restrict__ ce,
                                        float* __restrict__ lse_s,
                                        float* __restrict__ lse_t) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const long plane = (long)P * R;
  merge_partials(
      [&](int v, int p) { return part[v * plane + (long)p * R + row]; }, P,
      ce + row, lse_s + row, lse_t + row);
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, FwdArgs);

Kernel kernel_for(int groups) {
  return groups == 2 ? proto_ce_fwd_kernel<2> : proto_ce_fwd_kernel<1>;
}

}  // namespace

extern "C" {

// Opt both block shapes in to the device's per-block opt-in limit of
// dynamic shared memory on the current device, `device`; returns the limit
// in bytes, or -1.
int proto_ce_fwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  for (int groups = 1; groups <= 2; ++groups)
    if (cudaFuncSetAttribute((const void*)kernel_for(groups),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             v) != cudaSuccess)
      return -1;
  return v;
}

// ce, lse_s, lse_t [R] f32 on `stream`, by the launch plan `plan` (groups,
// stages, splits, per, smem, blocks_x of ops/proto_ce.py:proto_fwd_plan).
// With splits > 1 the blocks write their partials to part [5][2 * splits]
// [R] f32 and a second launch merges them.  The caller checks shapes (D ==
// 256, K % 8 == 0, contiguous 16-byte aligned tensors).  Returns 0 when
// queued, a cudaError_t of a launch, 1000 + the CUresult of a tensor map
// that could not be encoded, or 2000 for a plan the kernel does not take.
int proto_ce_fwd(const void* xs, const void* ws, const void* xt,
                 const void* wt, const void* c, void* part, void* ce,
                 void* lse_s, void* lse_t, int R, int K, const int* plan,
                 float inv_ts, float tau_t, void* stream) {
  const Plan p = Plan::from(plan);
  if (!p.valid(smem_bytes(p.stages))) return 2000;
  CUtensorMap maps[2];
  int err = encode_w_stream(maps, ws, K);
  if (err == 0) err = encode_w_stream(maps + 1, wt, K);
  if (err != 0) return 1000 + err;
  FwdArgs a;
  a.xs = static_cast<const bf16*>(xs);
  a.xt = static_cast<const bf16*>(xt);
  a.c = static_cast<const float*>(c);
  a.part = static_cast<float*>(part);
  a.ce = static_cast<float*>(ce);
  a.lse_s = static_cast<float*>(lse_s);
  a.lse_t = static_cast<float*>(lse_t);
  a.R = R;
  a.K = K;
  a.per = p.per;
  a.blocks_x = p.blocks_x;
  a.stages = p.stages;
  a.splits = p.splits;
  a.ks = inv_ts * LOG2E;
  a.kt = LOG2E / tau_t;
  cudaStream_t st = (cudaStream_t)stream;
  kernel_for(p.groups)<<<dim3(p.blocks_x, p.splits),
                         (p.groups + 1) * WG_THREADS, p.smem, st>>>(
      maps[0], maps[1], a);
  err = (int)cudaGetLastError();
  if (err != 0 || p.splits == 1) return err;
  // a programmatic dependent launch: its blocks are scheduled as the main
  // kernel's leave, and wait for its end (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, proto_ce_combine_kernel,
                                 (const float*)a.part, 2 * p.splits, R, a.ce,
                                 a.lse_s, a.lse_t);
}

}  // extern "C"
