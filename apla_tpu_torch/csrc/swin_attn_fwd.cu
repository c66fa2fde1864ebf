// Swin window attention forward for Hopper (sm_90a): per window and head,
// softmax(q k^T * scale + bias + mask) v into a scratch o, then the window
// block's output projection over the flattened rows of o.
//
// Replaces apla_tpu/ops/pallas_apla_attn.py:_fwd_kernel_bias (called
// through _call_fwd_swin), the ViT kernel's body with the relative-position
// bias and the shift mask added to the scores.  Contract, that kernel's:
//
//   qkv  [B, N, 3C] bf16 (B = images x windows, image outermost; C = H * 32)
//   w    [C, C]     bf16 (attn.proj, [d_in, d_out] layout)
//   bias [H, N, N]  f32  (the gathered relative-position bias)
//   mask [nW, N, N] f32  (shifted blocks: window b's plane at b mod nW;
//                         absent otherwise)
//   o    [B, N, C]  bf16 (scratch), head h at columns h*32 .. h*32+31:
//        o_h = bf16(bf16(softmax(s_h)) v_h),
//        s_h = (q_h k_h^T * scale + bias[h]) + mask[b mod nW]
//   out  [B, N, C]  bf16 = o @ w
//
// with f32 scores, p normalised in f32 and rounded to bf16 before p v, p v
// accumulated in f32 and rounded once, the projection accumulated in f32
// over C in increasing k16 steps from +0 and stored as bf16.  The
// projection's bias is added by the caller.
//
// Bits: the output is that of the single mma.sync kernel this replaces,
// to the last bit: the scores are formed as it formed them
// (__fmul_rn by scale, __fadd_rn of the bias, then of the mask, then times
// log2(e)), the row's maximum and sum are taken tile by tile against the
// running maximum with exp2f, as its first pass took them, p v and the
// projection run over the same k16 steps in the same order
// (tools/compare_mha_fwd.py --kernel swin counts the equal values).
//
// What bounds it on the H100: a window is small (N = 49).  At stage 0 of a
// b16 batch (1024 windows, C = 96) the call moves 39 MB (qkv, out, the bias
// and mask planes) against 1.87 GFLOP: the bytes, 0.0117 ms at 3.35 TB/s;
// the scratch o (9.6 MB) makes one round trip through the 50 MB L2.  At
// stage 3 (16 windows, C = 768) the work is 24 heads a window and a
// [784, 768] @ [768, 768] projection: the single kernel ran it in 16 blocks
// on 132 SMs.  Split at the head concatenation, the attention has B * H
// items (3072 at stage 0, 384 at stage 3) and the projection B * N rows.
//
// Design:
//  1. attention: one warpgroup (128 threads) per block, 64 query rows at a
//     time, laid out by ops/fused_swin_attn.py:swin_plan; the row kernel's
//     block takes a run of items (window, head), a window's heads next to
//     each other (they share its mask plane; the H bias planes stay in
//     L1).  Head-dim-32 tiles are TMA boxes of 32 columns x 64 rows with
//     the 64-byte swizzle (sm90_async.cuh: swz64, desc_kmajor64,
//     desc_mnmajor64), counted on mbarriers, rows past N zero-filled (the
//     3-D map never reaches the next window); the pieces both attention
//     forwards share are in attn_fwd_sm90.cuh, those the Swin backward
//     (swin_attn_bwd.cu) shares too, the tiles and the score terms, in
//     swin_sm90.cuh.
//     - "row" kernel, N <= 64 (one tile: every Swin-T window, 7 x 7 or
//       8 x 8): mha_fwd.cu's row kernel at head dim 32 over one key tile:
//       the item's K and V resident (two K/V sets when a block runs
//       several items, the next loaded while this one computes), q tiles
//       double buffered, s = q k^T by wgmma m64nNk16 only as wide as N
//       needs, p from registers as the A operand of p v (wgmma m64n32k16,
//       v MN-major).  The bias and mask are read by __ldg (their rows are
//       4 N bytes, no multiple of 16 at N = 49, so neither TMA nor a bulk
//       copy takes them): each thread's 2 x 32 terms go into registers
//       while the q k^T wgmmas run.  Each block's chain of loads, products
//       and softmax per item is what bounds this kernel, so taking the
//       loads off that chain beat more blocks an SM: three blocks at 153
//       registers ran faster in development runs than four or six that
//       read the terms after the wgmmas (PERF.md §6).
//     - "two-pass" kernel, N > 64 (windows of 9 x 9 and up): one item
//       (window, head, query tile) a block; pass 1 over the key tiles
//       keeps each row's running max and sum, pass 2 recomputes the
//       scores and forms p; K (then K and V) stream through a ring of two
//       slots.
//     The output tile is staged in shared memory (swizzled) and written by
//     one TMA store, which clips the rows past N.
//  2. projection: gemm_sm90.cuh's GEMM (apla_proj_gemm.cu's, the ViT
//     forward's projection) with o as the K-major A and w read in place as
//     the MN-major B over M = B * N rows; its 64-column boxes zero-fill
//     past C, so C = 96 (Swin-T's stage 0) runs with two zero k16 steps
//     after the six real ones, which add +0 to every sum.
// One C entry encodes the maps and queues the launches a call asks for
// (`parts`: the attention, the projection, or both), so a forward is one
// call from Python.

#include "swin_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

using namespace swin90;
typedef __nv_bfloat16 bf16;

// Shared memory (after aligning the base to 1024 bytes): two q tiles, the
// output tile, `slots` K/V slots (K then V, 8 KB each), then the barriers.
constexpr int Q_OFF = 0;
constexpr int O_OFF = 2 * TILE_BYTES;
constexpr int KV_OFF = 3 * TILE_BYTES;
constexpr int SLOT_BYTES = 2 * TILE_BYTES;

// `parts` of the C entry
constexpr int PART_ATTN = 1, PART_PROJ = 2;

struct Plan {
  int N, H, C, nW;
  float scale;
  int n_t;              // ceil(N / 64): query tiles = key tiles
  int items;            // row kernel: B * H (window b, head h at b H + h)
  int items_per_block;  // row kernel
  int kv_sets;          // row kernel: K/V sets (1, or 2 to prefetch)
  const float* bias;    // [H, N, N]
  const float* mask;    // [nW, N, N] or null
};

// Stage the 64 x 32 output tile (swizzled, bf16) and store it with TMA.
__device__ __forceinline__ void store_tile(const float (&o)[16], uint8_t* ob,
                                           const CUtensorMap* omap, int h,
                                           int qt, int b, int tid) {
  if (tid == 0) tma_store_wait_read();        // the previous tile's store
  named_sync(1, NT);
  stage_tile(o, ob, tid);
  fence_proxy_async();
  named_sync(1, NT);
  if (tid == 0) {
    tma_store_3d(omap, ob, h * DH, qt * BM, b);
    tma_store_commit();
  }
}

// ---------------------------------------------------------------------------
// Row kernel: N <= 64, the key tile TAILN wide (16, 32, 48 or 64 columns, N
// rounded up to 16); an item (window, head) is one query tile against one
// key tile, K/V resident, the score row in registers, as mha_fwd.cu's row
// kernel at head dim 64.  Thread 0 issues the loads: K then V of an item,
// a barrier each, and the q tiles double buffered.  Barriers: q[2], then K
// and V of each K/V set.  The registers leave three blocks an SM.
template <int TAILN>
__global__ void __launch_bounds__(NT, 3)
swin_row_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap omap, const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + KV_OFF +
                                               p.kv_sets * SLOT_BYTES);
  uint64_t* kbar = qbar + 2;                  // [set]
  uint64_t* vbar = kbar + p.kv_sets;          // [set]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int it0 = blockIdx.x * p.items_per_block;
  const int it1 = min(p.items, it0 + p.items_per_block);

  // thread 0: K, then V, of item `it` into K/V set `set`
  auto load_kv = [&](int it, int set) {
    const int b = it / p.H, h = it % p.H;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uint64_t* bar = (w ? vbar : kbar) + set;
      mbar_expect_tx(bar, TILE_BYTES);
      tma_load_3d(sm + KV_OFF + set * SLOT_BYTES + w * TILE_BYTES, &qmap,
                  bar, (1 + w) * p.C + h * DH, 0, b);
    }
  };
  // thread 0: q of item `it` into q buffer `buf`
  auto load_q_of = [&](int it, int buf) {
    load_q<DH>(sm + Q_OFF, qbar, &qmap, it % p.H, 0, it / p.H, buf);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 + 2 * p.kv_sets; ++i) mbar_init(qbar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_q_of(it0, 0);
    load_kv(it0, 0);
    if (it0 + 1 < it1) {
      load_q_of(it0 + 1, 1);
      if (p.kv_sets == 2) load_kv(it0 + 1, 1);
    }
  }

  const int r_lo = warp * 16 + g;
  for (int it = it0; it < it1; ++it) {
    const int j = it - it0, buf = j & 1;
    const int set = p.kv_sets == 2 ? buf : 0;
    const uint32_t kv_parity = (p.kv_sets == 2 ? (j >> 1) : j) & 1;
    if (j > 0 && tid == 0) {
      // the previous item is done (its store staged after every thread's
      // final wgmma wait)
      if (p.kv_sets == 1) load_kv(it, 0);
      else if (it + 1 < it1) load_kv(it + 1, (j + 1) & 1);
    }
    const int b = it / p.H, h = it % p.H;
    const float* bias_h = p.bias + (long)h * p.N * p.N;
    const float* mask_w = p.mask != nullptr
                              ? p.mask + (long)(b % p.nW) * p.N * p.N
                              : nullptr;
    const uint8_t* kv = sm + KV_OFF + set * SLOT_BYTES;

    // s = q k^T, its bias and mask terms read while the wgmmas run
    float s[32];
    mbar_wait(qbar + buf, (j >> 1) & 1);
    mbar_wait(kbar + set, kv_parity);
    wgmma_fence();
    scores_n<DH, TAILN>(s, desc_kmajor64(sm + Q_OFF + buf * TILE_BYTES),
                        desc_kmajor64(kv));
    wgmma_commit();
    float bt[32], mt[32];
    fetch_terms<TAILN>(bt, mt, 0, r_lo, t, p.N, bias_h, mask_w);
    wgmma_wait0();
    if (tid == 0 && it + 2 < it1) load_q_of(it + 2, buf);  // buffer free

    // p = 2^(s - max) / sum in f32, rounded to bf16: the A operand of p v
    // (the single kernel's first pass took the sum against the running
    // maximum; over one tile that is the row maximum, so the sum is that
    // of p's numerators); a warp whose 16 rows all lie past N weighs
    // nothing
    uint32_t pa[4][4];
    if (warp * 16 < p.N) {
      add_terms<TAILN>(s, bt, mt, 0, r_lo, t, p.N, p.scale,
                       mask_w != nullptr);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j2 = 0; j2 < TAILN / 8; ++j2) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j2], s[4 * j2 + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j2 + 2], s[4 * j2 + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float ref0 = (mx0 == -INFINITY) ? 0.0f : mx0;
      const float ref1 = (mx1 == -INFINITY) ? 0.0f : mx1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int e = 0; e < TAILN / 2; ++e)
        s[e] = exp2f(s[e] - ((e & 2) ? ref1 : ref0));
#pragma unroll
      for (int j2 = 0; j2 < TAILN / 8; ++j2) {
        sum0 += s[4 * j2] + s[4 * j2 + 1];
        sum1 += s[4 * j2 + 2] + s[4 * j2 + 3];
      }
      const float l0 = quad_sum(sum0), l1 = quad_sum(sum1);
      const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
      const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
#pragma unroll
      for (int e = 0; e < TAILN / 2; ++e) s[e] *= (e & 2) ? inv1 : inv0;
#pragma unroll
      for (int kk = 0; kk < TAILN / 16; ++kk) acc_to_a(s, kk, pa[kk]);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    }
    // o = bf16(p) v, one group of wgmmas
    float o[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = 0.0f;
    mbar_wait(vbar + set, kv_parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TAILN / 16; ++kk)
      wgmma_rs32(o, pa[kk],
                 desc_mnmajor64(kv + TILE_BYTES + kk * 16 * DH * 2));
    wgmma_commit();
    wgmma_wait0();
    store_tile(o, sm + O_OFF, &omap, h, 0, b, tid);
  }
  if (tid == 0) tma_store_wait_all();
}

// ---------------------------------------------------------------------------
// Two-pass kernel: any N; one item (window, head, query tile) a block.  The
// uses of key tiles run in order, pass 1's K tiles 0 .. n_t - 1 then pass
// 2's K and V tiles, through a ring of two slots refilled by thread 0 as
// they free up.  Barriers: q, then one per slot.

__global__ void __launch_bounds__(NT, 2)
swin_two_pass_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap omap,
                     const Plan p) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* sm = aligned_smem(raw_smem);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + KV_OFF +
                                               2 * SLOT_BYTES);
  uint64_t* kbar = qbar + 1;                  // [slot]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = p.n_t;
  const int qt = blockIdx.x % n, bh = blockIdx.x / n;
  const int h = bh % p.H, b = bh / p.H;
  const float* bias_h = p.bias + (long)h * p.N * p.N;
  const float* mask_w = p.mask != nullptr
                            ? p.mask + (long)(b % p.nW) * p.N * p.N
                            : nullptr;

  // use u: K of key tile u (pass 1, u < n) or K and V of tile u - n
  auto issue = [&](int u) {
    const int st = u & 1, kt = u % n;
    uint8_t* slot = sm + KV_OFF + st * SLOT_BYTES;
    mbar_expect_tx(kbar + st, u < n ? TILE_BYTES : SLOT_BYTES);
    tma_load_3d(slot, &qmap, kbar + st, p.C + h * DH, kt * BM, b);
    if (u >= n)
      tma_load_3d(slot + TILE_BYTES, &qmap, kbar + st, 2 * p.C + h * DH,
                  kt * BM, b);
  };
  // slot of use u, its loads waited for
  auto acquire = [&](int u) -> const uint8_t* {
    mbar_wait(kbar + (u & 1), (u >> 1) & 1);
    return sm + KV_OFF + (u & 1) * SLOT_BYTES;
  };
  auto release = [&](int u) {                 // after use u's wgmmas
    named_sync(2, NT);
    if (tid == 0 && u + 2 < 2 * n) issue(u + 2);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(qbar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_q<DH>(sm + Q_OFF, qbar, &qmap, h, qt, b, 0);
    issue(0);
    issue(1);
  }
  mbar_wait(qbar, 0);
  const uint64_t dq = desc_kmajor64(sm + Q_OFF);
  const int r_lo = qt * BM + warp * 16 + g;

  // pass 1: running max and sum per row (log2 units)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  for (int kt = 0; kt < n; ++kt) {
    const uint8_t* slot = acquire(kt);
    float s[32];
    wgmma_fence();
    scores_n<DH, 64>(s, dq, desc_kmajor64(slot));
    wgmma_commit();
    wgmma_wait0();
    release(kt);
    bias_mask<64>(s, kt, r_lo, t, p.N, p.scale, bias_h, mask_w);
    online_stats<false>(s, m0, m1, l0, l1);
  }

  // pass 2: p = exp(s - max) / sum in bf16, o += p v
  const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
  const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  float o[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) o[e] = 0.0f;
  for (int kt = 0; kt < n; ++kt) {
    const uint8_t* slot = acquire(n + kt);
    float s[32];
    wgmma_fence();
    scores_n<DH, 64>(s, dq, desc_kmajor64(slot));
    wgmma_commit();
    wgmma_wait0();
    bias_mask<64>(s, kt, r_lo, t, p.N, p.scale, bias_h, mask_w);
    uint32_t pa[4][4];
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = exp2f(s[e] - ((e & 2) ? ref1 : ref0)) * ((e & 2) ? inv1 : inv0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs32(o, pa[kk],
                 desc_mnmajor64(slot + TILE_BYTES + kk * 16 * DH * 2));
    wgmma_commit();
    wgmma_wait0();
    release(n + kt);
  }
  store_tile(o, sm + O_OFF, &omap, h, qt, b, tid);
  if (tid == 0) tma_store_wait_all();
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, Plan);

// The row kernel for a window of N <= 64 tokens
Kernel row_kernel_for(int N) {
  const int tail = (N + 15) / 16;
  return tail == 1 ? swin_row_kernel<16>
         : tail == 2 ? swin_row_kernel<32>
         : tail == 3 ? swin_row_kernel<48>
                     : swin_row_kernel<64>;
}

}  // namespace

extern "C" {

// Opt the kernels (the attention kernels and the projection GEMM) in to
// the device's per-block shared memory limit on the current device,
// `device`; returns that limit in bytes, or -1.  Called once per device,
// before the first launch there.
int swin_attn_fwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  for (int n = 1; n <= BM; n += 16)
    if (set_smem(row_kernel_for(n), v)) return -1;
  if (set_smem(swin_two_pass_kernel, v)) return -1;
  if (gemm90::set_smem<0, 1, false>(v)) return -1;
  return v;
}

// The launches that `parts` names, on `stream`: PART_ATTN the attention
// (qkv, bias, mask -> o), PART_PROJ the projection (o, w -> out).  `shape`
// holds the shape and the plans of ops/fused_swin_attn.py, twelve ints:
// {B, N, C, H, nW, two_pass, items_per_block, kv_sets, attention shared
// memory, GEMM tile width, stages, GEMM shared memory} (a call is bound by
// the host's time at the smaller stages, and an array the wrapper keeps
// per shape costs less to pass than twelve ints).
// bias [H, N, N] f32, mask [nW, N, N] f32 or null.  Returns 0 when queued,
// a cudaError_t of a launch, 1000 + the CUresult of a tensor map that
// could not be encoded, or 2000 for a GEMM tile width with no kernel.  The
// caller checks shapes: C == H * 32, 16-byte aligned contiguous tensors,
// the plans' shared memory within the device's limit.
int swin_attn_fwd(const void* qkv, const void* w, const void* bias,
                  const void* mask, void* o, void* out, const int* shape,
                  float scale, int parts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int B = shape[0], N = shape[1], C = shape[2], H = shape[3];
  const int nW = shape[4];
  const int* plan = shape + 5;
  if (parts & PART_ATTN) {
    CUtensorMap qmap, omap;
    int err = encode_dh32(&qmap, qkv, 3ull * C, N, B);
    if (err == 0) err = encode_dh32(&omap, o, C, N, B);
    if (err != 0) return 1000 + err;
    Plan p;
    p.N = N;
    p.H = H;
    p.C = C;
    p.nW = nW;
    p.scale = scale;
    p.n_t = (N + BM - 1) / BM;
    p.items = B * H;
    p.items_per_block = plan[1];
    p.kv_sets = plan[2];
    p.bias = static_cast<const float*>(bias);
    p.mask = static_cast<const float*>(mask);
    // the two-pass kernel: a block per (window, head, query tile)
    const int blocks =
        plan[0] ? p.items * p.n_t
                : (p.items + p.items_per_block - 1) / p.items_per_block;
    const Kernel k = plan[0] ? swin_two_pass_kernel : row_kernel_for(N);
    k<<<blocks, NT, plan[3], s>>>(qmap, omap, p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (parts & PART_PROJ) {
    CUtensorMap amap, wmap, cmap;
    const uint64_t row = 2ull * C, M = (uint64_t)B * N;
    int err = encode_3d(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, o, C, M, 1,
                        row, row * M, 64, gemm90::BM);
    if (err == 0)
      err = encode_3d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, C, C, 1,
                      row, row * C, 64, gemm90::BK);
    if (err == 0)
      err = encode_3d(&cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, C, M, 1,
                      row, row * M, 64, 64);
    if (err != 0) return 1000 + err;
    gemm90::Args a;
    a.K = C;
    a.chunk = C;
    a.stages = plan[5];
    a.M = (int)M;
    a.N = C;
    a.out = nullptr;
    return gemm90::launch<0, 1, false>(amap, wmap, cmap, a, plan[4], 1,
                                       plan[6], s);
  }
  return 0;
}

}  // extern "C"
