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
// The teacher side (xt, wt, c, tau_t) gets no gradient.  D is 256.
//
// What bounds them on the H100: each recomputes both logit blocks (4 R D K
// FLOP) and takes one more product (2 R D K), so 6 R D K = 1.65e12 FLOP at
// the iBOT site (R = 16384, K = 65536): >= 1.67 ms each at 989 TFLOP/s;
// the weights are 2 x 33.5 MB, so the tensor cores bound both.
//
// Design.  The TPU runs dxs with the K blocks in order (accumulating in the
// output block) and dws with the row tiles in order (the [D, BK] block
// revisited).  On the card:
//  * dxs: a block of 8 warps owns 64 rows (xs, xt resident) and loops over
//    the 64-column prototype tiles (ws, wt streamed, double-buffered): the
//    warps form ds for the tile in shared memory, then add ds ws_tile^T into
//    a [64, 256] f32 accumulator held in registers (warp: 16 rows x 128).
//    When the rows give too few blocks, the K range is split over blocks
//    with one f32 partial each.
//  * dws: a block owns one 64-column prototype tile (its ws, wt tiles
//    resident) and loops over 64-row tiles (xs, xt streamed): ds in shared
//    memory, then xs_tile^T ds into a [256, 64] f32 accumulator (warp: 32
//    rows).  When the prototype tiles give too few blocks, the rows are
//    split into chunks with one f32 partial each.
//  * partials are summed in a fixed order by a third kernel: no atomics, so
//    reruns are bit-equal.
// mma.sync m16n8k16 with ldmatrix operand loads; wgmma/TMA are later work.

#include "proto_ce_common.cuh"

namespace {

using namespace proto;

constexpr size_t DXS_SMEM = (2 * (size_t)X_TILE + 4 * (size_t)W_TILE
                             + (size_t)BR * LDT) * sizeof(bf16);
constexpr size_t DWS_SMEM = (4 * (size_t)X_TILE + 2 * (size_t)W_TILE
                             + (size_t)BR * LDT) * sizeof(bf16);

// ds of the warp's fragment -> the [64][LDT] ds tile.  ls2/lt2 are the rows'
// lse in log2 units, gs = g / tau_s (0 for rows at or past R).  A row with
// gs = 0 gets ds = 0 outright: past R its lse are placeholders and its exp
// may overflow, and 0 * inf would put a NaN into dws.
__device__ __forceinline__ void store_ds(bf16* ds_s, const float (&s)[4][4],
                                         const float (&tv)[4][4],
                                         const float (&ls2)[2],
                                         const float (&lt2)[2],
                                         const float (&gs)[2], int wrow,
                                         int half, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dst = ds_s + (wrow + g + 8 * r) * LDT + half * 32 + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d0 = 0.f, d1 = 0.f;
      if (gs[r] != 0.f) {                 // exp2(-inf) = 0 past K
        d0 = gs[r] * (exp2f(s[j][2 * r] - ls2[r])
                      - exp2f(tv[j][2 * r] - lt2[r]));
        d1 = gs[r] * (exp2f(s[j][2 * r + 1] - ls2[r])
                      - exp2f(tv[j][2 * r + 1] - lt2[r]));
      }
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(d0, d1);
    }
  }
}

// The fragment rows' saved statistics (log2 units) and scaled cotangent.
__device__ __forceinline__ void row_stats(const float* __restrict__ lse_s,
                                          const float* __restrict__ lse_t,
                                          const float* __restrict__ gr,
                                          int r_lo, int R, float inv_ts,
                                          float (&ls2)[2], float (&lt2)[2],
                                          float (&gs)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    const bool ok = row < R;
    ls2[r] = ok ? __ldg(lse_s + row) * LOG2E : 0.f;
    lt2[r] = ok ? __ldg(lse_t + row) * LOG2E : 0.f;
    gs[r] = ok ? __ldg(gr + row) * inv_ts : 0.f;
  }
}

// out [R, D] (or the split's partial): dxs of the block's 64 rows over its
// range of prototype tiles.
__global__ void __launch_bounds__(NT, 1)
proto_ce_dxs_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ ws,
                    const bf16* __restrict__ xt, const bf16* __restrict__ wt,
                    const float* __restrict__ c,
                    const float* __restrict__ lse_s,
                    const float* __restrict__ lse_t,
                    const float* __restrict__ gr, float* __restrict__ out,
                    int R, int K, int tiles_per_split, float ks, float kt,
                    float inv_ts) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs_s = reinterpret_cast<bf16*>(smem);
  bf16* xt_s = xs_s + X_TILE;
  bf16* wbuf = xt_s + X_TILE;            // [stage][s|t] W tiles
  bf16* ds_s = wbuf + 4 * W_TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = (warp & 3) * 16, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BR, split = blockIdx.y;
  const int n_kt = (K + BK - 1) / BK;
  const int kt0 = split * tiles_per_split;
  const int n = min(n_kt, kt0 + tiles_per_split) - kt0;
  float ls2[2], lt2[2], gs[2];
  row_stats(lse_s, lse_t, gr, row0 + wrow + g, R, inv_ts, ls2, lt2, gs);

  issue_x(xs_s, xs, row0, R, tid);
  issue_x(xt_s, xt, row0, R, tid);
  issue_w(wbuf, ws, kt0 * BK, K, tid);
  issue_w(wbuf + W_TILE, wt, kt0 * BK, K, tid);
  cp_async_commit();

  float acc[2][8][4];                    // rows wrow.., D cols 128*half..
  zero_acc(acc[0]);
  zero_acc(acc[1]);
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      bf16* nb = wbuf + ((i + 1) & 1) * 2 * W_TILE;
      issue_w(nb, ws, (kt0 + i + 1) * BK, K, tid);
      issue_w(nb + W_TILE, wt, (kt0 + i + 1) * BK, K, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wst = wbuf + (i & 1) * 2 * W_TILE;
    {
      float s[4][4], tv[4][4];
      tile_logits(xs_s, wst, wrow, half, lane, s);
      tile_logits(xt_s, wst + W_TILE, wrow, half, lane, tv);
      scale_logits(s, tv, c, (kt0 + i) * BK + 32 * half, t, K, ks, kt);
      store_ds(ds_s, s, tv, ls2, lt2, gs, wrow, half, g, t);
    }
    __syncthreads();                      // the ds tile is complete
    uint32_t a[4][4];
    load_a_rows(a, ds_s, wrow, lane);
    // dxs[rows, d] += sum_k ds[rows, k] ws[d, k]: the ws tile's rows are
    // the output columns, its columns the contraction
    warp_mma_nt(a, wst + (128 * half) * LDT, lane, acc[0]);
    warp_mma_nt(a, wst + (128 * half + 64) * LDT, lane, acc[1]);
    __syncthreads();                      // stage i and ds may be overwritten
  }

  float* dst = out + (long)split * R * D;
  const int r_lo = row0 + wrow + g;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 128 * half + 64 * q + 8 * j + 2 * t;
      if (r_lo < R)
        *reinterpret_cast<float2*>(dst + (long)r_lo * D + col) =
            make_float2(acc[q][j][0], acc[q][j][1]);
      if (r_lo + 8 < R)
        *reinterpret_cast<float2*>(dst + (long)(r_lo + 8) * D + col) =
            make_float2(acc[q][j][2], acc[q][j][3]);
    }
}

// out [D, K] (or the chunk's partial): dws of the block's prototype tile
// over its chunk of row tiles.
__global__ void __launch_bounds__(NT, 1)
proto_ce_dws_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ ws,
                    const bf16* __restrict__ xt, const bf16* __restrict__ wt,
                    const float* __restrict__ c,
                    const float* __restrict__ lse_s,
                    const float* __restrict__ lse_t,
                    const float* __restrict__ gr, float* __restrict__ out,
                    int R, int K, int tiles_per_chunk, float ks, float kt,
                    float inv_ts) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws_s = reinterpret_cast<bf16*>(smem);
  bf16* wt_s = ws_s + W_TILE;
  bf16* xbuf = wt_s + W_TILE;            // [stage][s|t] x tiles
  bf16* ds_s = xbuf + 4 * X_TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = (warp & 3) * 16, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * BK, chunk = blockIdx.y;
  const int n_rt = (R + BR - 1) / BR;
  const int rt0 = chunk * tiles_per_chunk;
  const int n = min(n_rt, rt0 + tiles_per_chunk) - rt0;

  issue_w(ws_s, ws, col0, K, tid);
  issue_w(wt_s, wt, col0, K, tid);
  issue_x(xbuf, xs, rt0 * BR, R, tid);
  issue_x(xbuf + X_TILE, xt, rt0 * BR, R, tid);
  cp_async_commit();

  float acc[2][8][4];                    // d rows 32*warp + 16*m.., 64 cols
  zero_acc(acc[0]);
  zero_acc(acc[1]);
  for (int i = 0; i < n; ++i) {
    const int row0 = (rt0 + i) * BR;
    if (i + 1 < n) {
      bf16* nb = xbuf + ((i + 1) & 1) * 2 * X_TILE;
      issue_x(nb, xs, row0 + BR, R, tid);
      issue_x(nb + X_TILE, xt, row0 + BR, R, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xst = xbuf + (i & 1) * 2 * X_TILE;
    {
      float ls2[2], lt2[2], gs[2];
      row_stats(lse_s, lse_t, gr, row0 + wrow + g, R, inv_ts, ls2, lt2, gs);
      float s[4][4], tv[4][4];
      tile_logits(xst, ws_s, wrow, half, lane, s);
      tile_logits(xst + X_TILE, wt_s, wrow, half, lane, tv);
      scale_logits(s, tv, c, col0 + 32 * half, t, K, ks, kt);
      store_ds(ds_s, s, tv, ls2, lt2, gs, wrow, half, g, t);
    }
    __syncthreads();                      // the ds tile is complete
    // dws[d, k] += sum_r xs[r, d] ds[r, k]: A = xs^T by ldmatrix.trans of
    // the row-major xs tile, B = the ds tile (contraction over its rows)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {      // rows 16kk .. 16kk+15
      uint32_t b[4][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
        ldsm_x4_t(b[nn][0], b[nn][1], b[nn][2], b[nn][3],
                  ds_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT
                       + nn * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t a[4];
        ldsm_x4_t(a[0], a[1], a[2], a[3],
                  xst + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDX
                      + 32 * warp + 16 * m + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          mma_bf16(acc[m][2 * nn], a, b[nn][0], b[nn][1]);
          mma_bf16(acc[m][2 * nn + 1], a, b[nn][2], b[nn][3]);
        }
      }
    }
    __syncthreads();                      // stage i and ds may be overwritten
  }

  float* dst = out + (long)chunk * D * K;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 32 * warp + 16 * m + g;
      const int col = col0 + 8 * j + 2 * t;
      if (col < K) {                      // K % 8 == 0: col + 1 < K too
        *reinterpret_cast<float2*>(dst + (long)d * K + col) =
            make_float2(acc[m][j][0], acc[m][j][1]);
        *reinterpret_cast<float2*>(dst + (long)(d + 8) * K + col) =
            make_float2(acc[m][j][2], acc[m][j][3]);
      }
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

int sum_partials(const float* part, int P, long n, float* out,
                 cudaStream_t st) {
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, P, n,
                                                                    out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the dxs (which = 0) or the dws (1) kernel.
long long proto_ce_bwd_smem_bytes(int which) {
  return (long long)(which == 0 ? DXS_SMEM : DWS_SMEM);
}

// Opt both kernels in to their dynamic shared memory on the current device,
// `device`; returns the device's per-block opt-in limit in bytes, or -1.
int proto_ce_bwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  if ((size_t)v < DXS_SMEM || (size_t)v < DWS_SMEM) return v;
  if (cudaFuncSetAttribute(proto_ce_dxs_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DXS_SMEM) != cudaSuccess ||
      cudaFuncSetAttribute(proto_ce_dws_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DWS_SMEM) != cudaSuccess)
    return -1;
  return v;
}

// dxs [R, D] f32 on `stream`.  n_split > 1: the K range is split over
// blocks, each writing its partial to part [n_split, R, D], summed in order
// into dxs.  Returns the first nonzero cudaError_t of a launch, or 0.
int proto_ce_dxs(const void* xs, const void* ws, const void* xt,
                 const void* wt, const void* c, const void* lse_s,
                 const void* lse_t, const void* g, void* dxs, void* part,
                 int R, int K, int n_split, int tiles_per_split,
                 float inv_ts, float tau_t, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* out = n_split > 1 ? static_cast<float*>(part)
                           : static_cast<float*>(dxs);
  proto_ce_dxs_kernel<<<dim3((R + BR - 1) / BR, n_split), NT, DXS_SMEM,
                        st>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(ws),
      static_cast<const bf16*>(xt), static_cast<const bf16*>(wt),
      static_cast<const float*>(c), static_cast<const float*>(lse_s),
      static_cast<const float*>(lse_t), static_cast<const float*>(g), out, R,
      K, tiles_per_split, inv_ts * LOG2E, LOG2E / tau_t, inv_ts);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_split == 1) return err;
  return sum_partials(out, n_split, (long)R * D, static_cast<float*>(dxs),
                      st);
}

// dws [D, K] f32 on `stream`.  n_chunks > 1: the row tiles are split into
// chunks, each writing its partial to part [n_chunks, D, K], summed in
// order into dws.  Returns the first nonzero cudaError_t of a launch, or 0.
int proto_ce_dws(const void* xs, const void* ws, const void* xt,
                 const void* wt, const void* c, const void* lse_s,
                 const void* lse_t, const void* g, void* dws, void* part,
                 int R, int K, int n_chunks, int tiles_per_chunk,
                 float inv_ts, float tau_t, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* out = n_chunks > 1 ? static_cast<float*>(part)
                            : static_cast<float*>(dws);
  proto_ce_dws_kernel<<<dim3((K + BK - 1) / BK, n_chunks), NT, DWS_SMEM,
                        st>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(ws),
      static_cast<const bf16*>(xt), static_cast<const bf16*>(wt),
      static_cast<const float*>(c), static_cast<const float*>(lse_s),
      static_cast<const float*>(lse_t), static_cast<const float*>(g), out, R,
      K, tiles_per_chunk, inv_ts * LOG2E, LOG2E / tau_t, inv_ts);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  return sum_partials(out, n_chunks, (long)D * K, static_cast<float*>(dws),
                      st);
}

}  // extern "C"
