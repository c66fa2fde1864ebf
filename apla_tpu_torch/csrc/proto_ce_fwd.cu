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
// 33.5 MB weights and 16 MB of rows, so the tensor cores bound it; it also
// takes 2 R K exponentials.
//
// Design.  The TPU grid runs the K blocks of a row tile in order and carries
// the online-softmax statistics in VMEM; on the card a block of 8 warps owns
// 64 rows (xs, xt resident in shared memory) and loops over a range of
// 64-column prototype tiles itself, the ws/wt tiles streamed by cp.async,
// double-buffered.  Each warp keeps, for its two fragment rows over its 32
// columns of every tile, the running max and sum of s and of t and the
// rescaled cross term sum exp(t - m_t) s (log2 units), and writes them as
// one partial.  When the rows alone give too few blocks for the 132 SMs (the
// DINO sites, R = 128 or 1024) the K range is split over blocks too.  A
// small second kernel merges the partials of a row in a fixed order into
// ce, lse_s and lse_t, so reruns are bit-equal.  mma.sync m16n8k16 with
// ldmatrix operand loads; wgmma/TMA are later work.

#include "proto_ce_common.cuh"

namespace {

using namespace proto;

constexpr size_t FWD_SMEM = (2 * (size_t)X_TILE + 4 * (size_t)W_TILE)
                            * sizeof(bf16);

// part [5][P][R]: m_s, l_s, m_t, l_t, a (log2 units), P = 2 * n_split.
__global__ void __launch_bounds__(NT, 1)
proto_ce_fwd_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ ws,
                    const bf16* __restrict__ xt, const bf16* __restrict__ wt,
                    const float* __restrict__ c, float* __restrict__ part,
                    int R, int K, int tiles_per_split, float ks, float kt) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs_s = reinterpret_cast<bf16*>(smem);
  bf16* xt_s = xs_s + X_TILE;
  bf16* wbuf = xt_s + X_TILE;            // [stage][s|t] W tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = (warp & 3) * 16, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BR, split = blockIdx.y;
  const int n_kt = (K + BK - 1) / BK;
  const int kt0 = split * tiles_per_split;
  const int n = min(n_kt, kt0 + tiles_per_split) - kt0;

  issue_x(xs_s, xs, row0, R, tid);
  issue_x(xt_s, xt, row0, R, tid);
  issue_w(wbuf, ws, kt0 * BK, K, tid);
  issue_w(wbuf + W_TILE, wt, kt0 * BK, K, tid);
  cp_async_commit();

  float m_s[2] = {-INFINITY, -INFINITY}, l_s[2] = {0.f, 0.f};
  float m_t[2] = {-INFINITY, -INFINITY}, l_t[2] = {0.f, 0.f};
  float a_t[2] = {0.f, 0.f};
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
    float s[4][4], tv[4][4];
    tile_logits(xs_s, wst, wrow, half, lane, s);
    tile_logits(xt_s, wst + W_TILE, wrow, half, lane, tv);
    scale_logits(s, tv, c, (kt0 + i) * BK + 32 * half, t, K, ks, kt);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx_s = -INFINITY, mx_t = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx_s = fmaxf(mx_s, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx_t = fmaxf(mx_t, fmaxf(tv[j][2 * r], tv[j][2 * r + 1]));
      }
      const float ns = fmaxf(m_s[r], quad_max(mx_s));
      const float nt = fmaxf(m_t[r], quad_max(mx_t));
      // a fragment whose columns are all past K keeps max -inf: its
      // reference point is 0 and every exp is 0, never exp(-inf - -inf)
      const float rs = (ns == -INFINITY) ? 0.f : ns;
      const float rt = (nt == -INFINITY) ? 0.f : nt;
      float sum_s = 0.f, sum_t = 0.f, cross = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sum_s += exp2f(s[j][e] - rs);
          const float et = exp2f(tv[j][e] - rt);
          sum_t += et;
          cross += et > 0.f ? et * s[j][e] : 0.f;   // s = -inf past K
        }
      const float sc_t = exp2f(m_t[r] - rt);
      l_s[r] = l_s[r] * exp2f(m_s[r] - rs) + quad_sum(sum_s);
      l_t[r] = l_t[r] * sc_t + quad_sum(sum_t);
      a_t[r] = a_t[r] * sc_t + quad_sum(cross);
      m_s[r] = ns;
      m_t[r] = nt;
    }
    __syncthreads();                      // stage i may be overwritten
  }

  if (t == 0) {
    const int P = 2 * gridDim.y, p = 2 * split + half;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + wrow + g + 8 * r;
      if (row >= R) continue;
      float* dst = part + (long)p * R + row;
      const long plane = (long)P * R;
      dst[0] = m_s[r];
      dst[plane] = l_s[r];
      dst[2 * plane] = m_t[r];
      dst[3 * plane] = l_t[r];
      dst[4 * plane] = a_t[r];
    }
  }
}

// Merge the P partials of each row, in order, into ce, lse_s, lse_t.
__global__ void proto_ce_combine_kernel(const float* __restrict__ part, int P,
                                        int R, float* __restrict__ ce,
                                        float* __restrict__ lse_s,
                                        float* __restrict__ lse_t) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const long plane = (long)P * R;
  float ms = -INFINITY, mt = -INFINITY;
  for (int p = 0; p < P; ++p) {
    ms = fmaxf(ms, part[(long)p * R + row]);
    mt = fmaxf(mt, part[2 * plane + (long)p * R + row]);
  }
  const float rs = (ms == -INFINITY) ? 0.f : ms;
  const float rt = (mt == -INFINITY) ? 0.f : mt;
  float ls = 0.f, lt = 0.f, a = 0.f;
  for (int p = 0; p < P; ++p) {
    const long i = (long)p * R + row;
    ls += part[plane + i] * exp2f(part[i] - rs);
    const float sc = exp2f(part[2 * plane + i] - rt);
    lt += part[3 * plane + i] * sc;
    a += part[4 * plane + i] * sc;
  }
  ls = fmaxf(ls, 1e-30f);
  lt = fmaxf(lt, 1e-30f);
  const float s_lse = (rs + log2f(ls)) * LN2;
  lse_s[row] = s_lse;
  lse_t[row] = (rt + log2f(lt)) * LN2;
  ce[row] = s_lse - (a / lt) * LN2;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the main kernel (bytes).
long long proto_ce_fwd_smem_bytes() { return (long long)FWD_SMEM; }

// Opt the main kernel in to its dynamic shared memory on the current device,
// `device`; returns the device's per-block opt-in limit in bytes, or -1.
// Called once per device, before the first launch there.
int proto_ce_fwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  if ((size_t)v < FWD_SMEM) return v;
  if (cudaFuncSetAttribute(proto_ce_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)FWD_SMEM) != cudaSuccess)
    return -1;
  return v;
}

// The two launches on `stream`; returns the first nonzero cudaError_t of a
// launch, or 0 when both are queued.  The caller checks shapes (D == 256,
// K % 8 == 0, contiguous 16-byte aligned tensors) and allocates part
// [5, 2 * n_split, R] f32, with n_split * tiles_per_split >= ceil(K / 64)
// and no split empty.
int proto_ce_fwd(const void* xs, const void* ws, const void* xt,
                 const void* wt, const void* c, void* part, void* ce,
                 void* lse_s, void* lse_t, int R, int K, int n_split,
                 int tiles_per_split, float inv_ts, float tau_t,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float LOG2E_ = mma::LOG2E;
  proto_ce_fwd_kernel<<<dim3((R + BR - 1) / BR, n_split), NT, FWD_SMEM, st>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(ws),
      static_cast<const bf16*>(xt), static_cast<const bf16*>(wt),
      static_cast<const float*>(c), static_cast<float*>(part), R, K,
      tiles_per_split, inv_ts * LOG2E_, LOG2E_ / tau_t);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  proto_ce_combine_kernel<<<(R + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), 2 * n_split, R,
      static_cast<float*>(ce), static_cast<float*>(lse_s),
      static_cast<float*>(lse_t));
  return (int)cudaGetLastError();
}

}  // extern "C"
