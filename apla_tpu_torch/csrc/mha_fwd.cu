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
// the tiles mask the ragged edge of N themselves (zero-filled rows, -inf
// scores) and rows past N are written nowhere, so the caller passes q, k, v
// as the qkv matmul wrote them: no transpose, no padding copy.
//
// What bounds it on the H100: at the served shape (B=64, N=257, C=768) it
// reads qkv and writes out, 4 [B, N, C] bf16 tensors (101 MB), against
// 4 N^2 C FLOP per image (13.0 GFLOP): the bytes bound it at the card's
// peaks (0.030 vs 0.013 ms).  Executed work is larger: the scores are
// computed twice (below) over key tiles padded to 64 rows.
//
// Design (right first; wgmma/TMA are later work):
//  * one block of 4 warps per (64-row query tile, head, image); each warp
//    owns 16 query rows.  Shared memory holds the q tile and two k and two
//    v tiles (46 KB, static), so four blocks fit on an SM.
//  * products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix operand
//    loads; scores, p and the output stay in registers (FlashAttention-2
//    layout); key tiles arrive by cp.async, double-buffered.
//  * softmax in two passes over the key tiles, as fused_apla_attn_fwd.cu:
//    pass 1 keeps each row's running max and sum, pass 2 recomputes the
//    scores and forms the normalised p, so p is rounded to bf16 where the
//    TPU kernel rounds it and the p v accumulator never needs rescaling (a
//    one-pass online softmax would round p before the division).  A row with
//    no valid column keeps max -inf, its reference point is 0 and its p is
//    0, so exp(-inf - -inf) never occurs.
//  * with seg > 0 only the key tiles that meet the block's segments are
//    visited.

#include "mma_sm90.cuh"

namespace {

using namespace mma;

constexpr int NT = 128;              // 4 warps, 16 query rows each
constexpr int BM = 64;               // rows per tile
constexpr int DH = 64;               // head dim

__device__ __forceinline__ void issue(bf16* dst, const bf16* src, long stride,
                                      int row0, int n_rows, int tid) {
  issue_tile<NT>(dst, src, stride, row0, n_rows, tid);
}

__global__ void __launch_bounds__(NT)
mha_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
               int C, float scale_log2, int seg) {
  __shared__ __align__(128) bf16 smem[5 * TILE];
  bf16* qs = smem;
  bf16* kbuf[2] = {smem + TILE, smem + 2 * TILE};
  bf16* vbuf[2] = {smem + 3 * TILE, smem + 4 * TILE};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * BM;
  const long rs = 3L * C;
  const bf16* base = qkv + (long)b * N * rs;
  const bf16* qh = base + h * DH;
  const bf16* kh = base + C + h * DH;
  const bf16* vh = base + 2 * C + h * DH;
  const int r_lo = row0 + wrow + g, r_hi = r_lo + 8;

  // valid key range of each of the thread's two rows, and the key tiles
  // any row of the block can see
  int lo0 = 0, hi0 = N, lo1 = 0, hi1 = N;
  int kt0 = 0, kt1 = (N + BM - 1) / BM;
  if (seg > 0) {
    lo0 = (r_lo / seg) * seg; hi0 = min(N, lo0 + seg);
    lo1 = (r_hi / seg) * seg; hi1 = min(N, lo1 + seg);
    const int last = min(row0 + BM, N) - 1;
    kt0 = ((row0 / seg) * seg) / BM;
    kt1 = (min(N, (last / seg + 1) * seg) + BM - 1) / BM;
  }
  const int n_kt = kt1 - kt0;

  // ---- pass 1: running max and sum per row (log2 units) ----------------
  issue(qs, qh, rs, row0, N, tid);
  issue(kbuf[0], kh, rs, kt0 * BM, N, tid);
  cp_async_commit();
  uint32_t qa[4][4];
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
    if (i == 0) load_a_rows(qa, qs, wrow, lane);
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

  // ---- pass 2: p = exp(s - max) / sum in bf16, o += p v -----------------
  const float ref0 = (m0 == -INFINITY) ? 0.0f : m0;
  const float ref1 = (m1 == -INFINITY) ? 0.0f : m1;
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  float o[8][4];
  zero_acc(o);
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
    float p[8][4];
    warp_scores(qa, kbuf[i & 1], lane, p);
    scale_mask(p, (kt0 + i) * BM + 2 * t, scale_log2, lo0, hi0, lo1, hi1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = exp2f(p[j][0] - ref0) * inv0;
      p[j][1] = exp2f(p[j][1] - ref0) * inv0;
      p[j][2] = exp2f(p[j][2] - ref1) * inv1;
      p[j][3] = exp2f(p[j][3] - ref1) * inv1;
    }
    warp_mma_pv(p, vbuf[i & 1], lane, o);      // bf16(p) . v
    __syncthreads();
  }
  store_rows_bf16(out + ((long)b * N + row0 + wrow) * C + h * DH, C, o, r_lo,
                  N, g, t);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// The caller checks shapes: C == H * 64, B and H within the grid's 65535,
// 16-byte aligned contiguous tensors.
int mha_fwd(const void* qkv, void* out, int B, int N, int C, int H,
            float scale, int seg, void* stream) {
  const dim3 grid((N + BM - 1) / BM, H, B);
  mha_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, C,
      scale * LOG2E, seg);
  return (int)cudaGetLastError();
}

}  // extern "C"
