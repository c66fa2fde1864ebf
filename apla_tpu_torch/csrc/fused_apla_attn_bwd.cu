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
//                   (2 and 3 live in attn_bwd.cuh, shared with mha_bwd.cu)
//   4. dW partials: o_cat^T g_t over chunks of rows, one f32 partial per
//                   chunk (no atomics)
//   5. dW reduce:   the partials summed in a fixed order: deterministic.
// Products use mma.sync m16n8k16 with ldmatrix operand loads; tiles arrive
// by cp.async, double-buffered.  wgmma/TMA are later work.

#include "attn_bwd.cuh"

namespace {

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
  return attn_bwd_prepare<true>(device);
}

// Largest dynamic shared memory of the five launches (bytes).
long long fused_apla_attn_bwd_smem_bytes() { return (long long)BWD_SMEM; }

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

  err = attn_bwd_launch<true>(qkv_, dO_, o_, dqkv_, stats_, B, N, C, H, scale,
                              seg, s);
  if (err != 0) return err;

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
