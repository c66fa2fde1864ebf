// Fused APLA attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel apla_tpu/ops/pallas_apla_attn.py:_bwd_kernel
// (called through _call_bwd from the custom VJP's _fused_bwd) and, for Swin
// windows, its biased variant _bwd_kernel_bias (called through
// _call_bwd_swin from _fused_swin_bwd): one body, as on the TPU.  It also
// stands for the q-strip long backward, pallas_apla_attn_long.py:
// _bwda_kernel (dq, dW_t, delta; through _call_bwda) and _bwdb_kernel (dk,
// dv; through _call_bwdb): the five launches below cover any N and any
// Kp <= C (ViT-L/16 at 512 under APLA "full": N = 1025, C = Kp = 1024,
// dW_t from 16 x 16 tiles of 64 over two chunks of rows).  The long kernel
// forms delta as sum(dO * o) with o from the bf16 p; this one, as the
// monolithic kernel, as rowsum(dp * p) on the f32 p.
// Contract, exactly those kernels', per image (or window):
//
//   qkv [B, N, 3C] bf16, w [C, C] bf16 (assembled projection, [d_in, d_out]),
//   g   [B, N, C]  bf16 (cotangent of the projected output),
//   g_t [B, N, Kp] bf16 (g's trainable columns g[..., inds], zero-padded;
//                        Swin trains the whole projection: g_t = g, Kp = C)
//
//   dO   = bf16(g w^T)                              [N, C]
//   per head h: p = softmax(s) in f32 (recomputed), s as in the forward
//     (masked to the row's segment; Swin: + bias[h] + mask[b mod nW]),
//     pb = bf16(p),  o = bf16(pb v),  dv = pb^T dO,  dp = dO v^T,
//     ds = bf16((p * (dp - rowsum(dp * p))) * scale),  dq = ds k,  dk = ds^T q
//   dqkv [B, N, 3C] bf16 = [dq | dk | dv]
//   dW_t [C, Kp]    f32  = sum over images and rows of o_cat^T g_t
//
// rounding where the TPU kernel rounds: dO, pb, o and ds are bf16, every
// product accumulates in f32, rowsum(dp * p) is taken on the f32 p (not
// FlashAttention-2's rowsum(dO * o)).  Masking as in the forwards
// (mha_fwd.cu, swin_attn_fwd.cu): -inf outside the row's segment and past
// N, a row with no valid column has p = 0.
//
// What bounds it on the H100: the products.  At the training micro-batch
// (B=8, N=257, C=768, 12 heads, k=128) and the segmenter's (B=8, N=1025,
// C=k=1024, 16 heads) every product is a bf16 tensor-core product and the
// bound counts operations: dO = g w^T and dW_t (2 N C^2 and 2 N C k per
// image) and six 2 N^2 C attention products.  What the attention kernels
// execute is larger (11 products per pair of 64-row tiles; the scores are
// recomputed in each pass rather than kept, see attn_bwd_sm90.cuh), so
// each product must run at the wgmma rate: every product is a wgmma fed by
// TMA, and the other side's tiles stay in shared memory where they fit.
// Swin windows (N=49, head dim 32) are small: at stage 0 of a b16 batch
// the bytes bound them, and the dW sum over 1024 x 49 rows is the widest
// reduction.
//
// The TPU grid runs images in order and carries dW_t in VMEM across them;
// blocks on the card run in parallel, so the work is split in five launches
// (FlashAttention-2's split of the attention backward, plus two GEMMs):
//   1. dO = g w^T:  gemm_sm90.cuh (g K-major, w read in place as a K-major
//                   B), bf16 out, one f32 sum over C in k16 order
//   2. query side:  per (64-row query tile, head, image): softmax statistics,
//                   o (-> o_cat scratch), rowsum(dp * p), then dq
//   3. key side:    per (64-row key tile, head, image): dk, dv, reading the
//                   statistics written by 2
//                   (2 and 3 live in attn_bwd_sm90.cuh, shared with
//                   mha_bwd.cu)
//   4. dW partials: o_cat^T g_t over chunks of rows (gemm_sm90.cuh with
//                   o_cat an MN-major A and g_t an MN-major B, f32 out), one
//                   partial per chunk (no atomics)
//   5. dW reduce:   the partials summed in a fixed order: deterministic.
// Each launch keeps the sum orders of the mma.sync kernels it replaced
// (the chunks of 4 too: ops/fused_apla_attn.py:dw_chunks), so dqkv and
// dW_t are theirs to the last bit (tools/compare_mha_fwd.py --kernel bwd).
//
// The Swin windows (fused_swin_attn_bwd, head dim 32, bias and mask, TPU
// row 4) keep the earlier body: attn_bwd.cuh's mma.sync query and key
// sides (cp.async tiles, double-buffered) and the mma.sync GEMMs below,
// TW = 64 wide or 32 where C is not a multiple of 64 (Swin-T's stage 0,
// C = 96).  Their forward (row 3) became TMA/wgmma launches in
// swin_attn_fwd.cu; this backward is queued for the same redesign
// (ROADMAP B).

#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

// ---- 1. C[M, N] = bf16(A[M, K] B[N, K]^T), K and N multiples of TW -------
// A block computes 64 rows x TW columns in TW-deep steps.
template <int TW>
__global__ void __launch_bounds__(NT)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
               bf16* __restrict__ Cm, int M, int N, int K) {
  __shared__ __align__(128) bf16 sa[2][TILE];
  __shared__ __align__(128) bf16 sb[2][TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TW;
  const int nk = K / TW;
  float acc[TW / 8][4];
  zero_acc(acc);
  issue<TW>(sa[0], A, K, m0, M, tid);
  issue<TW, TW>(sb[0], B, K, n0, N, tid);
  cp_async_commit();
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) {
      issue<TW>(sa[(i + 1) & 1], A + (i + 1) * TW, K, m0, M, tid);
      issue<TW, TW>(sb[(i + 1) & 1], B + (i + 1) * TW, K, n0, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t a[TW / 16][4];
    load_a_rows(a, sa[i & 1], wrow, lane);
    warp_mma_nt(a, sb[i & 1], lane, acc);
    __syncthreads();
  }
  store_rows_bf16(Cm + (long)(m0 + wrow) * N + n0, N, acc, m0 + wrow + g, M,
                  g, t);
}

// ---- 4. dW_t partials: part[z] = o_cat[rows of chunk z]^T g_t[same rows] --
// A block sums a TW x TW tile of dW_t over its chunk's rows, 64 per step.
// The 4 warps split the tile into 16-row strips (TW = 64: one strip each,
// all 64 columns; TW = 32: two strips, 16 columns each).
template <int TW>
__global__ void __launch_bounds__(NT)
dw_partial_kernel(const bf16* __restrict__ o, const bf16* __restrict__ gt,
                  float* __restrict__ part, int M, int C, int Kp,
                  int chunk_rows) {
  constexpr int WARPS_I = TW / 16;           // warps along dW_t's rows
  constexpr int WJ = TW / (4 / WARPS_I);     // columns per warp
  __shared__ __align__(128) bf16 so[2][TILE];
  __shared__ __align__(128) bf16 sg[2][TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp % WARPS_I) * 16, wcol = (warp / WARPS_I) * WJ;
  const int i0 = blockIdx.x * TW, j0 = blockIdx.y * TW;
  const int m_begin = blockIdx.z * chunk_rows;
  const int m_end = min(M, m_begin + chunk_rows);
  const int n_steps = (m_end - m_begin + BM - 1) / BM;
  float acc[WJ / 8][4];
  zero_acc(acc);
  if (n_steps > 0) {
    issue<TW>(so[0], o + i0, C, m_begin, m_end, tid);
    issue<TW>(sg[0], gt + j0, Kp, m_begin, m_end, tid);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      const int r = m_begin + (s + 1) * BM;
      issue<TW>(so[(s + 1) & 1], o + i0, C, r, m_end, tid);
      issue<TW>(sg[(s + 1) & 1], gt + j0, Kp, r, m_end, tid);
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
      for (int nn = 0; nn < WJ / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  gtt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT
                      + wcol + nn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nn], a, b0, b1);
        mma_bf16(acc[2 * nn + 1], a, b2, b3);
      }
    }
    __syncthreads();
  }
  float* dst = part + ((long)blockIdx.z * C + i0 + wrow + g) * Kp + j0 + wcol
               + 2 * t;
#pragma unroll
  for (int j = 0; j < WJ / 8; ++j) {
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

// Steps 1, 4 and 5 around the attention launches `attn` (2 and 3) on `s`:
// returns the first nonzero cudaError_t of a launch, or 0.
template <int TW, class Attn>
int bwd_launches(const bf16* g, const bf16* w, const bf16* gt, bf16* dO,
                 const bf16* o_cat, float* dwt, float* part, int M, int C,
                 int Kp, int chunk_rows, int n_chunks, cudaStream_t s,
                 Attn attn) {
  gemm_nt_kernel<TW><<<dim3(C / TW, (M + BM - 1) / BM), NT, 0, s>>>(
      g, w, dO, M, C, C);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if ((err = attn()) != 0) return err;
  dw_partial_kernel<TW><<<dim3(C / TW, Kp / TW, n_chunks), NT, 0, s>>>(
      o_cat, gt, part, M, C, Kp, chunk_rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const long n = (long)C * Kp;
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, dwt, n,
                                                               n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Opt the ViT kernels (the two attention sides, the two GEMMs) in to the
// device's per-block shared memory limit on the current device, `device`;
// returns that limit in bytes, or -1.  Called once per device, before the
// first launch there.
int fused_apla_attn_bwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  if (attn90::set_smem<true>(v) != 0 ||
      gemm90::set_smem<0, 0, false>(v) != 0 ||
      gemm90::set_smem<1, 1, true>(v) != 0)
    return -1;
  return v;
}

// The Swin window backward's counterpart of fused_apla_attn_bwd_prepare.
int fused_swin_attn_bwd_prepare(int device) {
  return attn_bwd_prepare<true, 32, true>(device);
}

// Largest dynamic shared memory of the Swin window backward's launches
// (bytes).
long long fused_apla_attn_bwd_smem_bytes() { return (long long)BWD_SMEM; }

// The five launches on `stream`, those that `parts` names (1 the dO GEMM,
// 2 the query side, 4 the key side, 8 the dW partials and their sum), with
// the plan `plan[11]`: the attention's (ops/mha.py:bwd_plan: own tiles
// per block, resident, slots, the query side's and the key side's shared
// memory), then the dO GEMM's and the dW GEMM's
// (ops/apla_proj_gemm.py:gemm_plan: tile width, stages, shared memory).
// Returns 0 when all are queued, a cudaError_t of a launch, 1000 + the
// CUresult of a tensor map that could not be encoded, or 2000 for a GEMM
// width with no kernel.  The caller
// checks shapes (C == H*64, Kp a multiple of 64, 16-byte aligned contiguous
// tensors, the plan's shared memory within the device's limit) and
// allocates the scratch: dO and o_cat [B, N, C] bf16, stats [B, H,
// ceil(N / 64), 3, 64] f32, part [n_chunks, C, Kp] f32, with chunk_rows a
// multiple of 64 and every chunk non-empty.
int fused_apla_attn_bwd(const void* qkv, const void* w, const void* g,
                        const void* gt, void* dqkv, void* dwt, void* dO,
                        void* o_cat, void* stats, void* part, int B, int N,
                        int C, int H, int Kp, float scale, int seg,
                        int chunk_rows, int n_chunks, const int* plan,
                        int parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * N;
  const uint64_t row = 2ull * C;
  // 1. dO [M, C] = g [M, C] w^T: w [C, C] row-major is w^T's K-major form
  CUtensorMap amap, bmap, cmap;
  int err = sm90::encode_bf16_3d(&amap, g, C, M, 1, row, row * M,
                                 gemm90::BM);
  if (err == 0)
    err = sm90::encode_bf16_3d(&bmap, w, C, C, 1, row, row * C, plan[5]);
  if (err == 0)
    err = sm90::encode_bf16_3d(&cmap, dO, C, M, 1, row, row * M, 64);
  if (err != 0) return 1000 + err;
  gemm90::Args a;
  a.K = C;
  a.chunk = C;
  a.stages = plan[6];
  a.M = M;
  a.N = C;
  a.out = nullptr;
  if ((parts & attn90::PART_DO) &&
      (err = gemm90::launch<0, 0, false>(amap, bmap, cmap, a, plan[5], 1,
                                          plan[7], s)) != 0)
    return err;
  // 2, 3. the attention
  const attn90::LaunchPlan lp = {plan[0], plan[1], plan[2], plan[3],
                                 plan[4]};
  if ((err = attn90::launch<true>(
           static_cast<const bf16*>(qkv), static_cast<const bf16*>(dO),
           static_cast<bf16*>(o_cat), static_cast<bf16*>(dqkv),
           static_cast<float*>(stats), B, N, C, H, scale, seg, lp, parts,
           s)) != 0)
    return err;
  if (!(parts & attn90::PART_DW)) return 0;
  // 4. part[z] [C, Kp] = o_cat[chunk z]^T g_t[chunk z]: both row-major over
  //    the M rows, so o_cat^T is an MN-major A and g_t an MN-major B
  err = sm90::encode_bf16_3d(&amap, o_cat, C, M, 1, row, row * M, 64);
  if (err == 0)
    err = sm90::encode_bf16_3d(&bmap, gt, Kp, M, 1, 2ull * Kp, 2ull * Kp * M,
                               64);
  if (err != 0) return 1000 + err;
  a.K = M;
  a.chunk = chunk_rows;
  a.stages = plan[9];
  a.M = C;
  a.N = Kp;
  a.out = static_cast<float*>(part);
  if ((err = gemm90::launch<1, 1, true>(amap, bmap, amap, a, plan[8],
                                         n_chunks, plan[10], s)) != 0)
    return err;
  // 5. dW_t = the partials summed, chunk 0 first
  const long n = (long)C * Kp;
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dwt), n,
      n_chunks);
  return (int)cudaGetLastError();
}

// The Swin window backward (head dim 32, the whole projection trainable):
// as fused_apla_attn_bwd with g_t = g and Kp = C, bias [H, N, N] f32 and
// mask [nW, N, N] f32 or null, on the mma.sync body.  The caller checks
// shapes (C == H*32, C a multiple of 32) and allocates the scratch: dO and
// o_cat [B, N, C] bf16, stats [3, B, H, N] f32, part [n_chunks, C, C] f32,
// with n_chunks * chunk_rows >= B * N.
int fused_swin_attn_bwd(const void* qkv, const void* w, const void* g,
                        const void* bias, const void* mask, void* dqkv,
                        void* dw, void* dO, void* o_cat, void* stats,
                        void* part, int B, int N, int C, int H, int nW,
                        float scale, int chunk_rows, int n_chunks,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* qkv_ = static_cast<const bf16*>(qkv);
  const bf16* g_ = static_cast<const bf16*>(g);
  const bf16* w_ = static_cast<const bf16*>(w);
  bf16* dO_ = static_cast<bf16*>(dO);
  bf16* o_ = static_cast<bf16*>(o_cat);
  float* dw_ = static_cast<float*>(dw);
  float* part_ = static_cast<float*>(part);
  auto attn = [&] {
    return attn_bwd_launch<true, 32, true>(
        qkv_, dO_, o_, static_cast<bf16*>(dqkv), static_cast<float*>(stats),
        B, N, C, H, scale, 0, s, static_cast<const float*>(bias),
        static_cast<const float*>(mask), nW);
  };
  if (C % 64 == 0)
    return bwd_launches<64>(g_, w_, g_, dO_, o_, dw_, part_, B * N, C, C,
                            chunk_rows, n_chunks, s, attn);
  return bwd_launches<32>(g_, w_, g_, dO_, o_, dw_, part_, B * N, C, C,
                          chunk_rows, n_chunks, s, attn);
}

}  // extern "C"
