// Fused APLA attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel apla_tpu/ops/pallas_apla_attn.py:_bwd_kernel
// (called through _call_bwd from the custom VJP's _fused_bwd).  It also
// stands for the q-strip long backward, pallas_apla_attn_long.py:
// _bwda_kernel (dq, dW_t, delta; through _call_bwda) and _bwdb_kernel (dk,
// dv; through _call_bwdb): the five launches below cover any N and any
// Kp <= C (ViT-L/16 at 512 under APLA "full": N = 1025, C = Kp = 1024,
// dW_t from 16 x 16 tiles of 64 over two chunks of rows).  The long kernel
// forms delta as sum(dO * o) with o from the bf16 p; this one, as the
// monolithic kernel, as rowsum(dp * p) on the f32 p.  (The TPU kernel's
// biased variant for Swin windows, _bwd_kernel_bias, is swin_attn_bwd.cu.)
// Contract, exactly those kernels', per image:
//
//   qkv [B, N, 3C] bf16, w [C, W] bf16 (assembled projection, [d_in, d_out]),
//   g   [B, N, W]  bf16 (cotangent of the projected output),
//   g_t [B, N, Kp] bf16 (g's trainable columns g[..., inds], zero-padded)
//
// with W = C on one rank.  Under tensor parallelism (parallel/tensor.py)
// a rank holds H/T heads: C is their width (H/T) * 64, w its rows [C, W]
// of the projection (W the model width), and dW_t below is the rows [C, Kp]
// of the whole dW_t that those heads give.
//
//   dO   = bf16(g w^T)                              [N, C]
//   per head h: p = softmax(s) in f32 (recomputed), s as in the forward
//     (masked to the row's segment),
//     pb = bf16(p),  o = bf16(pb v),  dv = pb^T dO,  dp = dO v^T,
//     ds = bf16((p * (dp - rowsum(dp * p))) * scale),  dq = ds k,  dk = ds^T q
//   dqkv [B, N, 3C] bf16 = [dq | dk | dv]
//   dW_t [C, Kp]    f32  = sum over images and rows of o_cat^T g_t
//
// rounding where the TPU kernel rounds: dO, pb, o and ds are bf16, every
// product accumulates in f32, rowsum(dp * p) is taken on the f32 p (not
// FlashAttention-2's rowsum(dO * o)).  Masking as in the forward
// (mha_fwd.cu): -inf outside the row's segment and past N, a row with no
// valid column has p = 0.
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
//   5. dW reduce:   the partials summed in a fixed order (gemm_sm90.cuh:
//                   dw_reduce_kernel): deterministic.
// Each launch keeps the sum orders of the mma.sync kernels it replaced
// (the chunks of 4 too: ops/fused_apla_attn.py:dw_chunks), so dqkv and
// dW_t are theirs to the last bit (tools/compare_mha_fwd.py --kernel bwd).

#include "attn_bwd_sm90.cuh"
#include "gemm_sm90.cuh"

typedef __nv_bfloat16 bf16;

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
// multiple of 64 and every chunk non-empty.  W (`width`): w's and g's
// columns, a multiple of 64 (C on one rank).
int fused_apla_attn_bwd(const void* qkv, const void* w, const void* g,
                        const void* gt, void* dqkv, void* dwt, void* dO,
                        void* o_cat, void* stats, void* part, int B, int N,
                        int C, int width, int H, int Kp, float scale, int seg,
                        int chunk_rows, int n_chunks, const int* plan,
                        int parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * N;
  const uint64_t row = 2ull * C, g_row = 2ull * width;
  // 1. dO [M, C] = g [M, W] w^T: w [C, W] row-major is w^T's K-major form
  CUtensorMap amap, bmap, cmap;
  int err = sm90::encode_bf16_3d(&amap, g, width, M, 1, g_row, g_row * M,
                                 gemm90::BM);
  if (err == 0)
    err = sm90::encode_bf16_3d(&bmap, w, width, C, 1, g_row, g_row * C,
                               plan[5]);
  if (err == 0)
    err = sm90::encode_bf16_3d(&cmap, dO, C, M, 1, row, row * M, 64);
  if (err != 0) return 1000 + err;
  gemm90::Args a;
  a.K = width;
  a.chunk = width;
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
  return gemm90::reduce_chunks(static_cast<const float*>(part),
                               static_cast<float*>(dwt), n, n_chunks, s);
}

}  // extern "C"
