// Memory-efficient multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel apla_tpu/ops/pallas_mha.py:_bwd_kernel (called
// through _call_bwd from the custom VJP's _vmem_bwd).  Contract, that
// kernel's, per image and head, on the packed activations:
//
//   qkv [B, N, 3C] bf16 (as the frozen qkv matmul emits it; C = H * 64),
//   dO  [B, N, C]  bf16 (cotangent of the attention output, heads merged)
//
//   p = softmax(mask(q k^T * scale)) in f32 (recomputed from q and k),
//   dv = bf16(p)^T dO,  dp = dO v^T,
//   ds = bf16((p * (dp - rowsum(dp * p))) * scale),  dq = ds k,  dk = ds^T q
//   dqkv [B, N, 3C] bf16 = [dq | dk | dv]
//
// every product accumulating in f32, rowsum(dp * p) on the f32 p, masked
// columns (past N; outside the row's segment when seg > 0) at weight 0.
// dqkv comes back packed, so autograd hands it to the qkv matmul's
// backward without a concatenation.  The TPU kernel pads N to a multiple of
// 16 and masks the padding; here TMA zero-fills the rows past N of every
// box, the tiles mask the ragged edge of N themselves, and rows past N are
// written nowhere.
//
// What bounds it on the H100: at the training micro-batch (B=8, N=257,
// C=768) it reads 4 and writes 3 [B, N, C] bf16 tensors (177 MB at b64)
// against 10 N^2 C FLOP per image (32.5 GFLOP at b64): the bytes bound it at
// the card's peaks (0.053 vs 0.033 ms at b64).  What the kernels execute is
// larger: the query side recomputes the scores three times and dO v^T
// twice, the key side both once more (nine products of 2 N^2 C per image
// where the bound counts five), the key tiles are padded to 64 rows, and
// each product waits for the softmax arithmetic around it, so the products
// on the tensor cores, not the bytes, set the pace.
//
// Design: the two launches of attn_bwd_sm90.cuh (query side: statistics,
// rowsum(dp * p), dq; key side: dk, dv), the same code the fused APLA
// backward runs, without the o_cat output that only the APLA dW needs:
// every product a wgmma, every load a TMA box, the other side's tiles
// resident in shared memory for N <= 320 and streamed through a ring
// beyond, with the launch plan of ops/mha.py:bwd_plan.

#include "attn_bwd_sm90.cuh"

typedef __nv_bfloat16 bf16;

extern "C" {

// Opt the kernels in to the device's per-block shared memory limit on the
// current device, `device`; returns that limit in bytes, or -1.  Called once
// per device, before the first launch there.
int mha_bwd_prepare(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return attn90::set_smem<false>(v) == 0 ? v : -1;
}

// The two launches on `stream` with the plan of ops/mha.py:bwd_plan
// (plan[5]: own tiles per block, resident, slots, the query side's and the
// key side's shared memory in bytes), those that `parts` names (2 the
// query side, 4 the key side); returns 0 when queued, a cudaError_t of a
// launch, or 1000 + the CUresult of a tensor map that could not be
// encoded.  The caller checks shapes
// (C == H*64, 16-byte aligned contiguous tensors, the plan's shared memory
// within the device's limit) and allocates dqkv [B, N, 3C] bf16 and the
// scratch stats [B, H, ceil(N / 64), 3, 64] f32.
int mha_bwd(const void* qkv, const void* dO, void* dqkv, void* stats, int B,
            int N, int C, int H, float scale, int seg, const int* plan,
            int parts, void* stream) {
  const attn90::LaunchPlan lp = {plan[0], plan[1], plan[2], plan[3],
                                 plan[4]};
  return attn90::launch<false>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dO), nullptr,
      static_cast<bf16*>(dqkv), static_cast<float*>(stats), B, N, C, H, scale,
      seg, lp, parts, (cudaStream_t)stream);
}

}  // extern "C"
