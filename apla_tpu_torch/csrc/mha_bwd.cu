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
// 16 and masks the padding; here the tiles mask the ragged edge of N
// themselves, and rows past N are written nowhere.
//
// What bounds it on the H100: at the training micro-batch (B=8, N=257,
// C=768) it reads 4 and writes 3 [B, N, C] bf16 tensors (177 MB at b64)
// against 10 N^2 C FLOP per image (32.5 GFLOP at b64): the bytes bound it at
// the card's peaks (0.053 vs 0.033 ms at b64).  Executed work is larger:
// the query side recomputes the scores three times, the key side once, and
// the key tiles are padded to 64 rows.
//
// Design: the two launches of attn_bwd.cuh (query side: statistics,
// rowsum(dp * p), dq; key side: dk, dv), the same code the fused APLA
// backward runs, without the o_cat output that only the APLA dW needs.

#include "attn_bwd.cuh"

extern "C" {

// Opt the kernels in to their dynamic shared memory on the current device,
// `device`; returns the device's per-block opt-in limit in bytes, or -1.
// Called once per device, before the first launch there.
int mha_bwd_prepare(int device) { return attn_bwd_prepare<false>(device); }

// Largest dynamic shared memory of the two launches (bytes).
long long mha_bwd_smem_bytes() { return (long long)BWD_SMEM; }

// The two launches on `stream`; returns the first nonzero cudaError_t of a
// launch, or 0 when both are queued.  The caller checks shapes (C == H*64,
// 16-byte aligned contiguous tensors) and allocates dqkv [B, N, 3C] bf16
// and the scratch stats [3, B, H, N] f32.
int mha_bwd(const void* qkv, const void* dO, void* dqkv, void* stats, int B,
            int N, int C, int H, float scale, int seg, void* stream) {
  return attn_bwd_launch<false>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dO), nullptr,
      static_cast<bf16*>(dqkv), static_cast<float*>(stats), B, N, C, H, scale,
      seg, (cudaStream_t)stream);
}

}  // extern "C"
