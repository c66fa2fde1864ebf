// What the prototype cross-entropy kernels share on Hopper (sm_90a):
// proto_ce_fwd.cu (the forward) and proto_ce_bwd.cu (dxs, dws).
//
// Both are a producer warpgroup and one or two consumer warpgroups a block,
// laid out by ops/proto_ce.py's launch plans (`Plan` below).  The forward
// and dxs stream the prototype layers ws, wt [256, K] as [256, 32] boxes
// (64-byte swizzle, read as the MN-major B of wgmma) through a TMA ring, the
// producer warp writing each stage's 32 centers beside it (`stream_w`), so
// the consumers read them from shared memory and not by global loads in the
// chain of each tile.

#pragma once

#include "sm90_async.cuh"

#include <math.h>

typedef __nv_bfloat16 bf16;

namespace proto {

using namespace sm90;

constexpr int D = 256;                     // bottleneck width
constexpr int OWN = 64;                    // own rows / columns a warpgroup
constexpr int BT = 32;                     // streamed columns / rows a tile
constexpr int UNIT = 64;                   // the partials' boundaries
constexpr int WG_THREADS = 128;
constexpr int HALF_STAGE = BT * D * 2;     // 16 KB: one streamed tile
constexpr int STAGE_BYTES = 2 * HALF_STAGE;          // s and t
constexpr float LOG2E = 1.4426950408889634f;

// A launch plan of ops/proto_ce.py (proto_fwd_plan, proto_bwd_plan), as the
// C entries take it (one int array).
struct Plan {
  int groups, stages, splits, per, smem, blocks_x;

  static Plan from(const int* v) {
    return {v[0], v[1], v[2], v[3], v[4], v[5]};
  }

  // whether a kernel needing `need` bytes of shared memory can run it
  bool valid(int need) const {
    return (groups == 1 || groups == 2) && stages >= 1 && splits >= 1
           && per >= 1 && blocks_x >= 1 && smem >= need;
  }
};

// A position in the ring: the slot and the parity of its fill.
struct Ring {
  int slot, phase;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Hand the producer warpgroup's registers to the consumers: with two
// consumer warpgroups the launch gives each thread 168 (65536 over 384
// threads); the producer needs few, the consumers' accumulators many.
template <int WG>
__device__ __forceinline__ void producer_regs() {
  if (WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}

template <int WG>
__device__ __forceinline__ void consumer_regs() {
  if (WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

// The producer warp's loop over the n streamed prototype tiles from column
// c_begin: each stage is ws, then wt, as [256, 32] boxes, and the tile's 32
// centers (0 at or past K) beside the ring in `cen` (lane l: column l, then
// its arrival on the slot's full barrier, lane 0's carrying the bytes).
// `full` counts 32 arrivals; `empty` is released by the consumers.
__device__ __forceinline__ void stream_w(uint8_t* ring, float* cen,
                                         uint64_t* full, uint64_t* empty,
                                         const CUtensorMap* wsmap,
                                         const CUtensorMap* wtmap,
                                         const float* __restrict__ c, int K,
                                         int c_begin, int n, int stages,
                                         int lane) {
  Ring r = {0, 0};
  for (int i = 0; i < n; ++i, r.next(stages)) {
    if (i >= stages) mbar_wait(empty + r.slot, r.phase ^ 1);
    const int col0 = c_begin + BT * i, col = col0 + lane;
    cen[r.slot * BT + lane] = col < K ? __ldg(c + col) : 0.f;
    if (lane == 0) {
      uint8_t* st = ring + r.slot * STAGE_BYTES;
      mbar_expect_tx(full + r.slot, STAGE_BYTES);
      tma_load_3d(st, wsmap, full + r.slot, col0, 0, 0);
      tma_load_3d(st + HALF_STAGE, wtmap, full + r.slot, col0, 0, 0);
    } else {
      mbar_arrive(full + r.slot);
    }
  }
}

// The tensor map of a prototype layer w [256, K] bf16 as stream_w reads it:
// boxes {32, 256} with the 64-byte swizzle.  Returns 0 or a CUresult.
inline int encode_w_stream(CUtensorMap* map, const void* w, int K) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, K, D, 1,
                   2ull * K, 2ull * K * D, BT, D, CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace proto
