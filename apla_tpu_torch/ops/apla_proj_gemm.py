"""The APLA output projection GEMM of the fused attention forward:
out[M, N] = o[M, K] @ w[K, N], bf16 in, f32 accumulated, bf16 out, or the
f32 sums themselves (`out_f32`).  K = N = C on one rank; under tensor
parallelism (`parallel.tensor`) a rank multiplies its heads' o [M, C/T]
by its rows of the projection [C/T, C] and writes the f32 partial, which
the model group sums.

The projection inside the TPU kernels `apla_tpu/ops/pallas_apla_attn.py:
_fwd_kernel` (its f32 `dot_general` of `o_cat` and `w` at :124-129, rounded
to the input dtype) and `apla_tpu/ops/pallas_apla_attn_long.py:_fwd_kernel`.
On the card the fused forward is two hand-written launches
(`ops/fused_apla_attn.py`): the attention (`csrc/mha_fwd.cu`) writes o, and
`csrc/apla_proj_gemm.cu` multiplies it by the assembled projection over the
flattened rows, so no image leaves a one-row tile.

`apla_proj_gemm` is the wrapper: on a CPU tensor it runs the plain version
(`apla_proj_gemm_reference`), on a CUDA tensor it launches the kernel or
raises, and `apla_proj_gemm.launches` counts its launches (one per call).
`launch` is the launch itself, uncounted, which the fused forward calls.
`gemm_plan` decides the kernel's tile width, stages and grid from the shape
alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .cuda_build import check_smem, device_smem, launch_context, \
    load_library
from .mha import BLOCK_RESERVED, BLOCK_SMEM, SM_SMEM, SMS

SOURCE = "apla_proj_gemm.cu"

# The kernel's units (`csrc/apla_proj_gemm.cu`): 128-row tiles (two
# warpgroups of 64), 64-deep stages of an o box (16 KB) and BN / 64 boxes
# of w (8 KB each); 1 KB aligns the base, 256 bytes hold the barriers.
BM = 128
BK = 64
FIXED_SMEM = 1024 + 256
WIDTHS = (128, 256)              # the kernel's instantiations
# Blocks of 288 threads that the registers (65536 an SM) let one SM hold,
# from the compiler's counts (`-Xptxas=-v`, `chip_smoke.py` phase 2): 90
# registers at 128 columns, 154 at 256.
REG_BLOCKS = {128: 2, 256: 1}
MAX_ROWS = 65535 * BM            # the grid's y extent, in rows


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How the kernel covers out [M, C] (`rows` x `width`): `row_tiles` x
    `col_tiles` blocks of BM x `bn`, each running a ring of `stages`
    stages."""
    rows: int
    width: int
    bn: int
    stages: int
    row_tiles: int
    col_tiles: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int

    def describe(self) -> str:
        return (f"{BM} x {self.bn} tiles, {self.row_tiles} x "
                f"{self.col_tiles} = {self.blocks} blocks "
                f"({self.blocks_per_sm} per SM), {self.stages} stages, "
                f"{self.smem_bytes} bytes of shared memory")


def stage_bytes(bn: int) -> int:
    return BM * BK * 2 + (bn // 64) * BK * 64 * 2


def smem_bytes(bn: int, stages: int) -> int:
    return FIXED_SMEM + stages * stage_bytes(bn)


@functools.lru_cache(maxsize=256)
def gemm_plan(M: int, C: int, bn: int | None = None,
              stages: int | None = None) -> GemmPlan:
    """The kernel's launch plan, a pure function of the shape: 128 x 256
    tiles over four stages (one block an SM) where they fill the SMs at
    least once, else 128 x 128 over three (two blocks an SM), the faster
    of the two on each side (`chip_smoke.py` phase 2 times both at every
    shape it times; `PERF.md` §6, PR 9).  `bn` and `stages` override the
    choice (a measurement may try others); the epilogue stages its bn / 64
    output boxes in the ring, so stages >= bn / 64."""
    if bn is None:
        bn = 256 if -(-M // BM) * -(-C // 256) >= SMS else 128
    if stages is None:
        stages = 4 if bn == 256 else 3
    if bn not in WIDTHS or not bn // 64 <= stages:
        raise ValueError(f"no GEMM plan with {bn} columns and {stages} "
                         "stages")
    smem = smem_bytes(bn, stages)
    if smem > BLOCK_SMEM:
        raise ValueError(f"{stages} stages of {bn} columns need {smem} "
                         f"bytes of shared memory, a block has "
                         f"{BLOCK_SMEM}")
    rows, cols = -(-M // BM), -(-C // bn)
    return GemmPlan(rows=M, width=C, bn=bn, stages=stages,
                    row_tiles=rows, col_tiles=cols,
                    blocks=rows * cols, smem_bytes=smem,
                    blocks_per_sm=min(REG_BLOCKS[bn],
                                      SM_SMEM // (smem + BLOCK_RESERVED)))


def apla_proj_gemm_reference(o, w, out_f32: bool = False):
    """Plain version: o [..., K] @ w [K, N] with products in f32 on the
    upcast inputs (as `preferred_element_type=f32` does), rounded to
    o.dtype (`out_f32`: the f32 sums)."""
    out = torch.matmul(o.float(), w.to(o.dtype).float())
    return out if out_f32 else out.to(o.dtype)


def check_args(o, w):
    """The kernel's contract, checked before a launch: -> (M, K, N)."""
    if o.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the projection GEMM takes bfloat16 o and w, got "
                         f"{o.dtype} and {w.dtype}")
    K = o.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"w must be [{K}, N], got {tuple(w.shape)}")
    N = w.shape[1]
    if K == 0 or K % 64 or N == 0 or N % 64:
        raise ValueError(f"the projection GEMM takes K and N each a "
                         f"multiple of 64, got {K} and {N}")
    if w.device != o.device:
        raise ValueError(f"o on {o.device}, w on {w.device}")
    if not (o.is_contiguous() and w.is_contiguous()) or \
            o.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("o and w must be contiguous and 16-byte aligned")
    M = o.numel() // K
    if not 0 < M <= MAX_ROWS:
        raise ValueError(f"{M} rows outside the kernel's grid")
    return M, K, N


@functools.cache
def _library():
    lib = load_library(SOURCE)
    lib.apla_proj_gemm.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.apla_proj_gemm.restype = ctypes.c_int
    lib.apla_proj_gemm_prepare.argtypes = [ctypes.c_int]
    lib.apla_proj_gemm_prepare.restype = ctypes.c_int
    return lib


def launch(o, w, stream, plan: GemmPlan, out_f32: bool = False):
    """Queues one launch of the kernel on `stream` (a raw stream handle of
    o's device, the current device), uncounted: -> out [..., N] (bf16, or
    f32 with `out_f32`).  o and w are checked by the caller (`check_args`,
    or a check that covers it); `plan` is `gemm_plan`'s for their shape
    (a measurement may pass another)."""
    lib = _library()
    check_smem(plan.smem_bytes,
               device_smem(_library, "apla_proj_gemm_prepare",
                           o.device.index), "the projection GEMM")
    K = w.shape[0]
    out = torch.empty(o.shape[:-1] + (plan.width,), device=o.device,
                      dtype=torch.float32 if out_f32 else o.dtype)
    err = lib.apla_proj_gemm(o.data_ptr(), w.data_ptr(), out.data_ptr(),
                             plan.rows, K, plan.width, plan.bn, plan.stages,
                             plan.smem_bytes, int(out_f32), stream)
    if err == 2000:
        raise RuntimeError(f"apla_proj_gemm: no kernel of {plan.bn} columns")
    if err >= 1000:
        raise RuntimeError(f"apla_proj_gemm: tensor map not encoded: "
                           f"CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"apla_proj_gemm launch failed: cudaError {err}")
    return out


def apla_proj_gemm(o, w, out_f32: bool = False):
    """o [..., K] @ w [K, N] -> [..., N] in bf16 (`out_f32`: the f32
    sums), f32 accumulated.

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (dtype, width, layout)."""
    if o.device.type == "cpu":
        return apla_proj_gemm_reference(o, w, out_f32)
    if o.device.type != "cuda":
        raise ValueError(f"no projection GEMM for device {o.device}")
    M, _, N = check_args(o, w)
    plan = gemm_plan(M, N)
    with launch_context(o) as stream:
        out = launch(o, w, stream, plan, out_f32)
    apla_proj_gemm.launches += 1
    return out


apla_proj_gemm.launches = 0
