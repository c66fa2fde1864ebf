"""Fused Swin window attention: softmax(q k^T * scale + bias + mask) v over
each window and the whole (trainable) output projection, and its backward.

Counterpart of `apla_tpu/ops/pallas_apla_attn.py:fused_swin_attention` and
its custom VJP.  Hand-written CUDA kernels replace the TPU kernels:

- `fused_swin_attn_fwd` replaces `pallas_apla_attn.py:_fwd_kernel_bias`
  (through `_call_fwd_swin`): per window and head, f32 scores
  `(q k^T * scale + bias[h]) + mask[b mod nW]`, p normalised in f32 and
  rounded to bf16, p v, the heads concatenated (bf16) and multiplied by the
  `[C, C]` projection in f32, stored as bf16.  On the card that is two
  launches of `csrc/swin_attn_fwd.cu`, queued by one C call and split at
  the head concatenation: a head-dim-32 TMA/`wgmma` attention writes o
  `[B, N, C]` to a scratch tensor (launch plan `swin_plan`), and the
  projection GEMM of `csrc/gemm_sm90.cuh` (the ViT forward's, plan
  `proj_plan`) multiplies it by w over the B * N rows.  Both keep the
  rounding points and sum orders of the single kernel they replaced, so
  the output is its bit for bit.  The projection's bias is added outside
  the kernels, in the output dtype.
- `fused_swin_attn_bwd` replaces `pallas_apla_attn.py:_bwd_kernel_bias`
  (through `_call_bwd_swin`): `dO = bf16(g W^T)`, p recomputed, `dq/dk/dv`
  packed `[B, N, 3C]`, and `dW = o_cat^T g` summed in f32 over every window
  and row.  On the card that is `csrc/swin_attn_bwd.cu`'s three launches,
  queued by one C call: the dO GEMM (`csrc/gemm_sm90.cuh`), a head-dim-32
  TMA/`wgmma` attention over items (window, head) that reads each tile and
  each bias and mask term once (launch plan `swin_bwd_plan`) and writes
  dqkv and the scratch o_cat, then the dW GEMM over fixed chunks of rows
  and the partials' fixed-order sum (reruns are bit-equal).  dqkv and dW
  are, bit for bit, those of the first port's `mma.sync` kernel.

Windows are `[B, N, 3C]` with B = images x windows, the image outermost
(`models.swin._window_partition`), so window b's mask plane is `b mod nW`.
N = 49 is one 64-row tile; the kernels mask its 15 padded rows and columns
themselves (the TPU wrapper's padding copies are layout choices, not part
of the function).

`fused_swin_attn_fwd` / `fused_swin_attn_bwd` are the wrappers: on a CPU
tensor they run the plain PyTorch versions below (`*_reference`), on a
CUDA tensor they launch the kernels or raise.  Each wrapper's `launches`
counts its calls that launched (one per call, and nothing else).
`fused_swin_attn_fwd_part` and `fused_swin_attn_bwd_part` queue some of a
call's launches, uncounted, for a measurement.  `FusedSwinAttention` is the
autograd `Function` over both, with the JAX custom VJP's contract:
differentiable in qkv, w and b; the bias and mask are frozen and get no
gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .apla_proj_gemm import apla_proj_gemm_reference, gemm_plan
from .cuda_build import check_smem, device_index, device_smem, \
    launch_context, load_library
from .fused_apla_attn import DW_GEMM, dw_chunks
from .mha import (BLOCK_RESERVED, BLOCK_SMEM, SM_SMEM, SMS, attention_grads,
                  merge_heads, plan_array, softmax_f32, split_heads)

_SOURCE = "swin_attn_fwd.cu"
_BWD_SOURCE = "swin_attn_bwd.cu"
HEAD_DIM = 32          # the Swin kernels' head dim (every Swin builder's)

# The attention launch's plan (`swin_plan`), in the units of
# `csrc/swin_attn_fwd.cu`: 64-row query and key tiles of 32 columns (4 KB);
# a K/V slot holds one key tile of K and one of V (8 KB); a block's
# warpgroup has two q tiles and an output tile (12 KB); 1 KB aligns the
# base, 512 bytes hold the barriers.
TILE = 64
TILE_BYTES = TILE * HEAD_DIM * 2
SLOT_BYTES = 2 * TILE_BYTES
FIXED_SMEM = 3 * TILE_BYTES + 1024 + 512
# Blocks of 128 threads that the registers (65536 an SM) let one SM hold,
# from the kernels' launch bounds and the compiler's counts (`-Xptxas=-v`,
# `chip_smoke.py` phase 1): the row kernel (one key tile, N <= 64: every
# Swin-T window) 153 registers, the two-pass kernel 96.
REG_BLOCKS = {"row": 3, "two_pass": 2}
# `parts` of `fused_swin_attn_fwd_part`: which launches a call queues
PART_ATTN, PART_PROJ = 1, 2

# The backward's attention launch (`swin_bwd_plan`), in the units of
# `csrc/swin_attn_bwd.cu`: an input set is an item's q, k, v and dO tiles
# (16 KB); the staged pb and ds are 8 KB each.  The row kernel (N <= 64)
# has `sets` sets, pb and ds (where its four output tiles are staged
# next); the tiles kernel (N > 64) an item's 4 n_t tiles, pb, ds, one
# output tile and the statistics (three f32 per query row).  1 KB aligns
# the base, 64 bytes hold the barriers.
BWD_SET_BYTES = 4 * TILE_BYTES
BWD_STAGED_BYTES = 2 * TILE_BYTES
BWD_ROW_FIXED = 2 * BWD_STAGED_BYTES + 1024 + 64
BWD_STAT_BYTES = 3 * TILE * 4
# Blocks of 128 threads that the registers let one SM hold, from the
# kernels' launch bounds (`-Xptxas=-v`, `chip_smoke.py` phase 8a): the row
# kernel at most 128 registers, the tiles kernel 255.
BWD_REG_BLOCKS = {"row": 4, "tiles": 2}
# `parts` of `fused_swin_attn_bwd_part`: the dO GEMM, the attention, the
# dW partials and their sum
BWD_DO, BWD_ATTN, BWD_DW = 1, 2, 4
BWD_PARTS_ALL = BWD_DO | BWD_ATTN | BWD_DW


def _terms(bias, mask, batch):
    """The additive score terms: bias [H, N, N] for every window, then
    mask [nW, N, N] at window b's index b mod nW (None: no mask)."""
    terms = (bias.float()[None],)
    if mask is not None:
        idx = torch.arange(batch, device=mask.device) % mask.shape[0]
        terms += (mask.float()[idx][:, None],)
    return terms


def fused_swin_attn_fwd_reference(qkv, w, bias, mask, num_heads: int,
                                  scale: float):
    """Plain version of the forward kernel, rounding where the TPU kernel
    rounds (`pallas_apla_attn.py:_fwd_kernel` with bias and mask).

    qkv [B, N, 3C], w [C, C], bias [H, N, N], mask [nW, N, N] or None ->
    [B, N, C] in qkv.dtype, without the projection's bias."""
    return apla_proj_gemm_reference(
        swin_attn_reference(qkv, bias, mask, num_heads, scale), w)


def swin_attn_reference(qkv, bias, mask, num_heads: int, scale: float):
    """Plain version of the forward's attention launch: qkv [B, N, 3C],
    bias [H, N, N], mask [nW, N, N] or None -> o [B, N, C] in qkv.dtype,
    the heads concatenated (the kernel's scratch o, before the
    projection)."""
    dt = qkv.dtype
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    p = softmax_f32(q, k, scale, 0, _terms(bias, mask, qkv.shape[0]))
    return merge_heads(torch.matmul(p.to(dt).float(), v)).to(dt)


def fused_swin_attn_bwd_reference(qkv, w, g, bias, mask, num_heads: int,
                                  scale: float):
    """Plain version of the backward kernel (`_bwd_kernel` with bias and
    mask, every column trainable): qkv [B, N, 3C], w [C, C], g [B, N, C]
    (cotangent of the projected output) -> (dqkv [B, N, 3C] in qkv.dtype,
    dW [C, C] float32 summed over every window and row)."""
    dt = qkv.dtype
    C = qkv.shape[-1] // 3
    g = g.to(dt)
    d_o = torch.matmul(g.float(), w.to(dt).float().t()).to(dt)
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    dq, dk, dv, pb = attention_grads(q, k, v, split_heads(d_o, num_heads),
                                     scale, 0, dt,
                                     _terms(bias, mask, qkv.shape[0]))
    o = torch.matmul(pb, v).to(dt)
    dqkv = torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)
    o_cat = merge_heads(o).reshape(-1, C).float()
    return dqkv, torch.matmul(o_cat.t(), g.reshape(-1, C).float())


def _check(qkv, w, bias, mask, num_heads):
    if qkv.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(
            f"fused Swin window kernel takes bfloat16 qkv and w, got "
            f"{qkv.dtype} and {w.dtype} (run the model in bf16 or with "
            "use_fused_apla=False)")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise ValueError(f"kernel supports head dim {HEAD_DIM} only, got "
                         f"C={C} over {num_heads} heads")
    if tuple(w.shape) != (C, C):
        raise ValueError(f"w must be [{C}, {C}], got {tuple(w.shape)}")
    if tuple(bias.shape) != (num_heads, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be [{num_heads}, {N}, {N}] float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (N, N)
                             or mask.shape[0] < 1
                             or mask.dtype != torch.float32):
        raise ValueError(f"mask must be [nW, {N}, {N}] float32, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    tensors = [qkv, w, bias] + ([mask] if mask is not None else [])
    if any(t.device != qkv.device for t in tensors):
        raise ValueError("qkv, w, bias and mask must share one device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("qkv, w, bias and mask must be contiguous and "
                         "16-byte aligned")
    if N == 0 or B == 0 or B > 65535 or B * N > 65535 * 64:
        raise ValueError(f"{B} windows of {N} tokens outside the kernel's "
                         "grid")
    return B, N, C


@dataclasses.dataclass(frozen=True)
class SwinPlan:
    """How the attention launch covers B windows x H heads.

    `kind` "row" (N <= 64, one key tile) runs items (window, head), each
    one query tile against its window's K/V held in shared memory and the
    score row in registers; a block takes `items_per_block` consecutive
    items, a window's heads next to each other, with `kv_sets` K/V sets (2
    when a block loads the next item's K/V while it computes).
    "two_pass" (N > 64) runs one item (window, head, query tile) a block,
    K/V streamed through two slots."""
    kind: str
    n_tiles: int
    items: int
    items_per_block: int
    blocks: int
    kv_sets: int
    smem_bytes: int
    blocks_per_sm: int

    def args(self) -> tuple:
        """The plan as the C entry takes it (four ints)."""
        return (int(self.kind == "two_pass"), self.items_per_block,
                self.kv_sets, self.smem_bytes)

    def describe(self) -> str:
        return (f"{self.kind}, {self.items} items, {self.items_per_block} "
                f"per block, {self.blocks} blocks ({self.blocks_per_sm} per "
                f"SM), {self.kv_sets} K/V sets, {self.smem_bytes} bytes of "
                f"shared memory")


def _smem(slots: int) -> int:
    """Shared memory of a block with `slots` K/V slots."""
    return FIXED_SMEM + slots * SLOT_BYTES


def _per_sm(regs: str, smem: int) -> int:
    return min(REG_BLOCKS[regs], SM_SMEM // (smem + BLOCK_RESERVED))


@functools.lru_cache(maxsize=256)
def swin_plan(B: int, N: int, H: int) -> SwinPlan:
    """The attention launch's plan, a pure function of the shape, as
    `mha.fwd_plan` lays out its row kernel at N <= 64: an item a block
    while there are no more items than SMS x (blocks per SM), else runs of
    items with two K/V sets (Swin-T b16: 3072 items at stage 0, 384 at
    stage 3); past one key tile, one query tile a block."""
    n_t = -(-N // TILE)
    items = B * H
    if n_t > 1:
        return SwinPlan(kind="two_pass", n_tiles=n_t, items=items * n_t,
                        items_per_block=1, blocks=items * n_t, kv_sets=1,
                        smem_bytes=_smem(2),
                        blocks_per_sm=_per_sm("two_pass", _smem(2)))
    per_sm = _per_sm("row", _smem(1))
    kv_sets, per_block = 1, 1
    if items > SMS * per_sm:
        per_sm2 = _per_sm("row", _smem(2))
        if per_sm2 >= 2:
            kv_sets, per_sm = 2, per_sm2
            per_block = -(-items // (SMS * per_sm))
    return SwinPlan(kind="row", n_tiles=1, items=items,
                    items_per_block=per_block,
                    blocks=-(-items // per_block), kv_sets=kv_sets,
                    smem_bytes=_smem(kv_sets), blocks_per_sm=per_sm)


def proj_plan(M: int, C: int):
    """The projection GEMM's plan (`apla_proj_gemm.gemm_plan`) over M rows
    of width C: 128-column tiles unless C is a multiple of 256, so that a
    Swin width (96, 192, 384 at Swin-T's stages 0-2) wastes at most 32 or
    64 columns of its last tile."""
    return gemm_plan(M, C, None if C % 256 == 0 else 128)


@functools.lru_cache(maxsize=256)
def _plans(B: int, N: int, C: int, H: int, n_w: int):
    """(attention plan, projection plan, the shape and both plans as the C
    entry's ints)."""
    plan, proj = swin_plan(B, N, H), proj_plan(B * N, C)
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"{B} windows of {N} tokens x {H} heads outside "
                         "the kernel's grid")
    return plan, proj, plan_array((B, N, C, H, n_w) + plan.args()
                                  + (proj.bn, proj.stages, proj.smem_bytes))


@dataclasses.dataclass(frozen=True)
class SwinBwdPlan:
    """How the backward's attention launch covers B windows x H heads.

    `kind` "row" (N <= 64, one tile) runs items (window, head) in one pass
    each, a block taking `items_per_block` consecutive items (a window's
    heads next to each other) with `sets` input sets (2 when a block loads
    the next item's tiles while it computes).  "tiles" (N > 64) runs one
    item a block with all of its tiles resident in shared memory, which
    bounds N (`BWD_MAX_TILES` tiles of 64 rows)."""
    kind: str
    n_tiles: int
    items: int
    items_per_block: int
    blocks: int
    sets: int
    smem_bytes: int
    blocks_per_sm: int

    def args(self) -> tuple:
        """The plan as the C entry takes it (four ints)."""
        return (int(self.kind == "tiles"), self.items_per_block, self.sets,
                self.smem_bytes)

    def describe(self) -> str:
        return (f"{self.kind}, {self.n_tiles} tile(s) a window, "
                f"{self.items} items, {self.items_per_block} per block, "
                f"{self.blocks} blocks ({self.blocks_per_sm} per SM), "
                f"{self.sets} input set(s), {self.smem_bytes} bytes of "
                f"shared memory")


def _bwd_smem(kind: str, n: int) -> int:
    """Shared memory of a backward block: the row kernel with n sets, the
    tiles kernel with n tiles a window."""
    if kind == "row":
        return BWD_ROW_FIXED + n * BWD_SET_BYTES
    return (n * (BWD_SET_BYTES + BWD_STAT_BYTES) + 2 * BWD_STAGED_BYTES
            + TILE_BYTES + 1024 + 64)


# The most 64-row tiles a window may have on the backward's tiles kernel:
# 12 (N <= 768; Swin-B's 12 x 12 windows at 384 have 3)
BWD_MAX_TILES = max(n for n in range(1, 64)
                    if _bwd_smem("tiles", n) <= BLOCK_SMEM)


@functools.lru_cache(maxsize=256)
def swin_bwd_plan(B: int, N: int, H: int) -> SwinBwdPlan:
    """The backward's attention plan, a pure function of the shape, laid
    out as `swin_plan` lays out the forward's row kernel: an item a block
    while there are no more items than SMS x (blocks per SM), else runs of
    items with two input sets (Swin-T b16: 3072 items at stage 0, 384 at
    stage 3); past one tile, an item a block on the tiles kernel, up to
    `BWD_MAX_TILES` tiles."""
    n_t = -(-N // TILE)
    items = B * H
    if n_t > BWD_MAX_TILES:
        raise ValueError(
            f"the Swin window backward keeps a window's q, k, v and dO in "
            f"shared memory: N={N} is {n_t} tiles of {TILE} rows, at most "
            f"{BWD_MAX_TILES} fit (N <= {BWD_MAX_TILES * TILE})")
    if n_t > 1:
        smem = _bwd_smem("tiles", n_t)
        return SwinBwdPlan(kind="tiles", n_tiles=n_t, items=items,
                           items_per_block=1, blocks=items, sets=1,
                           smem_bytes=smem, blocks_per_sm=min(
                               BWD_REG_BLOCKS["tiles"],
                               SM_SMEM // (smem + BLOCK_RESERVED)))

    def per_sm(sets):
        return min(BWD_REG_BLOCKS["row"],
                   SM_SMEM // (_bwd_smem("row", sets) + BLOCK_RESERVED))

    sets, per_block, fit = 1, 1, per_sm(1)
    if items > SMS * fit:
        sets, fit = 2, per_sm(2)
        per_block = -(-items // (SMS * fit))
    return SwinBwdPlan(kind="row", n_tiles=1, items=items,
                       items_per_block=per_block,
                       blocks=-(-items // per_block), sets=sets,
                       smem_bytes=_bwd_smem("row", sets), blocks_per_sm=fit)


@functools.lru_cache(maxsize=256)
def _bwd_plans(B: int, N: int, C: int, H: int, n_w: int, n_sm: int):
    """(attention plan, dO GEMM plan, dW GEMM plan, dW chunks, the shape
    and plans as the C entry's ints).  The dW chunks are those of the
    first port's 64 x 64 (C a multiple of 64) or 32 x 32 tiles: they fix
    the partials' sum order."""
    plan = swin_bwd_plan(B, N, H)
    do_gemm, dw_gemm = proj_plan(B * N, C), gemm_plan(C, C, *DW_GEMM)
    rows, n_chunks = dw_chunks(B * N, C, C, n_sm, 64 if C % 64 == 0 else 32)
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"{B} windows of {N} tokens x {H} heads outside "
                         "the kernel's grid")
    return plan, do_gemm, dw_gemm, n_chunks, plan_array(
        (B, N, C, H, n_w) + plan.args()
        + (do_gemm.bn, do_gemm.stages, do_gemm.smem_bytes)
        + (dw_gemm.bn, dw_gemm.stages, dw_gemm.smem_bytes)
        + (rows, n_chunks))


@functools.cache
def _fwd_library():
    lib = load_library(_SOURCE)
    lib.swin_attn_fwd.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    lib.swin_attn_fwd.restype = ctypes.c_int
    lib.swin_attn_fwd_prepare.argtypes = [ctypes.c_int]
    lib.swin_attn_fwd_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library():
    lib = load_library(_BWD_SOURCE)
    lib.swin_attn_bwd.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    lib.swin_attn_bwd.restype = ctypes.c_int
    lib.swin_attn_bwd_prepare.argtypes = [ctypes.c_int]
    lib.swin_attn_bwd_prepare.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(qkv, w, bias, mask, num_heads, scale,
                parts=PART_ATTN | PART_PROJ, o=None):
    """The launches `parts` names, on the current stream: the attention
    into o (a new scratch [B, N, C], or `o`), the projection of o into a
    new out.  -> out, or o when the projection is not queued (o given and
    the attention not queued: the projection alone reads it)."""
    B, N, C = _check(qkv, w, bias, mask, num_heads)
    plan, proj, shape = _plans(B, N, C, num_heads,
                               1 if mask is None else mask.shape[0])
    lib = _fwd_library()
    check_smem(max(plan.smem_bytes, proj.smem_bytes),
               device_smem(_fwd_library, "swin_attn_fwd_prepare",
                           device_index(qkv)),
               f"the Swin window forward at N={N}, C={C}")
    out_ptr = None
    if o is None:
        # o and out in one allocation, out its second half (one allocation
        # less: the smaller stages are bound by the host's time per call)
        both = torch.empty((2 if parts & PART_PROJ else 1, B, N, C),
                           dtype=qkv.dtype, device=qkv.device)
        o_ptr, result = both.data_ptr(), both[-1]
        if parts & PART_PROJ:
            out_ptr = result.data_ptr()
    elif (o.dtype != qkv.dtype or tuple(o.shape) != (B, N, C)
          or o.device != qkv.device or not o.is_contiguous()
          or o.data_ptr() % 16):
        raise ValueError(f"o must be a contiguous, 16-byte aligned [{B}, "
                         f"{N}, {C}] {qkv.dtype} on qkv's device")
    else:
        o_ptr, result = o.data_ptr(), o
        if parts & PART_PROJ:
            result = torch.empty_like(o)
            out_ptr = result.data_ptr()
    with launch_context(qkv) as stream:
        err = lib.swin_attn_fwd(
            qkv.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(mask), o_ptr,
            out_ptr, shape, float(scale), parts, stream)
    if err == 2000:
        raise RuntimeError(f"swin_attn_fwd: no GEMM of {proj.bn} columns")
    if err >= 1000:
        raise RuntimeError(f"swin_attn_fwd: tensor map not encoded: "
                           f"CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"swin_attn_fwd launch failed: cudaError {err}")
    return result


def fused_swin_attn_fwd(qkv, w, bias, mask, num_heads: int, scale: float):
    """qkv [B, N, 3C] (B = images x windows), w [C, C], bias [H, N, N] f32,
    mask [nW, N, N] f32 or None (a block that is not shifted) ->
    [B, N, C], without the projection's bias.

    CPU tensor: the plain version.  CUDA tensor: the two kernels, or an
    error naming why they cannot run (dtype, head dim, shapes, shared
    memory).  On the card the result is a view of the second half of one
    [2, B, N, C] allocation whose first half is the scratch o, so it keeps
    that scratch alive for as long as it is held: twice the output's
    memory.  `FusedSwinAttention` drops it at once (it returns out + b, a
    new tensor); a caller that keeps the output itself for long clones it
    first."""
    if qkv.device.type == "cpu":
        return fused_swin_attn_fwd_reference(qkv, w, bias, mask, num_heads,
                                             scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused Swin attention for device {qkv.device}")
    out = _launch_fwd(qkv, w, bias, mask, num_heads, scale)
    fused_swin_attn_fwd.launches += 1
    return out


fused_swin_attn_fwd.launches = 0


def fused_swin_attn_fwd_part(qkv, w, bias, mask, num_heads: int,
                             scale: float, parts: int, o=None):
    """The forward's launches that `parts` names (`PART_ATTN`, `PART_PROJ`
    or both) on CUDA tensors, uncounted: a measurement times the two apart
    and feeds the projection an o of its choice.  -> o after the attention
    alone, out when the projection runs (it reads `o`, which must be given
    when the attention does not run)."""
    if qkv.device.type != "cuda":
        raise ValueError("fused_swin_attn_fwd_part runs on a CUDA tensor")
    if not parts & PART_ATTN and o is None:
        raise ValueError("the projection alone needs o")
    return _launch_fwd(qkv, w, bias, mask, num_heads, scale, parts, o)


def _launch_bwd(qkv, w, g, bias, mask, num_heads, scale,
                parts=BWD_PARTS_ALL, bufs=None):
    """The backward's launches that `parts` names, on the current stream,
    into `bufs` (dqkv, dW, the dO and o_cat scratch [2, B, N, C], the dW
    partials), new ones when None.  -> bufs."""
    B, N, C = _check(qkv, w, bias, mask, num_heads)
    if g.dtype != qkv.dtype or tuple(g.shape) != (B, N, C):
        raise ValueError(f"g must be [{B}, {N}, {C}] {qkv.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.device != qkv.device or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be contiguous, 16-byte aligned and on "
                         "qkv's device")
    dev = device_index(qkv)
    plan, do_gemm, dw_gemm, n_chunks, shape = _bwd_plans(
        B, N, C, num_heads, 1 if mask is None else mask.shape[0],
        _sm_count(dev))
    lib = _bwd_library()
    check_smem(max(plan.smem_bytes, do_gemm.smem_bytes, dw_gemm.smem_bytes),
               device_smem(_bwd_library, "swin_attn_bwd_prepare", dev),
               f"the Swin window backward at N={N}, C={C}")
    if bufs is None:
        bufs = (torch.empty_like(qkv),
                torch.empty((C, C), dtype=torch.float32, device=qkv.device),
                torch.empty((2, B, N, C), dtype=qkv.dtype,
                            device=qkv.device),
                torch.empty((n_chunks, C, C), dtype=torch.float32,
                            device=qkv.device))
    dqkv, dw, scratch, part = bufs
    with launch_context(qkv) as stream:
        err = lib.swin_attn_bwd(
            qkv.data_ptr(), w.data_ptr(), g.data_ptr(), bias.data_ptr(),
            _ptr(mask), dqkv.data_ptr(), dw.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), part.data_ptr(), shape, float(scale),
            parts, stream)
    if err == 2000:
        raise RuntimeError("swin_attn_bwd: no GEMM of that width")
    if err >= 1000:
        raise RuntimeError(f"swin_attn_bwd: tensor map not encoded: "
                           f"CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"swin_attn_bwd launch failed: cudaError {err}")
    return bufs


@functools.cache
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_swin_attn_bwd(qkv, w, g, bias, mask, num_heads: int,
                        scale: float):
    """Backward of `fused_swin_attn_fwd`: -> (dqkv [B, N, 3C] in
    qkv.dtype, dW [C, C] float32).

    CPU tensor: the plain version.  CUDA tensor: the kernels, or an error
    naming why they cannot run (dtype, head dim, shapes, a window past
    `BWD_MAX_TILES` tiles, shared memory)."""
    if qkv.device.type == "cpu":
        return fused_swin_attn_bwd_reference(qkv, w, g, bias, mask,
                                             num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused Swin attention for device {qkv.device}")
    dqkv, dw, _, _ = _launch_bwd(qkv, w, g, bias, mask, num_heads, scale)
    fused_swin_attn_bwd.launches += 1
    return dqkv, dw


fused_swin_attn_bwd.launches = 0


def fused_swin_attn_bwd_part(qkv, w, g, bias, mask, num_heads: int,
                             scale: float, parts: int, bufs=None):
    """The backward's launches that `parts` names (`BWD_DO`, `BWD_ATTN`,
    `BWD_DW`, or several) on CUDA tensors, uncounted: a measurement times
    them apart.  `bufs`: the buffers an earlier part call returned (dqkv,
    dW, the dO and o_cat scratch, the dW partials), so that the parts run
    in turn compute what one call does; new ones when None (a launch then
    reads scratch that no earlier launch wrote, and only its time means
    anything).  -> bufs."""
    if qkv.device.type != "cuda":
        raise ValueError("fused_swin_attn_bwd_part runs on a CUDA tensor")
    return _launch_bwd(qkv, w, g, bias, mask, num_heads, scale, parts, bufs)


class FusedSwinAttention(torch.autograd.Function):
    """The JAX custom VJP (`pallas_apla_attn.py:721-775`) as an autograd
    `Function`.  Forward: the forward kernel; it saves qkv, W (in
    qkv.dtype), the bias and the mask, and nothing else: the backward
    recomputes p.  Backward: dqkv and dW from the backward kernel, db = the
    f32 sum of g outside it; no gradient for the bias or the mask.  When
    qkv needs no gradient (its input is frozen) the kernel runs all the
    same, for dW, and dqkv is dropped."""

    @staticmethod
    def forward(ctx, qkv, w, b, bias, mask, num_heads, scale):
        w_dt = w.to(qkv.dtype)
        out = fused_swin_attn_fwd(qkv, w_dt, bias, mask, num_heads, scale)
        ctx.save_for_backward(qkv, w_dt, bias, mask)
        ctx.args = (num_heads, scale, w.dtype, b.dtype)
        return out + b.to(out.dtype)

    @staticmethod
    def backward(ctx, g):
        qkv, w, bias, mask = ctx.saved_tensors
        num_heads, scale, w_dtype, b_dtype = ctx.args
        dqkv, dw = fused_swin_attn_bwd(qkv, w, g.to(qkv.dtype).contiguous(),
                                       bias, mask, num_heads, scale)
        db = g.float().sum(dim=(0, 1))
        return (dqkv if ctx.needs_input_grad[0] else None, dw.to(w_dtype),
                db.to(b_dtype), None, None, None, None)


def fused_swin_attention(qkv, w, b, bias, mask, num_heads: int,
                         scale: float):
    """qkv [B, N, 3C] window activations -> [B, N, C] projected output.

    `w` [C, C] / `b` [C] the (trainable) projection, `bias` [H, N, N] the
    gathered relative-position bias, `mask` [nW, N, N] the shift mask or
    None.  Differentiable in (qkv, w, b)."""
    return FusedSwinAttention.apply(qkv, w, b, bias, mask, num_heads,
                                    float(scale))
