"""Memory-efficient multi-head attention, softmax(q k^T * scale) v, and its
backward.

Counterpart of `apla_tpu/ops/pallas_mha.py` (`vmem_mha` and the custom VJP
of `_vmem_mha_padded`).  Two hand-written CUDA kernels replace the TPU
kernels:

- `csrc/mha_fwd.cu` replaces `pallas_mha.py:_fwd_kernel`: per head, f32
  scores masked past N and outside the row's segment, p normalised in f32
  and rounded to the input dtype, p v accumulated in f32 and rounded once.
  Hopper's wgmma and TMA, each head's K/V loaded once per block; its launch
  plan (`fwd_plan`) is decided here, from the shape alone.
- `csrc/mha_bwd.cu` replaces `pallas_mha.py:_bwd_kernel`: p recomputed,
  `dv = bf16(p)^T dO`, `dp = dO v^T`, `ds = bf16(p (dp - rowsum(dp p))
  scale)` on the f32 p, `dq = ds k`, `dk = ds^T q`, each rounded once.
  Two launches (`csrc/attn_bwd_sm90.cuh`: a query side and a key side),
  wgmma and TMA, the other side's tiles resident where they fit; its launch
  plan (`bwd_plan`) is decided here, from the shape alone.

Both take q, k and v packed as the qkv matmul emits them, `[B, N, 3C]` with
head h at columns `h*64 .. h*64+63` of each third, and mask the ragged edge
of N themselves: the transpose and 16-row padding copies of `vmem_mha`'s
`prep` are TPU layout choices, not part of the function.  The backward
returns `dqkv` packed the same way.

`mha_fwd` / `mha_bwd` are the wrappers: on a CPU tensor they run the plain
PyTorch versions below (`*_reference`), on a CUDA tensor they launch the
kernel or raise.  Each wrapper's `launches` counts its kernel launches (one
per call, and nothing else).  `MemEffAttention` is the autograd `Function`
over both, with the JAX custom VJP's contract: it saves qkv only and the
backward recomputes p.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .cuda_build import check_smem, device_index, device_smem, \
    launch_context, load_library

FWD_SOURCE = "mha_fwd.cu"
BWD_SOURCE = "mha_bwd.cu"
HEAD_DIM = 64          # the kernels' head dim (every ViT builder's)

# The forward kernel's launch plan (`fwd_plan`), in the units of
# `csrc/mha_fwd.cu`: 64-row query and key tiles; a K/V slot holds one key
# tile of K and one of V (16 KB); a block's warpgroup has two q tiles and an
# output tile (24 KB); 1 KB aligns the base, 512 bytes hold the barriers.
SMS = 132                        # streaming multiprocessors of the H100
SM_SMEM = 233472                 # shared memory of one SM (228 KB)
BLOCK_SMEM = 232448              # the most one block may use (227 KB)
BLOCK_RESERVED = 1024            # shared memory the card keeps per block
TILE = 64
SLOT_BYTES = 2 * TILE * HEAD_DIM * 2
FIXED_SMEM = 3 * TILE * HEAD_DIM * 2 + 1024 + 512
ROW_TILES = 5                    # key tiles the row kernel holds (N <= 320)
RING_DEPTH = 3                   # the two-pass kernel's streamed K/V ring
# Blocks of 128 threads that the registers (65536 an SM) let one SM hold,
# from the compiler's counts (`-Xptxas=-v`, `chip_smoke.py` phase 1): the
# row kernel over one key tile (at most 74 registers), over two or more
# (up to 255), the two-pass kernel (138).
REG_BLOCKS = {"row1": 6, "row": 2, "two_pass": 3}


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel covers [B, N] x H heads.

    An item is (image, head, a group of `q_tiles` query tiles); a block
    takes `items_per_block` consecutive items.  `kind` "row" (N <= 320)
    holds the head's K/V in shared memory and each score row in
    registers; "two_pass" takes any N, with all key tiles resident when
    they fit (`resident`), else streamed through a ring of `slots`
    stages.  `kv_sets`: the row kernel's K/V sets (2 when a block loads
    the next item's K/V while it computes)."""
    kind: str
    n_tiles: int
    q_tiles: int
    groups: int
    items: int
    items_per_block: int
    blocks: int
    kv_sets: int
    slots: int
    resident: bool
    smem_bytes: int
    blocks_per_sm: int

    def describe(self) -> str:
        return (f"{self.kind}, {self.q_tiles} query tiles per item, "
                f"{self.items_per_block} items per block, {self.blocks} "
                f"blocks ({self.blocks_per_sm} per SM), "
                f"{'resident' if self.resident else 'streamed'} K/V in "
                f"{self.slots} slots, {self.smem_bytes} bytes of shared "
                f"memory")


def _smem(slots: int) -> int:
    return FIXED_SMEM + slots * SLOT_BYTES


def _per_sm(regs: str, smem: int) -> int:
    return min(REG_BLOCKS[regs], SM_SMEM // (smem + BLOCK_RESERVED))


def _streamed_q_tiles(heads: int, n_t: int, per_sm: int) -> int:
    """Query tiles per item of the streamed two-pass kernel, which streams
    K and V again for every query tile: one when the tiles fill the card
    twice over (single-tile blocks then even out as they finish), else the
    most that still leave two blocks an SM: it keeps [2, 1370] x 12 heads
    at two and gives the segmenter's [8, 1025] x 16 heads one, where an
    even split of the 17 tiles left a second wave of blocks
    (`tools/compare_mha_fwd.py`, `PERF.md` §6, PR 9)."""
    if heads * n_t >= 2 * SMS * per_sm:
        return 1
    q = 1
    while q < n_t and heads * -(-n_t // (q + 1)) >= 2 * SMS:
        q += 1
    return q


@functools.lru_cache(maxsize=256)
def fwd_plan(B: int, N: int, H: int, segment_len: int = 0) -> FwdPlan:
    """The forward kernel's launch plan, a pure function of the shape.

    Query tiles are split over blocks until about SMS x (blocks per SM)
    blocks are in flight, or every block has one tile (the streamed
    two-pass kernel: `_streamed_q_tiles`); the row kernel gives each block
    a run of items with two K/V sets once there are more items than that
    and two sets still leave two blocks an SM.  (`segment_len` changes
    which key tiles a block multiplies, not the plan.)"""
    del segment_len
    n_t = -(-N // TILE)
    heads = B * H
    if n_t <= ROW_TILES:
        kind, regs = "row", ("row1" if n_t == 1 else "row")
        resident, slots = True, n_t
    else:
        kind = regs = "two_pass"
        resident = _smem(n_t) <= BLOCK_SMEM
        slots = n_t if resident else RING_DEPTH
    per_sm = _per_sm(regs, _smem(slots))
    target = SMS * per_sm
    if kind == "two_pass" and not resident:
        q_tiles = _streamed_q_tiles(heads, n_t, per_sm)
    else:
        q_tiles = max(1, n_t // min(n_t, -(-target // heads)))
    groups = -(-n_t // q_tiles)
    items = heads * groups
    kv_sets, per_block = 1, 1
    if kind == "row" and items > target:
        per_sm2 = _per_sm(regs, _smem(2 * slots))
        if per_sm2 >= 2:
            kv_sets, per_sm, slots = 2, per_sm2, 2 * slots
            per_block = -(-items // (SMS * per_sm))
    return FwdPlan(kind=kind, n_tiles=n_t, q_tiles=q_tiles, groups=groups,
                   items=items, items_per_block=per_block,
                   blocks=-(-items // per_block), kv_sets=kv_sets,
                   slots=slots, resident=resident, smem_bytes=_smem(slots),
                   blocks_per_sm=per_sm)


# The backward's launch plan (`bwd_plan`), in the units of
# `csrc/attn_bwd_sm90.cuh`: a block of one warpgroup takes a run of its own
# side's 64-row tiles (query tiles on the query side, key tiles on the key
# side) of one (image, head) and holds one own pair (Q and dO, or K and V:
# 16 KB); the other side's pairs (K and V, or Q and dO with the query
# tile's statistics, 768 bytes more) sit in `slots`: all of the head's
# tiles when they fit two blocks an SM, else a ring.  1 KB aligns the base,
# 256 bytes hold the barriers.
STAT_BYTES = 3 * TILE * 4
BWD_RING = 3                     # the streamed ring's stages
BWD_BLOCKS_PER_SM = 2


def bwd_smem(side: str, slots: int) -> int:
    """Shared memory of a block of the backward's `side` ("query" or
    "key") holding `slots` of the other side's pairs."""
    per = SLOT_BYTES + (STAT_BYTES if side == "key" else 0)
    return 1024 + SLOT_BYTES + slots * per + 256


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the backward's two kernels cover [B, N] x H heads.

    A block of either side takes `tiles` consecutive own tiles (query tiles
    on the query side, key tiles on the key side) of one (image, head):
    `blocks` blocks a side.  The other side's tiles are `resident` (all of
    the head's in `slots` = `n_tiles` slots) or streamed through a ring of
    `slots` = BWD_RING stages."""
    n_tiles: int
    resident: bool
    slots: int
    tiles: int
    blocks: int
    q_smem: int
    k_smem: int

    @property
    def smem_bytes(self) -> int:
        return max(self.q_smem, self.k_smem)

    def args(self) -> tuple:
        """The plan as the C entries take it (five ints)."""
        return (self.tiles, int(self.resident), self.slots, self.q_smem,
                self.k_smem)

    def describe(self) -> str:
        return (f"{self.tiles} own tiles per block, {self.blocks} blocks a "
                f"side, the other side "
                f"{'resident' if self.resident else 'streamed'} in "
                f"{self.slots} slots, {self.q_smem} (query side) and "
                f"{self.k_smem} (key side) bytes of shared memory")


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, N: int, H: int, segment_len: int = 0) -> BwdPlan:
    """The backward kernels' launch plan, a pure function of the shape.

    The other side's tiles stay resident when both sides' blocks, holding
    all of a head's tiles, still fit two to an SM (N <= 320); longer N
    streams them through a ring.  Resident, a block takes as many own tiles
    as leave about SMS x 2 blocks in flight (all of a head's five at b64),
    so K/V (or Q/dO) cross from L2 once per block; streamed, one own tile a
    block.  (`segment_len` changes which tiles a block multiplies, not the
    plan.)"""
    del segment_len
    n_t = -(-N // TILE)
    heads = B * H
    limit = SM_SMEM // BWD_BLOCKS_PER_SM - BLOCK_RESERVED
    resident = max(bwd_smem("query", n_t), bwd_smem("key", n_t)) <= limit
    slots = n_t if resident else BWD_RING
    if resident:
        target = SMS * BWD_BLOCKS_PER_SM
        tiles = max(1, n_t // min(n_t, -(-target // heads)))
    else:
        tiles = 1
    return BwdPlan(n_tiles=n_t, resident=resident, slots=slots, tiles=tiles,
                   blocks=heads * -(-n_t // tiles),
                   q_smem=bwd_smem("query", slots),
                   k_smem=bwd_smem("key", slots))


def split_heads(t, num_heads):
    """[B, N, C] -> [B, H, N, Dh] in float32."""
    B, N, C = t.shape
    return t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2).float()


def merge_heads(t):
    """[B, H, N, Dh] -> [B, N, C]."""
    B, H, N, dh = t.shape
    return t.transpose(1, 2).reshape(B, N, H * dh)


def softmax_f32(q, k, scale, segment_len, terms=()):
    """f32 softmax of the masked scores q k^T * scale ([B, H, N, N]); with
    `segment_len` > 0 a row sees only the columns of its own segment.
    `terms`: f32 tensors broadcastable to the scores, added one after the
    other before the softmax (the Swin windows' bias, then mask)."""
    N = q.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    for term in terms:
        s = s + term
    if segment_len:
        seg = torch.arange(N, device=q.device) // segment_len
        s = s.masked_fill(seg[:, None] != seg[None, :], float("-inf"))
    return torch.softmax(s, dim=-1)


def attention_grads(q, k, v, d_o, scale, segment_len, dt, terms=()):
    """The TPU backward's arithmetic on [B, H, N, Dh] float32 q, k, v, dO:
    (dq, dk, dv, pb) in float32, with p recomputed (`terms` as in
    `softmax_f32`), pb = p rounded to `dt`, and ds = p (dp - rowsum(dp p))
    scale on the f32 p, rounded to `dt`."""
    p = softmax_f32(q, k, scale, segment_len, terms)
    pb = p.to(dt).float()
    dv = torch.matmul(pb.transpose(-1, -2), d_o)
    dp = torch.matmul(d_o, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq, dk, dv, pb


def mha_fwd_reference(qkv, num_heads: int, scale: float,
                      segment_len: int = 0):
    """Plain version of the forward kernel, rounding where the TPU kernel
    rounds: qkv [B, N, 3C] -> [B, N, C] in qkv.dtype.  Products are taken in
    f32 on the upcast inputs (as `preferred_element_type=f32` does)."""
    dt = qkv.dtype
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    p = softmax_f32(q, k, scale, segment_len).to(dt).float()
    return merge_heads(torch.matmul(p, v)).to(dt)


def mha_bwd_reference(qkv, d_o, num_heads: int, scale: float,
                      segment_len: int = 0):
    """Plain version of the backward kernel (`pallas_mha.py:_bwd_kernel`'s
    rounding points): qkv [B, N, 3C], d_o [B, N, C] (cotangent of the
    forward's output) -> dqkv [B, N, 3C] in qkv.dtype."""
    dt = qkv.dtype
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    dq, dk, dv, _ = attention_grads(q, k, v, split_heads(d_o.to(dt),
                                                         num_heads),
                                    scale, segment_len, dt)
    return torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


def _check_qkv(qkv, num_heads, segment_len):
    if qkv.dtype != torch.bfloat16:
        raise ValueError(
            f"attention kernel takes bfloat16 qkv, got {qkv.dtype} (run the "
            "model in bf16 or with use_flash=False)")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise ValueError(f"kernel supports head dim {HEAD_DIM} only, got "
                         f"C={C} over {num_heads} heads")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if segment_len < 0:
        raise ValueError(f"segment_len must be >= 0, got {segment_len}")
    if N == 0 or B == 0 or B > 65535 or num_heads > 65535:
        raise ValueError(f"batch {B} x length {N} x {num_heads} heads "
                         "outside the kernel's grid")
    return B, N, C


@functools.cache
def _fwd_library():
    lib = load_library(FWD_SOURCE)
    lib.mha_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.mha_fwd.restype = ctypes.c_int
    lib.mha_fwd_prepare.argtypes = [ctypes.c_int]
    lib.mha_fwd_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library():
    lib = load_library(BWD_SOURCE)
    lib.mha_bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
           ctypes.c_int, ctypes.c_void_p]
    lib.mha_bwd.restype = ctypes.c_int
    lib.mha_bwd_prepare.argtypes = [ctypes.c_int]
    lib.mha_bwd_prepare.restype = ctypes.c_int
    return lib


def launch_fwd(qkv, num_heads, scale, segment_len, stream, shape):
    """Queues one launch of the forward kernel on `stream` (a raw stream
    handle of qkv's device, the current device), uncounted: -> the new
    [B, N, C] output.  `shape` is (B, N, C) from `_check_qkv`, or from a
    check that covers it.  `mha_fwd` and the fused APLA forward
    (`ops/fused_apla_attn.py`, whose attention half this kernel computes)
    call it, each counting its own launches."""
    B, N, C = shape
    plan = fwd_plan(B, N, num_heads, segment_len)
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"batch {B} x length {N} x {num_heads} heads "
                         "outside the kernel's grid")
    lib = _fwd_library()
    check_smem(plan.smem_bytes,
               device_smem(_fwd_library, "mha_fwd_prepare",
                           qkv.device.index), "the forward")
    out = qkv.new_empty((B, N, C))
    err = lib.mha_fwd(qkv.data_ptr(), out.data_ptr(), B, N, C, num_heads,
                      float(scale), int(segment_len),
                      int(plan.kind == "two_pass"), plan.q_tiles,
                      plan.items_per_block, plan.kv_sets, plan.slots,
                      int(plan.resident), plan.smem_bytes, stream)
    if err >= 1000:
        raise RuntimeError(f"mha_fwd: tensor map not encoded: CUresult "
                           f"{err - 1000}")
    if err != 0:
        raise RuntimeError(f"mha_fwd launch failed: cudaError {err}")
    return out


def mha_fwd(qkv, num_heads: int, scale: float, segment_len: int = 0):
    """qkv [B, N, 3C] -> attention output [B, N, C] (heads merged).

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (dtype, head dim, layout)."""
    if qkv.device.type == "cpu":
        return mha_fwd_reference(qkv, num_heads, scale, segment_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    shape = _check_qkv(qkv, num_heads, segment_len)
    with launch_context(qkv) as stream:
        out = launch_fwd(qkv, num_heads, scale, segment_len, stream, shape)
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0


def plan_array(values) -> ctypes.Array:
    """A launch plan's ints as the C entries' `const int*`."""
    return (ctypes.c_int * len(values))(*values)


def bwd_stats(B, N, num_heads, device):
    """The backward's statistics scratch: [B, H, ceil(N / 64), 3, 64] f32,
    written by the query side, read by the key side."""
    return torch.empty((B, num_heads, -(-N // TILE), 3, TILE),
                       dtype=torch.float32, device=device)


def check_bwd_plan(plan: BwdPlan, dev: int, library, prepare: str) -> None:
    """Raises unless the device takes the plan's shared memory and grid."""
    if plan.blocks >= 2 ** 31:
        raise ValueError("the backward's grid is too large")
    check_smem(plan.smem_bytes, device_smem(library, prepare, dev),
               "the backward")


# `parts` of the backward's C entries: which launches a call queues
PART_DO, PART_QUERY, PART_KEY, PART_DW = 1, 2, 4, 8


def _launch_bwd(qkv, d_o, num_heads, scale, segment_len,
                parts=PART_QUERY | PART_KEY):
    B, N, C = _check_qkv(qkv, num_heads, segment_len)
    if d_o.dtype != qkv.dtype or tuple(d_o.shape) != (B, N, C):
        raise ValueError(f"d_o must be [{B}, {N}, {C}] {qkv.dtype}, got "
                         f"{tuple(d_o.shape)} {d_o.dtype}")
    if d_o.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, d_o on {d_o.device}")
    if not d_o.is_contiguous() or d_o.data_ptr() % 16:
        raise ValueError("d_o must be contiguous and 16-byte aligned")
    lib = _bwd_library()
    dev = device_index(qkv)
    plan = bwd_plan(B, N, num_heads, segment_len)
    check_bwd_plan(plan, dev, _bwd_library, "mha_bwd_prepare")
    dqkv = torch.empty_like(qkv)
    stats = bwd_stats(B, N, num_heads, qkv.device)
    with launch_context(qkv) as stream:
        err = lib.mha_bwd(qkv.data_ptr(), d_o.data_ptr(), dqkv.data_ptr(),
                          stats.data_ptr(), B, N, C, num_heads, float(scale),
                          int(segment_len), plan_array(plan.args()), parts,
                          stream)
    if err >= 1000:
        raise RuntimeError(f"mha_bwd: tensor map not encoded: CUresult "
                           f"{err - 1000}")
    if err != 0:
        raise RuntimeError(f"mha_bwd launch failed: cudaError {err}")
    return dqkv


def mha_bwd(qkv, d_o, num_heads: int, scale: float, segment_len: int = 0):
    """Backward of `mha_fwd`: qkv [B, N, 3C], d_o [B, N, C] -> dqkv
    [B, N, 3C] in qkv.dtype.

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (dtype, head dim, shapes, shared memory)."""
    if qkv.device.type == "cpu":
        return mha_bwd_reference(qkv, d_o, num_heads, scale, segment_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    dqkv = _launch_bwd(qkv, d_o, num_heads, scale, segment_len)
    mha_bwd.launches += 1
    return dqkv


mha_bwd.launches = 0


def mha_bwd_part(qkv, d_o, num_heads: int, scale: float, part: int,
                 segment_len: int = 0):
    """One of the backward's launches alone (`PART_QUERY` or `PART_KEY`),
    on a CUDA tensor, uncounted: a measurement times the two apart.  The
    key side alone reads statistics it did not write, so only its time
    means anything."""
    return _launch_bwd(qkv, d_o, num_heads, scale, segment_len, part)


class MemEffAttention(torch.autograd.Function):
    """The JAX custom VJP (`pallas_mha.py:157-172`) as an autograd
    `Function`.  Forward: the forward kernel; it saves qkv and nothing else.
    Backward: the backward kernel recomputes p and returns dqkv packed."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, segment_len):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, scale, segment_len)
        return mha_fwd(qkv, num_heads, scale, segment_len)

    @staticmethod
    def backward(ctx, g):
        qkv, = ctx.saved_tensors
        dqkv = mha_bwd(qkv, g.to(qkv.dtype).contiguous(), *ctx.args)
        return dqkv, None, None, None


def mha(qkv, num_heads: int, scale: float, segment_len: int = 0):
    """qkv [B, N, 3C] packed activations -> attention output [B, N, C].
    Differentiable in qkv."""
    return MemEffAttention.apply(qkv, num_heads, float(scale),
                                 int(segment_len))
