"""Fused APLA attention: softmax(q k^T) v and the partial-trainable output
projection in one kernel, and its backward.

Counterpart of `apla_tpu/ops/pallas_apla_attn.py` (`fused_apla_attention`
and its custom VJP).  Hand-written CUDA kernels replace the TPU kernels:

- `pallas_apla_attn.py:_fwd_kernel` (per head, f32 scores masked to the
  row's segment, p rounded to the input dtype, p v, the heads concatenated
  and multiplied by the assembled `[C, C]` projection) is two launches on
  the card, split at the head concatenation: the memory-efficient
  attention forward (`csrc/mha_fwd.cu`, through `ops/mha.launch_fwd`)
  writes o `[B, N, C]` to a scratch tensor, and `csrc/apla_proj_gemm.cu`
  (`ops/apla_proj_gemm.launch`) multiplies it by the projection over the
  B * N rows.  Both keep the TPU kernel's rounding points and this port's
  earlier single kernel's sum orders, so the output is that kernel's bit
  for bit; o makes one round trip through the card's L2.  The bias is
  added outside the kernels.
- `csrc/fused_apla_attn_bwd.cu` replaces `pallas_apla_attn.py:_bwd_kernel`:
  p recomputed, `dO = g W^T`, `dq/dk/dv` packed `[B, N, 3C]`, and
  `dW_t = o_cat^T g[..., inds]` summed over the batch, in f32.  Five
  launches: the two GEMMs on `csrc/gemm_sm90.cuh` (the projection GEMM's
  body: `gemm_plan`'s plans), the attention's query and key sides on
  `csrc/attn_bwd_sm90.cuh` (the memory-efficient attention backward's:
  `mha.bwd_plan`), and the sum of the dW_t partials.

The same kernels stand for the TPU's q-strip "long" kernels
(`apla_tpu/ops/pallas_apla_attn_long.py`: `_fwd_kernel` through `_call_fwd`,
`_bwda_kernel` through `_call_bwda`, `_bwdb_kernel` through `_call_bwdb`),
which compute the same function for N past the monolithic kernel's VMEM
envelope: these kernels tile queries and keys at any N, so no q-strip
schedule is carried over.  The segmentation side-car runs them there:
ViT-L/16 at 512 (qkv [8, 1025, 3072]) with APLA "full" as k = C = 1024.
(The long backward forms delta as sum(dO * o) with o from the bf16 p; the
kernel here, like the monolithic one, takes rowsum(dp * p) on the f32 p.)

Under tensor parallelism (`parallel.tensor`) a rank runs both on its
H/T heads: qkv [B, N, 3K] with K = (H/T) * 64 and the rows of the
projection that those heads meet, W [K, C].  The forward's GEMM then
writes the f32 partial (`out_f32`), which the model group sums before the
bias and one rounding; the backward reads the whole cotangent g [B, N, C]
and gives dqkv [B, N, 3K] and the rows [K, k] of dW_t.  At K = C both are
the square kernels, bit for bit.

`fused_apla_attn_fwd` / `fused_apla_attn_bwd` are the wrappers: on a CPU
tensor they run the plain PyTorch versions below (`*_reference`), on a CUDA
tensor they launch the kernels or raise.  Each wrapper's `launches` counts
its calls that launched (one per call, and nothing else: a forward call
launches the attention kernel and the GEMM once each, and counts neither
in `mha_fwd.launches` nor in `apla_proj_gemm.launches`).
`FusedAplaAttention` is the autograd `Function` over both, with the JAX
custom VJP's contract.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import apla_proj_gemm as proj_gemm
from . import mha
from .apla_proj import assemble
from .cuda_build import check_smem, device_index, device_smem, \
    launch_context, load_library
from .mha import (HEAD_DIM, attention_grads, merge_heads, mha_fwd_reference,
                  split_heads)

_BWD_SOURCE = "fused_apla_attn_bwd.cu"
_KP = 64               # the backward pads the trainable columns to this


def fused_apla_attn_fwd_reference(qkv, w, num_heads: int, scale: float,
                                  segment_len: int = 0,
                                  out_f32: bool = False):
    """Plain version of the forward kernel, rounding where the TPU kernel
    rounds.

    qkv [B, N, 3K], w [K, C] -> [B, N, C] in qkv.dtype (`out_f32`: the f32
    sums): the attention of `mha_fwd_reference` (rounded to qkv.dtype),
    then the projection with products in f32 on the upcast inputs (as
    `preferred_element_type=f32` does)."""
    dt = qkv.dtype
    o = mha_fwd_reference(qkv, num_heads, scale, segment_len)
    out = torch.matmul(o.float(), w.to(dt).float())
    return out if out_f32 else out.to(dt)


def fused_apla_attn_bwd_reference(qkv, w, g, inds, num_heads: int,
                                  scale: float, segment_len: int = 0):
    """Plain version of the backward kernel, rounding where the TPU kernel
    rounds (`pallas_apla_attn.py:_bwd_kernel`).

    qkv [B, N, 3K], w [K, C] (assembled), g [B, N, C] (cotangent of the
    projected output), inds [k] -> (dqkv [B, N, 3K] in qkv.dtype,
    dW_t [K, k] float32 summed over the batch)."""
    dt = qkv.dtype
    C = qkv.shape[-1] // 3
    g = g.to(dt)
    d_o = torch.matmul(g.float(), w.to(dt).float().t()).to(dt)
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    dq, dk, dv, pb = attention_grads(q, k, v, split_heads(d_o, num_heads),
                                     scale, segment_len, dt)
    o = torch.matmul(pb, v).to(dt)
    dqkv = torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)
    o_cat = merge_heads(o).reshape(-1, C).float()
    g_t = g.index_select(-1, inds).reshape(-1, inds.numel()).float()
    return dqkv, torch.matmul(o_cat.t(), g_t)


def _check_cuda_args(qkv, w, num_heads, segment_len):
    if qkv.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(
            f"fused APLA attention kernel takes bfloat16 qkv and w, got "
            f"{qkv.dtype} and {w.dtype} (run the model in bf16 or with "
            "use_fused_apla=False)")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise ValueError(f"kernel supports head dim {HEAD_DIM} only, got "
                         f"C={C} over {num_heads} heads")
    if w.dim() != 2 or w.shape[0] != C or w.shape[1] % 64 \
            or w.shape[1] < C:
        raise ValueError(f"w must be [{C}, N] with N >= {C} a multiple of "
                         f"64, got {tuple(w.shape)}")
    if w.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, w on {w.device}")
    if not (qkv.is_contiguous() and w.is_contiguous()):
        raise ValueError("qkv and w must be contiguous")
    if qkv.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("qkv and w must be 16-byte aligned")
    if segment_len < 0:
        raise ValueError(f"segment_len must be >= 0, got {segment_len}")
    if N == 0 or B == 0 or B > 65535 or B * N > proj_gemm.MAX_ROWS:
        raise ValueError(f"batch {B} x length {N} outside the kernel's grid")
    return B, N, C


def _check_bwd_args(qkv, w, g, inds, num_heads, segment_len):
    B, N, C = _check_cuda_args(qkv, w, num_heads, segment_len)
    width = w.shape[1]
    if g.dtype != qkv.dtype or tuple(g.shape) != (B, N, width):
        raise ValueError(f"g must be [{B}, {N}, {width}] {qkv.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.device != qkv.device or inds.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, g on {g.device}, inds on "
                         f"{inds.device}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be contiguous and 16-byte aligned")
    if inds.dim() != 1 or not 0 < inds.numel() <= width:
        raise ValueError(f"inds must be [k] with 0 < k <= {width}, got "
                         f"{tuple(inds.shape)}")
    return B, N, C


@functools.cache
def _bwd_library():
    lib = load_library(_BWD_SOURCE)
    lib.fused_apla_attn_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
    lib.fused_apla_attn_bwd.restype = ctypes.c_int
    lib.fused_apla_attn_bwd_prepare.argtypes = [ctypes.c_int]
    lib.fused_apla_attn_bwd_prepare.restype = ctypes.c_int
    return lib


def _launch(qkv, w, num_heads, scale, segment_len, out_f32=False):
    """The attention kernel into a scratch o [B, N, K], freed on return,
    then the projection GEMM over its B * N rows, on one stream.  The
    argument check covers both kernels' contracts."""
    B, N, K = _check_cuda_args(qkv, w, num_heads, segment_len)
    with launch_context(qkv) as stream:
        o = mha.launch_fwd(qkv, num_heads, scale, segment_len, stream,
                           (B, N, K))
        out = proj_gemm.launch(o, w, stream,
                               proj_gemm.gemm_plan(B * N, w.shape[1]),
                               out_f32)
    fused_apla_attn_fwd.launches += 1
    return out


def fused_apla_attn_fwd(qkv, w, num_heads: int, scale: float,
                        segment_len: int = 0, out_f32: bool = False):
    """qkv [B, N, 3K], w [K, C] (already assembled) -> [B, N, C], no bias
    (K = C on one rank, a rank's heads' rows under tensor parallelism);
    bf16, or with `out_f32` the f32 sums.

    CPU tensor: the plain version.  CUDA tensor: the two kernels, or an
    error naming why they cannot run (dtype, head dim, layout)."""
    if qkv.device.type == "cpu":
        return fused_apla_attn_fwd_reference(qkv, w, num_heads, scale,
                                             segment_len, out_f32)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused APLA attention for device {qkv.device}")
    return _launch(qkv, w, num_heads, scale, segment_len, out_f32)


fused_apla_attn_fwd.launches = 0


def dw_chunks(m: int, c: int, kp: int, n_sm: int, tile: int = 64):
    """(rows per chunk, number of chunks) for the dW_t partials: chunks of
    64-row steps, about four blocks per SM over (C/tile) x (Kp/tile)
    output tiles, every chunk non-empty.  The chunks fix the partials' sum
    order, so they stay those of the 64 x 64 tiles the first kernel used
    (tile = 64), whatever tiles the GEMM now takes."""
    steps = -(-m // 64)
    target = max(1, (4 * n_sm) // ((c // tile) * (kp // tile)))
    rows = 64 * -(-steps // min(target, steps))
    return rows, -(-m // rows)


# The dW_t partials' GEMM: 128 x 128 tiles over three stages (two blocks
# an SM), since Kp (128, or C) gives few column tiles.
DW_GEMM = (128, 3)


def bwd_plans(B: int, N: int, C: int, num_heads: int, kp: int,
              segment_len: int = 0):
    """(attention plan, dO GEMM plan, dW GEMM plan) of the backward's
    launches at this shape (C: the heads' width, K under tensor
    parallelism)."""
    return (mha.bwd_plan(B, N, num_heads, segment_len),
            proj_gemm.gemm_plan(B * N, C),
            proj_gemm.gemm_plan(C, kp, *DW_GEMM))


# every launch of the backward (`mha.PART_*` bits)
PARTS_ALL = mha.PART_DO | mha.PART_QUERY | mha.PART_KEY | mha.PART_DW


def _launch_bwd(qkv, w, g, inds, num_heads, scale, segment_len,
                parts=PARTS_ALL):
    B, N, C = _check_bwd_args(qkv, w, g, inds, num_heads, segment_len)
    width = w.shape[1]
    lib = _bwd_library()
    dev = device_index(qkv)
    k = inds.numel()
    kp = -(-k // _KP) * _KP
    attn, do_gemm, dw_gemm = bwd_plans(B, N, C, num_heads, kp, segment_len)
    mha.check_bwd_plan(attn, dev, _bwd_library,
                       "fused_apla_attn_bwd_prepare")
    check_smem(max(do_gemm.smem_bytes, dw_gemm.smem_bytes),
               device_smem(_bwd_library, "fused_apla_attn_bwd_prepare", dev),
               "the backward's GEMMs")
    g_t = g.index_select(-1, inds)            # contiguous [B, N, k]
    if kp != k:
        g_t = torch.nn.functional.pad(g_t, (0, kp - k))
    rows, n_chunks = dw_chunks(B * N, C, kp, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    dqkv = torch.empty_like(qkv)
    dwt = torch.empty((C, kp), dtype=torch.float32, device=qkv.device)
    d_o = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    o_cat = torch.empty_like(d_o)
    stats = mha.bwd_stats(B, N, num_heads, qkv.device)
    part = torch.empty((n_chunks, C, kp), dtype=torch.float32,
                       device=qkv.device)
    plan = mha.plan_array(attn.args() + (
        do_gemm.bn, do_gemm.stages, do_gemm.smem_bytes,
        dw_gemm.bn, dw_gemm.stages, dw_gemm.smem_bytes))
    with launch_context(qkv) as stream:
        err = lib.fused_apla_attn_bwd(
            qkv.data_ptr(), w.data_ptr(), g.data_ptr(), g_t.data_ptr(),
            dqkv.data_ptr(), dwt.data_ptr(), d_o.data_ptr(), o_cat.data_ptr(),
            stats.data_ptr(), part.data_ptr(), B, N, C, width, num_heads,
            kp,
            float(scale), int(segment_len), rows, n_chunks, plan, parts,
            stream)
    if err == 2000:
        raise RuntimeError("fused_apla_attn_bwd: no GEMM of that width")
    if err >= 1000:
        raise RuntimeError(f"fused_apla_attn_bwd: tensor map not encoded: "
                           f"CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"fused_apla_attn_bwd launch failed: "
                           f"cudaError {err}")
    return dqkv, dwt[:, :k]


def fused_apla_attn_bwd(qkv, w, g, inds, num_heads: int, scale: float,
                        segment_len: int = 0):
    """Backward of `fused_apla_attn_fwd` with the trainable columns `inds`:
    qkv [B, N, 3K], w [K, C], g [B, N, C] -> (dqkv [B, N, 3K] in
    qkv.dtype, dW_t [K, k] float32).

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (dtype, head dim, shapes, shared memory)."""
    if qkv.device.type == "cpu":
        return fused_apla_attn_bwd_reference(qkv, w, g, inds, num_heads,
                                             scale, segment_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused APLA attention for device {qkv.device}")
    out = _launch_bwd(qkv, w, g, inds, num_heads, scale, segment_len)
    fused_apla_attn_bwd.launches += 1
    return out


fused_apla_attn_bwd.launches = 0


def fused_apla_attn_bwd_part(qkv, w, g, inds, num_heads: int, scale: float,
                             parts: int, segment_len: int = 0):
    """Some of the backward's launches alone (`mha.PART_*` bits: the dO
    GEMM, the query side, the key side, the dW partials and their sum), on
    CUDA tensors, uncounted: a measurement times them apart.  A launch run
    without the ones before it reads scratch they did not write, so only
    its time means anything."""
    return _launch_bwd(qkv, w, g, inds, num_heads, scale, segment_len, parts)


class FusedAplaAttention(torch.autograd.Function):
    """The JAX custom VJP (`pallas_apla_attn.py:507-564`) as an autograd
    `Function`.  Forward: the forward kernel; it saves qkv, the assembled
    W (in qkv.dtype) and `inds`, and nothing else: the backward recomputes
    p.  Backward: dqkv and dW_t from the backward kernel, db_t = sum of
    g[..., inds] in float32 outside it; no gradient for the frozen matrix,
    bias or `inds`.  `partial` (a tensor-parallel rank: qkv of its heads,
    the projection's rows [K, C]): the forward returns the f32 sums without
    the bias, which the caller adds after the model group's sum; no
    db_t."""

    @staticmethod
    def forward(ctx, qkv, w_t, b_t, w_frozen, b_frozen, inds, num_heads,
                scale, segment_len, partial=False):
        w, b = assemble(w_t, b_t, w_frozen, b_frozen, inds)
        w = w.to(qkv.dtype)
        out = fused_apla_attn_fwd(qkv, w, num_heads, scale, segment_len,
                                  out_f32=partial)
        ctx.save_for_backward(qkv, w, inds)
        ctx.args = (num_heads, scale, segment_len, w_t.dtype, b_t.dtype,
                    partial)
        return out if partial else out + b.to(out.dtype)

    @staticmethod
    def backward(ctx, g):
        qkv, w, inds = ctx.saved_tensors
        num_heads, scale, segment_len, wt_dtype, bt_dtype, partial = ctx.args
        dqkv, dw_t = fused_apla_attn_bwd(
            qkv, w, g.to(qkv.dtype).contiguous(), inds, num_heads, scale,
            segment_len)
        db_t = None if partial else \
            g.index_select(-1, inds).float().sum(dim=(0, 1)).to(bt_dtype)
        return (dqkv, dw_t.to(wt_dtype), db_t, None, None, None,
                None, None, None, None)


def fused_apla_attention(qkv, w_t, b_t, w_frozen, b_frozen, inds,
                         num_heads: int, scale: float, segment_len: int = 0,
                         partial: bool = False):
    """qkv [B, N, 3C] packed activations -> [B, N, C] projected output.

    `w_t` [C, k] / `b_t` [k] are the trainable columns written into the
    frozen `w_frozen` [C, C] / `b_frozen` [C] at `inds` [k].
    Differentiable in (qkv, w_t, b_t).  `partial`: a tensor-parallel
    rank's share, qkv [B, N, 3K] of its heads and the rows `w_t` [K, k],
    `w_frozen` [K, C] -> the f32 partial [B, N, C] without the bias."""
    return FusedAplaAttention.apply(qkv, w_t, b_t, w_frozen, b_frozen, inds,
                                    num_heads, float(scale), int(segment_len),
                                    bool(partial))
