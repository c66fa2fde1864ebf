"""Fused Swin window attention: softmax(q k^T * scale + bias + mask) v over
each window and the whole (trainable) output projection in one kernel, and
its backward.

Counterpart of `apla_tpu/ops/pallas_apla_attn.py:fused_swin_attention` and
its custom VJP.  The kernels are templates (`csrc/fused_apla_attn_fwd.cu`,
which also held row 1's ViT forward until that became two launches, and
row 2's `csrc/fused_apla_attn_bwd.cu` with `csrc/attn_bwd.cuh`),
instantiated at head dim 32 with the bias and mask added to the scores, as
the TPU builds its Swin kernels from rows 1 and 2's bodies:

- `fused_swin_attn_fwd` replaces `pallas_apla_attn.py:_fwd_kernel_bias`
  (through `_call_fwd_swin`): per window and head, f32 scores
  `(q k^T * scale + bias[h]) + mask[b mod nW]`, p normalised in f32 and
  rounded to bf16, p v, the heads concatenated (bf16) and multiplied by the
  `[C, C]` projection in f32, stored as bf16.  The projection's bias is
  added outside the kernel, in the output dtype.
- `fused_swin_attn_bwd` replaces `pallas_apla_attn.py:_bwd_kernel_bias`
  (through `_call_bwd_swin`): `dO = bf16(g W^T)`, p recomputed, `dq/dk/dv`
  packed `[B, N, 3C]`, and `dW = o_cat^T g` summed in f32 over every window
  and row (fixed-order partials: reruns are bit-equal).

Windows are `[B, N, 3C]` with B = images x windows, the image outermost
(`models.swin._window_partition`), so window b's mask plane is `b mod nW`.
N = 49 is one 64-row tile; the kernels mask its 15 padded rows and columns
themselves (the TPU wrapper's padding copies are layout choices, not part
of the function).

`fused_swin_attn_fwd` / `fused_swin_attn_bwd` are the wrappers: on a CPU
tensor they run the plain PyTorch versions below (`*_reference`), on a
CUDA tensor they launch the kernel or raise.  Each wrapper's `launches`
counts its kernel launches (one per call, and nothing else).
`FusedSwinAttention` is the autograd `Function` over both, with the JAX
custom VJP's contract: differentiable in qkv, w and b; the bias and mask
are frozen and get no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import check_smem, device_index, device_smem, load_library
from .fused_apla_attn import _BWD_SOURCE, dw_chunks
from .mha import attention_grads, merge_heads, softmax_f32, split_heads

_SOURCE = "fused_apla_attn_fwd.cu"
HEAD_DIM = 32          # the Swin kernels' head dim (every Swin builder's)


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
    dt = qkv.dtype
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    p = softmax_f32(q, k, scale, 0, _terms(bias, mask, qkv.shape[0]))
    o = merge_heads(torch.matmul(p.to(dt).float(), v)).to(dt)
    return torch.matmul(o.float(), w.to(dt).float()).to(dt)


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


@functools.cache
def _fwd_library():
    lib = load_library(_SOURCE)
    lib.fused_swin_attn_fwd.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    lib.fused_swin_attn_fwd.restype = ctypes.c_int
    lib.fused_swin_attn_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_swin_attn_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_swin_attn_fwd_prepare.argtypes = [ctypes.c_int]
    lib.fused_swin_attn_fwd_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library():
    lib = load_library(_BWD_SOURCE)
    lib.fused_swin_attn_bwd.argtypes = [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    lib.fused_swin_attn_bwd.restype = ctypes.c_int
    lib.fused_apla_attn_bwd_smem_bytes.argtypes = []
    lib.fused_apla_attn_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_swin_attn_bwd_prepare.argtypes = [ctypes.c_int]
    lib.fused_swin_attn_bwd_prepare.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(qkv, w, bias, mask, num_heads, scale):
    B, N, C = _check(qkv, w, bias, mask, num_heads)
    lib = _fwd_library()
    dev = device_index(qkv)
    check_smem(lib.fused_swin_attn_fwd_smem_bytes(C),
               device_smem(_fwd_library, "fused_swin_attn_fwd_prepare", dev),
               f"the Swin window forward at C={C}")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    n_w = 1 if mask is None else mask.shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_swin_attn_fwd(
            qkv.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(mask),
            out.data_ptr(), B, N, C, num_heads, n_w, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"fused_swin_attn_fwd launch failed: cudaError "
                           f"{err}")
    fused_swin_attn_fwd.launches += 1
    return out


def fused_swin_attn_fwd(qkv, w, bias, mask, num_heads: int, scale: float):
    """qkv [B, N, 3C] (B = images x windows), w [C, C], bias [H, N, N] f32,
    mask [nW, N, N] f32 or None (a block that is not shifted) ->
    [B, N, C], without the projection's bias.

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (dtype, head dim, shapes, shared memory)."""
    if qkv.device.type == "cpu":
        return fused_swin_attn_fwd_reference(qkv, w, bias, mask, num_heads,
                                             scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused Swin attention for device {qkv.device}")
    return _launch_fwd(qkv, w, bias, mask, num_heads, scale)


fused_swin_attn_fwd.launches = 0


def _launch_bwd(qkv, w, g, bias, mask, num_heads, scale):
    B, N, C = _check(qkv, w, bias, mask, num_heads)
    if g.dtype != qkv.dtype or tuple(g.shape) != (B, N, C):
        raise ValueError(f"g must be [{B}, {N}, {C}] {qkv.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if g.device != qkv.device or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be contiguous, 16-byte aligned and on "
                         "qkv's device")
    lib = _bwd_library()
    dev = device_index(qkv)
    check_smem(lib.fused_apla_attn_bwd_smem_bytes(),
               device_smem(_bwd_library, "fused_swin_attn_bwd_prepare", dev),
               "the Swin window backward")
    tile = 64 if C % 64 == 0 else 32
    rows, n_chunks = dw_chunks(B * N, C, C, torch.cuda.get_device_properties(
        dev).multi_processor_count, tile)
    dqkv = torch.empty_like(qkv)
    dw = torch.empty((C, C), dtype=torch.float32, device=qkv.device)
    d_o = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    o_cat = torch.empty_like(d_o)
    stats = torch.empty((3, B, num_heads, N), dtype=torch.float32,
                        device=qkv.device)
    part = torch.empty((n_chunks, C, C), dtype=torch.float32,
                       device=qkv.device)
    n_w = 1 if mask is None else mask.shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_swin_attn_bwd(
            qkv.data_ptr(), w.data_ptr(), g.data_ptr(), bias.data_ptr(),
            _ptr(mask), dqkv.data_ptr(), dw.data_ptr(), d_o.data_ptr(),
            o_cat.data_ptr(), stats.data_ptr(), part.data_ptr(), B, N, C,
            num_heads, n_w, float(scale), rows, n_chunks, stream)
    if err != 0:
        raise RuntimeError(f"fused_swin_attn_bwd launch failed: cudaError "
                           f"{err}")
    fused_swin_attn_bwd.launches += 1
    return dqkv, dw


def fused_swin_attn_bwd(qkv, w, g, bias, mask, num_heads: int,
                        scale: float):
    """Backward of `fused_swin_attn_fwd`: -> (dqkv [B, N, 3C] in
    qkv.dtype, dW [C, C] float32).

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (dtype, head dim, shapes, shared memory)."""
    if qkv.device.type == "cpu":
        return fused_swin_attn_bwd_reference(qkv, w, g, bias, mask,
                                             num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused Swin attention for device {qkv.device}")
    return _launch_bwd(qkv, w, g, bias, mask, num_heads, scale)


fused_swin_attn_bwd.launches = 0


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
