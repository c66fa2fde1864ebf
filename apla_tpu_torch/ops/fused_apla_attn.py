"""Fused APLA attention: softmax(q k^T) v and the partial-trainable output
projection in one kernel.

Counterpart of `apla_tpu/ops/pallas_apla_attn.py` (`fused_apla_attention`,
forward only).  The kernel, `csrc/fused_apla_attn_fwd.cu`, replaces the TPU
kernel `pallas_apla_attn.py:_fwd_kernel`: per head, f32 scores masked to the
row's segment, p rounded to the input dtype, p v, the heads concatenated and
multiplied by the assembled `[C, C]` projection without the attention output
leaving the chip.  The bias is added outside the kernel.

`fused_apla_attn_fwd` is the wrapper: on a CPU tensor it runs the plain
PyTorch version below (`fused_apla_attn_fwd_reference`), on a CUDA tensor it
launches the kernel or raises.  `fused_apla_attn_fwd.launches` counts kernel
launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .apla_proj import assemble
from .cuda_build import load_library

_SOURCE = "fused_apla_attn_fwd.cu"
HEAD_DIM = 64          # the kernel's head dim (every ViT builder's)


def fused_apla_attn_fwd_reference(qkv, w, num_heads: int, scale: float,
                                  segment_len: int = 0):
    """Plain version of the kernel, rounding where the TPU kernel rounds.

    qkv [B, N, 3C], w [C, C] -> [B, N, C] in qkv.dtype.  Products are taken
    in f32 on the upcast inputs (as `preferred_element_type=f32` does)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // num_heads
    dt = qkv.dtype
    q, k, v = (t.reshape(B, N, num_heads, dh).transpose(1, 2).float()
               for t in qkv.split(C, dim=-1))                 # [B, H, N, Dh]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale          # f32 scores
    if segment_len:
        seg = torch.arange(N, device=qkv.device) // segment_len
        s = s.masked_fill(seg[:, None] != seg[None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = torch.matmul(p, v).transpose(1, 2).reshape(B, N, C).to(dt)
    return torch.matmul(o.float(), w.to(dt).float()).to(dt)


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
    if tuple(w.shape) != (C, C):
        raise ValueError(f"w must be [{C}, {C}], got {tuple(w.shape)}")
    if w.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, w on {w.device}")
    if not (qkv.is_contiguous() and w.is_contiguous()):
        raise ValueError("qkv and w must be contiguous")
    if qkv.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("qkv and w must be 16-byte aligned")
    if segment_len < 0:
        raise ValueError(f"segment_len must be >= 0, got {segment_len}")
    if N == 0 or B == 0 or B > 65535:
        raise ValueError(f"batch {B} x length {N} outside the kernel's grid")
    return B, N, C


@functools.cache
def _library():
    lib = load_library(_SOURCE)
    lib.fused_apla_attn_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.fused_apla_attn_fwd.restype = ctypes.c_int
    lib.fused_apla_attn_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_apla_attn_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.fused_apla_attn_fwd_prepare.argtypes = [ctypes.c_int]
    lib.fused_apla_attn_fwd_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _smem_bytes(C: int) -> int:
    """Dynamic shared memory one block needs at width C."""
    return _library().fused_apla_attn_fwd_smem_bytes(C)


@functools.cache
def _device_smem(dev: int) -> int:
    """Opts the kernel in to device `dev`'s largest dynamic shared memory,
    once per device, and returns that size in bytes."""
    with torch.cuda.device(dev):
        have = _library().fused_apla_attn_fwd_prepare(dev)
    if have < 0:
        raise RuntimeError(f"could not set the kernel's shared memory limit "
                           f"on cuda:{dev}")
    return have


def _launch(qkv, w, num_heads, scale, segment_len):
    B, N, C = _check_cuda_args(qkv, w, num_heads, segment_len)
    lib = _library()
    dev = qkv.device.index if qkv.device.index is not None \
        else torch.cuda.current_device()
    need = _smem_bytes(C)
    have = _device_smem(dev)
    if need > have:
        raise ValueError(
            f"shared memory too small: C={C} needs {need} bytes of dynamic "
            f"shared memory per block, the device allows {have}")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_apla_attn_fwd(qkv.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), B, N, C, num_heads,
                                      float(scale), int(segment_len), stream)
    if err != 0:
        raise RuntimeError(f"fused_apla_attn_fwd launch failed: "
                           f"cudaError {err}")
    fused_apla_attn_fwd.launches += 1
    return out


def fused_apla_attn_fwd(qkv, w, num_heads: int, scale: float,
                        segment_len: int = 0):
    """qkv [B, N, 3C], w [C, C] (already assembled) -> [B, N, C], no bias.

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (dtype, head dim, shared memory)."""
    if qkv.device.type == "cpu":
        return fused_apla_attn_fwd_reference(qkv, w, num_heads, scale,
                                             segment_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused APLA attention for device {qkv.device}")
    return _launch(qkv, w, num_heads, scale, segment_len)


fused_apla_attn_fwd.launches = 0


def fused_apla_attention(qkv, w_t, b_t, w_frozen, b_frozen, inds,
                         num_heads: int, scale: float, segment_len: int = 0):
    """qkv [B, N, 3C] packed activations -> [B, N, C] projected output.

    `w_t` [C, k] / `b_t` [k] are the trainable columns written into the
    frozen `w_frozen` [C, C] / `b_frozen` [C] at `inds` [k]."""
    w, b = assemble(w_t, b_t, w_frozen, b_frozen, inds)
    out = fused_apla_attn_fwd(qkv, w.to(qkv.dtype), num_heads,
                              float(scale), int(segment_len))
    return out + b.to(out.dtype)
