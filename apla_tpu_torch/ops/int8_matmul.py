"""W8A8 matrix product with the activations quantized on the fly.

Counterpart of `apla_tpu/ops/pallas_int8_matmul.py` (`fused_int8_matmul`).
x [M, K] float times w_i8 [K, N] int8 with per-output-channel scales
w_scale [N] gives [M, N] in x's dtype.  Each row of x is quantized per group
of `group` consecutive k (one scale per (row, group)), the int8 products are
summed exactly in int32, and each group's sum is scaled into an f32
accumulator:

    sx  = max(max|x_grp| / 127, 1e-12)                     (f32)
    acc += (float(round(x_grp / sx) clipped to +-127 . w_grp) * sx) * sw

`group` = 256 is the TPU kernel's default K block; `group` = K is
`quant.int8_matmul`'s forward (one scale per row over the whole K), which the
W8A8 serving path runs in every frozen qkv / fc1 / fc2 product.

The hand-written CUDA kernel `csrc/int8_matmul.cu` replaces
`pallas_int8_matmul.py:_kernel` and, at `group` = K, `quant.py`'s XLA
`dot_general`: a quantize pass and an int8 `mma.sync` GEMM that masks the
ragged edge of M itself (the TPU kernel needs multiples of its blocks).  It
reads the weight K-major, [N, K]: `quant.QuantizedKernel` makes that copy
once, when a weight is quantized or loaded.

`fused_int8_matmul` is the wrapper: on a CPU tensor it runs the plain
PyTorch version below, on a CUDA tensor it launches the kernel or raises.
Its `launches` counts its kernel launches (one per call, and nothing else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import device_index, load_library

SOURCE = "int8_matmul.cu"
DEFAULT_GROUP = 256        # the TPU kernel's default K block


def _check_args(x, w_i8, w_scale, group):
    if x.dim() != 2 or w_i8.dim() != 2 or x.shape[1] != w_i8.shape[0]:
        raise ValueError(f"x must be [M, K] and w_i8 [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w_i8.shape)}")
    K, N = w_i8.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if w_i8.dtype != torch.int8 or w_scale.dtype != torch.float32 \
            or tuple(w_scale.shape) != (N,):
        raise ValueError(f"w_i8 must be int8 and w_scale float32 [{N}], got "
                         f"{w_i8.dtype} and {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    if group < 1 or K % group:
        raise ValueError(f"group {group} does not divide K = {K}")
    return K, N


def scale_of(amax):
    """max(amax / 127, 1e-12) in f32, the division IEEE as in JAX and the
    kernel: a Python-number divisor would let PyTorch's CUDA kernel multiply
    by the reciprocal instead, one ulp off for some amax."""
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)


def fused_int8_matmul_reference(x, w_i8, w_scale, group: int = DEFAULT_GROUP):
    """Plain version: x [M, K] (bf16 or f32), w_i8 [K, N] int8, w_scale [N]
    f32 -> [M, N] in x.dtype, rounding where the kernel rounds.  The int
    product is exact: an int32 `matmul` on the CPU, float64 on a card (torch
    has no int32 matmul there; every sum, at most 127^2 K, stays below
    2^53)."""
    K, N = _check_args(x, w_i8, w_scale, group)
    M = x.shape[0]
    xf = x.float().reshape(M, K // group, group)
    sx = scale_of(xf.abs().amax(dim=-1, keepdim=True))     # [M, ng, 1]
    codes = torch.clamp(torch.round(xf / sx), -127, 127)   # half to even
    exact = torch.int32 if x.device.type == "cpu" else torch.float64
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(K // group):
        part = torch.matmul(codes[:, g].to(exact),
                            w_i8[g * group:(g + 1) * group].to(exact))
        acc = acc + (part.float() * sx[:, g]) * w_scale[None, :]
    return acc.to(x.dtype)


@functools.cache
def _library():
    lib = load_library(SOURCE)
    lib.int8_matmul.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.int8_matmul.restype = ctypes.c_int
    return lib


def _aligned(*tensors):
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)


def _launch(x, w_scale, group, w_kmajor, K, N):
    M = x.shape[0]
    if K % 32 or group % 32 or N % 8:
        raise ValueError(f"the int8 kernel takes K and the group in "
                         f"multiples of 32 and N in multiples of 8, got "
                         f"K={K}, group={group}, N={N}")
    if w_kmajor is None or w_kmajor.dtype != torch.int8 \
            or tuple(w_kmajor.shape) != (N, K):
        raise ValueError(f"the int8 kernel needs the weight K-major, int8 "
                         f"[{N}, {K}] (quant.QuantizedKernel.w_kmajor)")
    for name, t in (("w_kmajor", w_kmajor), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"x on {x.device}, {name} on {t.device}")
    if not _aligned(x, w_kmajor, w_scale):
        raise ValueError("x, w_kmajor and w_scale must be contiguous and "
                         "16-byte aligned")
    if M >= 2 ** 31 - 128 or N > 65535 * 128:
        raise ValueError(f"[{M}, {N}] outside the kernel's grid")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, K // group), dtype=torch.float32, device=x.device)
    lib = _library()
    dev = device_index(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.int8_matmul(x.data_ptr(), int(x.dtype == torch.bfloat16),
                              w_kmajor.data_ptr(), w_scale.data_ptr(),
                              xq.data_ptr(), sx.data_ptr(), y.data_ptr(), M,
                              N, K, group, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
    fused_int8_matmul.launches += 1
    return y


def fused_int8_matmul(x, w_i8, w_scale, group: int = DEFAULT_GROUP,
                      w_kmajor=None):
    """x [M, K] bf16/f32 @ (w_i8 [K, N] int8, w_scale [N] f32) -> [M, N] in
    x.dtype, with one activation scale per (row, `group` of K).

    CPU tensor: the plain version.  CUDA tensor: the kernel, which reads
    `w_kmajor` ([N, K], w_i8 transposed and made contiguous once by the
    caller), or an error naming why it cannot run."""
    K, N = _check_args(x, w_i8, w_scale, group)
    if x.device.type == "cpu":
        return fused_int8_matmul_reference(x, w_i8, w_scale, group)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {x.device}")
    return _launch(x, w_scale, group, w_kmajor, K, N)


fused_int8_matmul.launches = 0
