"""Prototype cross-entropy: the DINOv2 head's prototype projection and the
row-wise teacher/student cross-entropy, without the [R, K] logits.

Counterpart of `apla_tpu/ops/pallas_proto_ce.py` (`proto_ce` and its custom
VJP).  Per row r of the L2-normalised bottlenecks `xs`, `xt` [R, D] and the
weight-normalised prototype layers `ws`, `wt` [D, K]:

  s = (xs ws) / tau_s,  t = (xt wt - center) / tau_t
  ce = lse_s - sum_k softmax(t)_k s_k

with the inputs rounded to bf16 and the products and logits in f32.  Three
hand-written CUDA kernels replace the TPU kernels:

- `csrc/proto_ce_fwd.cu` replaces `pallas_proto_ce.py:_fwd_kernel`: ce and
  both log-sum-exps, by online softmax over streamed prototype tiles;
- `csrc/proto_ce_bwd.cu` replaces `_dxs_kernel` (dxs = ds ws^T) and
  `_dws_kernel` (dws = xs^T ds), each recomputing the logits from the saved
  log-sum-exps, with ds = bf16(g (p_s - p_t) / tau_s).

`proto_ce_fwd`, `proto_ce_dxs` and `proto_ce_dws` are the wrappers: on a CPU
tensor they run the plain PyTorch versions below (`*_reference`), on a CUDA
tensor they launch the kernel or raise.  Each wrapper's `launches` counts
its kernel launches (one per call, and nothing else).  `ProtoCE` is the
autograd `Function` with the JAX custom VJP's contract: gradients flow to
(xs, ws) only; `teacher_temp` changes every step and is a float argument,
`student_temp` a constant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import check_smem, device_index, device_smem, \
    load_library

FWD_SOURCE = "proto_ce_fwd.cu"
BWD_SOURCE = "proto_ce_bwd.cu"
BOTTLENECK = 256        # the kernels' D (every DINOv2 recipe's bottleneck)
_TILE = 64              # rows / prototype columns per kernel tile


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def _logits(xs, ws, xt, wt, center, teacher_temp, student_temp):
    """f32 student and teacher logits [R, K] of the bf16-rounded inputs."""
    bf = torch.bfloat16
    s = torch.matmul(xs.to(bf).float(), ws.to(bf).float()) \
        * (1.0 / student_temp)
    t = (torch.matmul(xt.to(bf).float(), wt.to(bf).float())
         - center.float().reshape(1, -1)) / teacher_temp
    return s, t


def proto_ce_fwd_reference(xs, ws, xt, wt, center, teacher_temp: float,
                           student_temp: float):
    """-> (ce, lse_s, lse_t), each [R] f32."""
    s, t = _logits(xs, ws, xt, wt, center, teacher_temp, student_temp)
    lse_s = torch.logsumexp(s, dim=-1)
    lse_t = torch.logsumexp(t, dim=-1)
    t.sub_(lse_t[:, None]).exp_()                # p_t, in place
    return lse_s - (t * s).sum(dim=-1), lse_s, lse_t


def _ds_reference(xs, ws, xt, wt, center, teacher_temp, student_temp, lse_s,
                  lse_t, g):
    """bf16(g (p_s - p_t) / tau_s) [R, K], as f32."""
    s, t = _logits(xs, ws, xt, wt, center, teacher_temp, student_temp)
    s.sub_(lse_s[:, None]).exp_()
    t.sub_(lse_t[:, None]).exp_()
    ds = s.sub_(t).mul_(g.float()[:, None] * (1.0 / student_temp))
    return ds.to(torch.bfloat16).float()


def proto_ce_dxs_reference(xs, ws, xt, wt, center, teacher_temp: float,
                           student_temp: float, lse_s, lse_t, g):
    """dxs = ds ws^T [R, D] f32."""
    ds = _ds_reference(xs, ws, xt, wt, center, teacher_temp, student_temp,
                       lse_s, lse_t, g)
    return torch.matmul(ds, ws.to(torch.bfloat16).float().t())


def proto_ce_dws_reference(xs, ws, xt, wt, center, teacher_temp: float,
                           student_temp: float, lse_s, lse_t, g):
    """dws = xs^T ds [D, K] f32."""
    ds = _ds_reference(xs, ws, xt, wt, center, teacher_temp, student_temp,
                       lse_s, lse_t, g)
    return torch.matmul(xs.to(torch.bfloat16).float().t(), ds)


# --------------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------------- #

@functools.cache
def _fwd_library():
    lib = load_library(FWD_SOURCE)
    lib.proto_ce_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.proto_ce_fwd.restype = ctypes.c_int
    lib.proto_ce_fwd_smem_bytes.argtypes = []
    lib.proto_ce_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.proto_ce_fwd_prepare.argtypes = [ctypes.c_int]
    lib.proto_ce_fwd_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library():
    lib = load_library(BWD_SOURCE)
    for fn in (lib.proto_ce_dxs, lib.proto_ce_dws):
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.proto_ce_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.proto_ce_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.proto_ce_bwd_prepare.argtypes = [ctypes.c_int]
    lib.proto_ce_bwd_prepare.restype = ctypes.c_int
    return lib


def split_work(n_own: int, n_loop: int, n_sm: int):
    """(tiles per split, splits) of a loop of `n_loop` tiles when `n_own`
    blocks alone would leave SMs idle: about one block per SM, no split
    empty."""
    want = max(1, min(n_loop, -(-n_sm // n_own)))
    per = -(-n_loop // want)
    return per, -(-n_loop // per)


def _cuda_inputs(xs, ws, xt, wt, center, rows=()):
    """Checks the kernels' contract and returns contiguous bf16 xs, ws, xt,
    wt, f32 center and f32 `rows` tensors ([R] each)."""
    if xs.dim() != 2 or ws.dim() != 2:
        raise ValueError(f"xs must be [R, D] and ws [D, K], got "
                         f"{tuple(xs.shape)} and {tuple(ws.shape)}")
    R, D = xs.shape
    K = ws.shape[1]
    if D != BOTTLENECK:
        raise ValueError(f"the proto-CE kernels take bottleneck dim "
                         f"{BOTTLENECK} only, got {D}")
    if tuple(xt.shape) != (R, D) or tuple(ws.shape) != (D, K) \
            or tuple(wt.shape) != (D, K) or center.numel() != K:
        raise ValueError(f"shapes: xs {tuple(xs.shape)}, ws {tuple(ws.shape)}"
                         f", xt {tuple(xt.shape)}, wt {tuple(wt.shape)}, "
                         f"center {tuple(center.shape)}")
    if K % 8 or K == 0 or R == 0 or R > 65535 * _TILE:
        raise ValueError(f"the kernels take K a multiple of 8 and "
                         f"0 < R <= {65535 * _TILE}; got R={R}, K={K}")
    for name, t in (("ws", ws), ("xt", xt), ("wt", wt), ("center", center)) \
            + tuple((f"row input {i}", r) for i, r in enumerate(rows)):
        if t.device != xs.device:
            raise ValueError(f"xs on {xs.device}, {name} on {t.device}")
    for name, t in zip(("xs", "ws", "xt", "wt", "center"),
                       (xs, ws, xt, wt, center)):
        if not t.dtype.is_floating_point:
            raise ValueError(f"{name} must be floating point, got {t.dtype}")
    bf = torch.bfloat16
    out = [t.to(bf).contiguous() for t in (xs, ws, xt, wt)]
    out.append(center.reshape(K).float().contiguous())
    out += [r.reshape(R).float().contiguous() for r in rows]
    return out


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _launch_fwd(xs, ws, xt, wt, center, teacher_temp, student_temp):
    xs, ws, xt, wt, c = _cuda_inputs(xs, ws, xt, wt, center)
    lib = _fwd_library()
    dev = device_index(xs)
    check_smem(lib.proto_ce_fwd_smem_bytes(),
               device_smem(_fwd_library, "proto_ce_fwd_prepare", dev),
               "the forward")
    R, K = xs.shape[0], ws.shape[1]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    per, n_split = split_work(-(-R // _TILE), -(-K // _TILE), n_sm)
    part = torch.empty((5, 2 * n_split, R), dtype=torch.float32,
                       device=xs.device)
    ce, lse_s, lse_t = (torch.empty(R, dtype=torch.float32, device=xs.device)
                        for _ in range(3))
    with torch.cuda.device(dev):
        err = lib.proto_ce_fwd(
            xs.data_ptr(), ws.data_ptr(), xt.data_ptr(), wt.data_ptr(),
            c.data_ptr(), part.data_ptr(), ce.data_ptr(), lse_s.data_ptr(),
            lse_t.data_ptr(), R, K, n_split, per, 1.0 / float(student_temp),
            float(teacher_temp), _stream(dev))
    _raise_on(err, "proto_ce_fwd")
    proto_ce_fwd.launches += 1
    return ce, lse_s, lse_t


def _launch_bwd(fn_name, xs, ws, xt, wt, center, teacher_temp, student_temp,
                lse_s, lse_t, g):
    xs, ws, xt, wt, c, lse_s, lse_t, g = _cuda_inputs(
        xs, ws, xt, wt, center, rows=(lse_s, lse_t, g))
    lib = _bwd_library()
    dev = device_index(xs)
    which = 0 if fn_name == "proto_ce_dxs" else 1
    check_smem(lib.proto_ce_bwd_smem_bytes(which),
               device_smem(_bwd_library, "proto_ce_bwd_prepare", dev),
               fn_name)
    R, D = xs.shape
    K = ws.shape[1]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_rt, n_kt = -(-R // _TILE), -(-K // _TILE)
    if which == 0:
        per, n_split = split_work(n_rt, n_kt, n_sm)
        out = torch.empty((R, D), dtype=torch.float32, device=xs.device)
        part_shape = (n_split, R, D)
    else:
        per, n_split = split_work(n_kt, n_rt, n_sm)
        out = torch.empty((D, K), dtype=torch.float32, device=xs.device)
        part_shape = (n_split, D, K)
    part = torch.empty(part_shape if n_split > 1 else (1,),
                       dtype=torch.float32, device=xs.device)
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            xs.data_ptr(), ws.data_ptr(), xt.data_ptr(), wt.data_ptr(),
            c.data_ptr(), lse_s.data_ptr(), lse_t.data_ptr(), g.data_ptr(),
            out.data_ptr(), part.data_ptr(), R, K, n_split, per,
            1.0 / float(student_temp), float(teacher_temp), _stream(dev))
    _raise_on(err, fn_name)
    return out


def _on_device(xs, what):
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {xs.device}")
    return xs.device.type == "cuda"


def proto_ce_fwd(xs, ws, xt, wt, center, teacher_temp: float,
                 student_temp: float):
    """-> (ce, lse_s, lse_t), each [R] f32.

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    naming why it cannot run (shape, device, shared memory)."""
    if not _on_device(xs, "prototype CE"):
        return proto_ce_fwd_reference(xs, ws, xt, wt, center, teacher_temp,
                                      student_temp)
    return _launch_fwd(xs, ws, xt, wt, center, teacher_temp, student_temp)


proto_ce_fwd.launches = 0


def proto_ce_dxs(xs, ws, xt, wt, center, teacher_temp: float,
                 student_temp: float, lse_s, lse_t, g):
    """Gradient of sum_r g_r ce_r with respect to xs: [R, D] f32.

    CPU tensor: the plain version.  CUDA tensor: the kernel or an error."""
    if not _on_device(xs, "prototype CE"):
        return proto_ce_dxs_reference(xs, ws, xt, wt, center, teacher_temp,
                                      student_temp, lse_s, lse_t, g)
    out = _launch_bwd("proto_ce_dxs", xs, ws, xt, wt, center, teacher_temp,
                      student_temp, lse_s, lse_t, g)
    proto_ce_dxs.launches += 1
    return out


proto_ce_dxs.launches = 0


def proto_ce_dws(xs, ws, xt, wt, center, teacher_temp: float,
                 student_temp: float, lse_s, lse_t, g):
    """Gradient of sum_r g_r ce_r with respect to ws: [D, K] f32.

    CPU tensor: the plain version.  CUDA tensor: the kernel or an error."""
    if not _on_device(xs, "prototype CE"):
        return proto_ce_dws_reference(xs, ws, xt, wt, center, teacher_temp,
                                      student_temp, lse_s, lse_t, g)
    out = _launch_bwd("proto_ce_dws", xs, ws, xt, wt, center, teacher_temp,
                      student_temp, lse_s, lse_t, g)
    proto_ce_dws.launches += 1
    return out


proto_ce_dws.launches = 0


class ProtoCE(torch.autograd.Function):
    """The JAX custom VJP (`pallas_proto_ce.py:221-341`) as an autograd
    `Function`.  Forward: the forward kernel; it saves the inputs and both
    log-sum-exps.  Backward: dxs and dws from their kernels; no gradient
    for the teacher side (xt, wt, center) or the temperatures."""

    @staticmethod
    def forward(ctx, xs, ws, xt, wt, center, teacher_temp, student_temp):
        ce, lse_s, lse_t = proto_ce_fwd(xs, ws, xt, wt, center, teacher_temp,
                                        student_temp)
        ctx.save_for_backward(xs, ws, xt, wt, center, lse_s, lse_t)
        ctx.temps = (float(teacher_temp), float(student_temp))
        return ce

    @staticmethod
    def backward(ctx, g):
        xs, ws, xt, wt, center, lse_s, lse_t = ctx.saved_tensors
        args = (xs, ws, xt, wt, center) + ctx.temps + (lse_s, lse_t,
                                                       g.float())
        dxs = proto_ce_dxs(*args) if ctx.needs_input_grad[0] else None
        dws = proto_ce_dws(*args) if ctx.needs_input_grad[1] else None
        return (None if dxs is None else dxs.to(xs.dtype),
                None if dws is None else dws.to(ws.dtype),
                None, None, None, None, None)


def proto_ce(xs, ws, xt, wt, center, teacher_temp: float,
             student_temp: float):
    """Per-row prototype CE [R] f32 (`pallas_proto_ce.py:proto_ce`).

    `xs`/`xt` [R, D] student / teacher bottlenecks, `ws`/`wt` [D, K] the
    weight-normalised prototype layers, `center` [K] or [1, K] the teacher
    center.  Differentiable in (xs, ws); the teacher side is a constant."""
    return ProtoCE.apply(xs, ws, xt.detach(), wt.detach(), center.detach(),
                         float(teacher_temp), float(student_temp))
