"""Prototype cross-entropy: the DINOv2 head's prototype projection and the
row-wise teacher/student cross-entropy, without the [R, K] logits.

Counterpart of `apla_tpu/ops/pallas_proto_ce.py` (`proto_ce` and its custom
VJP).  Per row r of the L2-normalised bottlenecks `xs`, `xt` [R, D] and the
weight-normalised prototype layers `ws`, `wt` [D, K]:

  s = (xs ws) / tau_s,  t = (xt wt - center) / tau_t
  ce = lse_s - sum_k softmax(t)_k s_k

with the inputs rounded to bf16 and the products and logits in f32.  Three
hand-written CUDA kernels replace the TPU kernels, all TMA and `wgmma`, a
producer warp streaming one side through a ring of 32-wide tiles and one or
two consumer warpgroups a block, each owning 64 rows (forward, dxs) or
prototype columns (dws):

- `csrc/proto_ce_fwd.cu` replaces `pallas_proto_ce.py:_fwd_kernel`: ce and
  both log-sum-exps by online softmax over the streamed prototype tiles,
  the rows held in registers as the logits' A operand; `proto_fwd_plan`
  lays it out;
- `csrc/proto_ce_bwd.cu` replaces `_dxs_kernel` (dxs = ds ws^T) and
  `_dws_kernel` (dws = xs^T ds), each recomputing the logits from the saved
  log-sum-exps, with ds = bf16(g (p_s - p_t) / tau_s) kept in registers as
  the product's A operand; a dws row tile whose g are all 0 is skipped.
  `proto_bwd_plan` lays them out.

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
import dataclasses
import functools

import torch

from .cuda_build import check_smem, device_index, device_smem, \
    launch_context, load_library
from .mha import BLOCK_SMEM, SMS, plan_array

FWD_SOURCE = "proto_ce_fwd.cu"
BWD_SOURCE = "proto_ce_bwd.cu"
BOTTLENECK = 256        # the kernels' D (every DINOv2 recipe's bottleneck)
_TILE = 64              # rows / prototype columns per kernel tile
# The launch plans (`proto_fwd_plan`, `proto_bwd_plan`), in the units of
# `csrc/proto_ce_{fwd,bwd}.cu`: a consumer warpgroup owns a 64-wide tile
# (forward, dxs: rows, dws: prototype columns); a ring stage holds one
# 32-wide streamed tile of each of s and t (32 KB).  The backward holds its
# consumers' s and t operands in shared memory (64 KB each) and beside each
# stage its side data (512 bytes); the forward holds its rows in registers,
# and a stage's 32 centers (128 bytes).  1 KB aligns the base, 256 bytes
# hold the barriers.
STREAM = 32
STAGE_BYTES = 2 * STREAM * BOTTLENECK * 2
BWD_OWN_BYTES = 2 * _TILE * BOTTLENECK * 2
BWD_STAGE_BYTES = STAGE_BYTES + STREAM * 16
FWD_STAGE_BYTES = STAGE_BYTES + STREAM * 4
BWD_MAX_STAGES = 5
FWD_MAX_STAGES = 6
# A block of two consumer warpgroups takes this many times the time of a
# block of one for twice its work (the two share the SM's tensor cores and
# hide each other's exponentials): set from `chip_smoke.py` phase 6a's
# one-group and two-group times at the iBOT site, 1.46 (dws) and 1.59
# (dxs) on an NVIDIA H100 80GB HBM3 at 700 W; the forward's read about
# the same (PERF.md §6).
TWO_GROUP_COST = 1.5
MAX_SPLITS = 65535      # the grid's y extent


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
    lib.proto_ce_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                                 + [ctypes.POINTER(ctypes.c_int)]
                                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.proto_ce_fwd.restype = ctypes.c_int
    lib.proto_ce_fwd_prepare.argtypes = [ctypes.c_int]
    lib.proto_ce_fwd_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library():
    lib = load_library(BWD_SOURCE)
    for fn in (lib.proto_ce_dxs, lib.proto_ce_dws):
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
                       + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
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


def bwd_smem(groups: int, stages: int) -> int:
    """Dynamic shared memory of a backward block (`smem_bytes` in
    `csrc/proto_ce_bwd.cu`)."""
    return 1024 + groups * BWD_OWN_BYTES + stages * BWD_STAGE_BYTES + 256


def fwd_smem(stages: int) -> int:
    """Dynamic shared memory of a forward block (`smem_bytes` in
    `csrc/proto_ce_fwd.cu`), whatever its warpgroups."""
    return 1024 + stages * FWD_STAGE_BYTES + 256


@dataclasses.dataclass(frozen=True)
class ProtoPlan:
    """How a prototype-CE kernel covers its work.  The own side (forward
    and dxs: the row tiles, dws: the prototype column tiles, 64 wide) is
    dealt to consumer warpgroups, `groups` a block: warpgroup w of block b
    owns tile b + w * `blocks_x`.  The loop side (forward and dxs: the
    prototype columns, dws: the rows) is cut into `splits` ranges of `per`
    64-wide units (`split_work`'s boundaries, whatever the streamed width),
    each summed into a partial when there are several.  `stages`: the ring
    of streamed tiles."""
    which: str
    own_tiles: int
    loop_tiles: int
    groups: int
    blocks_x: int
    splits: int
    per: int
    stages: int
    smem_bytes: int

    def args(self) -> tuple:
        """The C entries' plan ints."""
        return (self.groups, self.stages, self.splits, self.per,
                self.smem_bytes, self.blocks_x)

    def describe(self) -> str:
        return (f"{self.which}: {self.groups} warpgroup(s) a block, "
                f"{self.blocks_x} x {self.splits} blocks, {self.per} "
                f"64-wide units a split, {self.stages} stages, "
                f"{self.smem_bytes} bytes of shared memory")


def _plan(which, own, loop, n_sm, groups, smem, max_stages, stage_bytes):
    """The plan of a kernel whose own side has `own` 64-wide tiles and loop
    side `loop`: splits by `split_work`; two warpgroups a block unless the
    blocks of one fill the SMs in fewer waves by more than TWO_GROUP_COST
    (`groups` forces the choice); as many stages as fit, up to
    `max_stages`; `smem(groups, stages)` the block's shared memory."""
    per, splits = split_work(own, loop, n_sm)
    if groups is None:
        def waves(blocks):
            return -(-blocks // n_sm)
        groups = 2 if own > 1 and waves(-(-own // 2) * splits) \
            * TWO_GROUP_COST < waves(own * splits) else 1
    if groups not in (1, 2):
        raise ValueError(f"one or two warpgroups a block, not {groups}")
    stages = min(max_stages,
                 (BLOCK_SMEM - smem(groups, 0)) // stage_bytes)
    blocks_x = -(-own // groups)
    if splits > MAX_SPLITS or blocks_x >= 2 ** 31:
        raise ValueError(f"{own} x {loop} tiles outside the kernels' grid")
    return ProtoPlan(which=which, own_tiles=own, loop_tiles=loop,
                     groups=groups, blocks_x=blocks_x, splits=splits,
                     per=per, stages=stages,
                     smem_bytes=smem(groups, stages))


def _check_shape(R, K):
    if R < 1 or K < 8 or K % 8:
        raise ValueError(f"the kernels take R >= 1 and K a multiple of 8; "
                         f"got R={R}, K={K}")
    return -(-R // _TILE), -(-K // _TILE)


@functools.lru_cache(maxsize=256)
def proto_fwd_plan(R: int, K: int, n_sm: int = SMS,
                   groups: int | None = None) -> ProtoPlan:
    """The forward's launch plan at R rows and K prototypes on a card of
    `n_sm` SMs, a pure function of the shape: warpgroups own the row tiles,
    the blocks split K at `split_work`'s 64-wide boundaries.  Raises
    ValueError for a shape the kernel does not take."""
    n_rt, n_kt = _check_shape(R, K)
    return _plan("fwd", n_rt, n_kt, n_sm, groups,
                 lambda g, stages: fwd_smem(stages), FWD_MAX_STAGES,
                 FWD_STAGE_BYTES)


@functools.lru_cache(maxsize=256)
def proto_bwd_plan(which: str, R: int, K: int, n_sm: int = SMS,
                   groups: int | None = None) -> ProtoPlan:
    """The launch plan of `which` ("dxs" or "dws") at R rows and K
    prototypes on a card of `n_sm` SMs, a pure function of the shape.  The
    splits are `split_work`'s over 64-wide tiles.  Raises ValueError for a
    shape the kernels do not take."""
    if which not in ("dxs", "dws"):
        raise ValueError(f"no backward kernel {which!r}")
    n_rt, n_kt = _check_shape(R, K)
    own, loop = (n_rt, n_kt) if which == "dxs" else (n_kt, n_rt)
    return _plan(which, own, loop, n_sm, groups, bwd_smem, BWD_MAX_STAGES,
                 BWD_STAGE_BYTES)


@functools.lru_cache(maxsize=256)
def _plan_ints(which: str, R: int, K: int, n_sm: int, groups):
    plan = proto_fwd_plan(R, K, n_sm, groups) if which == "fwd" \
        else proto_bwd_plan(which, R, K, n_sm, groups)
    return plan, plan_array(plan.args())


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


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _launch_fwd(xs, ws, xt, wt, center, teacher_temp, student_temp,
                groups=None):
    xs, ws, xt, wt, c = _cuda_inputs(xs, ws, xt, wt, center)
    lib = _fwd_library()
    dev = device_index(xs)
    R, K = xs.shape[0], ws.shape[1]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan, ints = _plan_ints("fwd", R, K, n_sm, groups)
    check_smem(plan.smem_bytes,
               device_smem(_fwd_library, "proto_ce_fwd_prepare", dev),
               "the forward")
    part = torch.empty((5, 2 * plan.splits, R) if plan.splits > 1 else (1,),
                       dtype=torch.float32, device=xs.device)
    ce, lse_s, lse_t = (torch.empty(R, dtype=torch.float32, device=xs.device)
                        for _ in range(3))
    with launch_context(xs) as stream:
        err = lib.proto_ce_fwd(
            xs.data_ptr(), ws.data_ptr(), xt.data_ptr(), wt.data_ptr(),
            c.data_ptr(), part.data_ptr(), ce.data_ptr(), lse_s.data_ptr(),
            lse_t.data_ptr(), R, K, ints, 1.0 / float(student_temp),
            float(teacher_temp), stream)
    _raise_on(err, "proto_ce_fwd")
    return ce, lse_s, lse_t


def proto_ce_fwd_launch(xs, ws, xt, wt, center, teacher_temp: float,
                        student_temp: float, groups: int):
    """`proto_ce_fwd` on CUDA tensors with `groups` consumer warpgroups a
    block, whatever `proto_fwd_plan` would choose; not counted in the
    wrapper's launches.  For timing the two block shapes against each
    other (`chip_smoke.py` phase 6a)."""
    return _launch_fwd(xs, ws, xt, wt, center, teacher_temp, student_temp,
                       groups)


def _launch_bwd(which, xs, ws, xt, wt, center, teacher_temp, student_temp,
                lse_s, lse_t, g, groups=None):
    xs, ws, xt, wt, c, lse_s, lse_t, g = _cuda_inputs(
        xs, ws, xt, wt, center, rows=(lse_s, lse_t, g))
    lib = _bwd_library()
    dev = device_index(xs)
    R, D = xs.shape
    K = ws.shape[1]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan, ints = _plan_ints(which, R, K, n_sm, groups)
    check_smem(plan.smem_bytes,
               device_smem(_bwd_library, "proto_ce_bwd_prepare", dev),
               f"proto_ce_{which}")
    shape = (R, D) if which == "dxs" else (D, K)
    out = torch.empty(shape, dtype=torch.float32, device=xs.device)
    part = torch.empty((plan.splits,) + shape if plan.splits > 1 else (1,),
                       dtype=torch.float32, device=xs.device)
    with launch_context(xs) as stream:
        err = getattr(lib, f"proto_ce_{which}")(
            xs.data_ptr(), ws.data_ptr(), xt.data_ptr(), wt.data_ptr(),
            c.data_ptr(), lse_s.data_ptr(), lse_t.data_ptr(), g.data_ptr(),
            out.data_ptr(), part.data_ptr(), R, K, ints,
            1.0 / float(student_temp), float(teacher_temp), stream)
    _raise_on(err, f"proto_ce_{which}")
    return out


def proto_ce_bwd_launch(which, xs, ws, xt, wt, center, teacher_temp: float,
                        student_temp: float, lse_s, lse_t, g, groups: int):
    """`proto_ce_dxs` (which = "dxs") or `proto_ce_dws` on CUDA tensors with
    `groups` consumer warpgroups a block, whatever `proto_bwd_plan` would
    choose; not counted in the wrappers' launches.  For timing the two
    block shapes against each other (`chip_smoke.py` phase 6a)."""
    return _launch_bwd(which, xs, ws, xt, wt, center, teacher_temp,
                       student_temp, lse_s, lse_t, g, groups)


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
    out = _launch_fwd(xs, ws, xt, wt, center, teacher_temp, student_temp)
    proto_ce_fwd.launches += 1
    return out


proto_ce_fwd.launches = 0


def proto_ce_dxs(xs, ws, xt, wt, center, teacher_temp: float,
                 student_temp: float, lse_s, lse_t, g):
    """Gradient of sum_r g_r ce_r with respect to xs: [R, D] f32.

    CPU tensor: the plain version.  CUDA tensor: the kernel or an error."""
    if not _on_device(xs, "prototype CE"):
        return proto_ce_dxs_reference(xs, ws, xt, wt, center, teacher_temp,
                                      student_temp, lse_s, lse_t, g)
    out = _launch_bwd("dxs", xs, ws, xt, wt, center, teacher_temp,
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
    out = _launch_bwd("dws", xs, ws, xt, wt, center, teacher_temp,
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
