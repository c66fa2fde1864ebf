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
W8A8 serving path runs in every frozen qkv / fc1 / fc2 product.  An optional
bias [N] is added after the rounding to x's dtype, as `y + bias.to(y.dtype)`
(`quant.maybe_quantized_dot`'s bias add).

The hand-written CUDA kernel `csrc/int8_matmul.cu` replaces
`pallas_int8_matmul.py:_kernel` and, at `group` = K, `quant.py`'s XLA
`dot_general`: a quantize pass that reads x once, then an int8 `wgmma`
GEMM on TMA tiles (`csrc/gemm_s8_sm90.cuh`) that scales the sums, adds the
bias and stores y by TMA; any M (the TPU kernel needs multiples of its
blocks).  It reads the weight K-major, [N, K]: `quant.QuantizedKernel`
makes that copy once, when a weight is quantized or loaded.  `int8_plan`
decides the GEMM's tile width, stages and grid from the shape alone.

`fused_int8_matmul` is the wrapper: on a CPU tensor it runs the plain
PyTorch version below, on a CUDA tensor it launches the kernel or raises.
Its `launches` counts its kernel launches (one per call, and nothing else).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .cuda_build import check_smem, launch_context, load_library
from .mha import BLOCK_RESERVED, BLOCK_SMEM, SM_SMEM, SMS

SOURCE = "int8_matmul.cu"
DEFAULT_GROUP = 256        # the TPU kernel's default K block

# The GEMM's units (`csrc/gemm_s8_sm90.cuh`): 128-row tiles (two
# warpgroups of 64), stages of 128 bytes of K (a box of codes, 16 KB, and
# one of BN weight rows); 1 KB aligns the base, the tile's weight scales
# and bias take 8 bytes a column, 256 bytes hold the barriers.  The output
# tile is staged in the ring (64 x BN per warpgroup in x's dtype).
BM = 128
BK = 128
GROUPED_WIDTH = 64         # with groups; one group takes 128 or 256
LONG_K = 16 * BK           # from here on 256 columns (one block an SM)
# The quantize pass: threads a block, 16-byte vectors of x a thread holds
# (the kernel's instantiations), and up to how many it also holds its next
# item's
QUANT_THREADS = 256
VECTORS = (4, 8, 16, 32)
PREFETCH_VECTORS = 8
MAX_ROW_TILES = 65535      # the grid's y extent


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """How the GEMM covers y [M, N]: `row_tiles` x `col_tiles` blocks of
    BM x `bn`, each running a ring of `stages` stages over K; `team`
    threads quantize each (row, group) of x, `vectors` 16-byte vectors
    each at most (and with `prefetch` the next item's as well), in
    `quantize_blocks` blocks, or as many as the SMs hold at once where
    that is fewer (`quantize_grid`)."""
    rows: int
    cols: int
    depth: int
    group: int
    bn: int
    stages: int
    row_tiles: int
    col_tiles: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int
    team: int
    vectors: int
    quantize_blocks: int

    @property
    def prefetch(self) -> bool:
        """Whether the quantize pass also holds each thread's next item."""
        return self.vectors <= PREFETCH_VECTORS

    @property
    def grid(self) -> tuple[int, int]:
        return self.col_tiles, self.row_tiles

    def quantize_grid(self, resident: int) -> int:
        """The quantize pass's blocks on a device whose SMs hold
        `resident` of them at once: each warp walks over items a grid
        apart."""
        return min(self.quantize_blocks, resident)

    @property
    def scratch_bytes(self) -> int:
        """The codes [M, K] int8, then the scales [M, K / G] f32 at
        `sx_offset`."""
        return self.sx_offset + 4 * self.rows * (self.depth // self.group)

    @property
    def sx_offset(self) -> int:
        return -(-self.rows * self.depth // 256) * 256

    def describe(self) -> str:
        return (f"{BM} x {self.bn} tiles, {self.row_tiles} x "
                f"{self.col_tiles} = {self.blocks} blocks "
                f"({self.blocks_per_sm} per SM), {self.stages} stages, "
                f"{self.smem_bytes} bytes of shared memory; quantize "
                f"teams of {self.team} threads, up to {self.vectors} "
                f"vectors each{', prefetched' if self.prefetch else ''}")


def stage_bytes(bn: int) -> int:
    return BM * BK + bn * BK


def smem_bytes(bn: int, stages: int) -> int:
    return 1024 + stages * stage_bytes(bn) + 8 * bn + 256


@functools.lru_cache(maxsize=256)
def int8_plan(M: int, N: int, K: int, G: int,
              dtype: torch.dtype = torch.bfloat16) -> Int8Plan:
    """The kernel's launch plan, a pure function of the shape and x's dtype.
    With one group (G = K): 128 x 256 tiles over four stages (one block an
    SM) where K is at least LONG_K, the tiles fill the SMs and pad N no
    further than 128 columns would; else 128 x 128 over three (two blocks
    an SM, so that one block's epilogue overlaps the other's products).
    With groups: 128 x 64 over four (both accumulators in registers; two
    blocks an SM in bf16).  The quantize pass: the fewest vectors a thread (of
    VECTORS) that a team of at most 32 threads covers a group with, and
    the smallest such team, in blocks of QUANT_THREADS that cover every
    item once.  Raises ValueError for a shape the kernel does not take."""
    if M < 1 or N < 8 or K < 32:
        raise ValueError(f"no int8 plan for [{M}, {K}] @ [{K}, {N}]")
    if K % 32 or G % 32 or N % 8 or K % G:
        raise ValueError(f"the int8 kernel takes K and the group in "
                         f"multiples of 32 (the group dividing K) and N in "
                         f"multiples of 8, got K={K}, group={G}, N={N}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the int8 kernel takes bfloat16 or float32 x, "
                         f"got {dtype}")
    es = torch.finfo(dtype).bits // 8
    one = G == K
    rows = -(-M // BM)
    wide = -(-N // 256) * 256 == -(-N // 128) * 128
    bn = (256 if K >= LONG_K and wide and rows * -(-N // 256) >= SMS
          else 128) if one else GROUPED_WIDTH
    stages = 4 if bn != 128 else 3
    if stages * stage_bytes(bn) < 2 * 64 * bn * es:
        raise ValueError(f"{stages} stages cannot hold the {BM} x {bn} "
                         f"output tile")
    smem = smem_bytes(bn, stages)
    if smem > BLOCK_SMEM:
        raise ValueError(f"{stages} stages of {bn} columns need {smem} "
                         f"bytes of shared memory, a block has "
                         f"{BLOCK_SMEM}")
    if rows > MAX_ROW_TILES:
        raise ValueError(f"{M} rows outside the kernel's grid")
    nvec = G * es // 16
    vectors = next((v for v in VECTORS if 32 * v >= nvec), None)
    if vectors is None:
        raise ValueError(f"groups of {G} are too long for the quantize "
                         f"pass (at most {32 * VECTORS[-1] * 16 // es})")
    team = 1
    while team * vectors < nvec:
        team *= 2
    warps = -(-M * (K // G) // (32 // team))
    cols = -(-N // bn)
    # blocks of 288 threads an SM holds by registers (the kernel's launch
    # bounds): two at 128 columns with one group, and with groups in bf16
    per_sm = 2 if (bn == 128 if one else es == 2) else 1
    return Int8Plan(rows=M, cols=N, depth=K, group=G, bn=bn, stages=stages,
                    row_tiles=rows, col_tiles=cols, blocks=rows * cols,
                    smem_bytes=smem,
                    blocks_per_sm=min(per_sm,
                                      SM_SMEM // (smem + BLOCK_RESERVED)),
                    team=team, vectors=vectors,
                    quantize_blocks=-(-warps // (QUANT_THREADS // 32)))


def _check_args(x, w_i8, w_scale, group, bias):
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
    if bias is not None and (tuple(bias.shape) != (N,) or bias.dtype not in (
            torch.bfloat16, torch.float32)):
        raise ValueError(f"bias must be bfloat16 or float32 [{N}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    return K, N


def scale_of(amax):
    """max(amax / 127, 1e-12) in f32, the division IEEE as in JAX and the
    kernel: a Python-number divisor would let PyTorch's CUDA kernel multiply
    by the reciprocal instead, one ulp off for some amax."""
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)


def fused_int8_matmul_reference(x, w_i8, w_scale, group: int = DEFAULT_GROUP,
                                bias=None):
    """Plain version: x [M, K] (bf16 or f32), w_i8 [K, N] int8, w_scale [N]
    f32, bias [N] or None -> [M, N] in x.dtype, rounding where the kernel
    rounds.  The int product is exact: an int32 `matmul` on the CPU,
    float64 on a card (torch has no int32 matmul there; every sum, at most
    127^2 K, stays below 2^53)."""
    K, N = _check_args(x, w_i8, w_scale, group, bias)
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
    y = acc.to(x.dtype)
    return y if bias is None else y + bias.to(y.dtype)


@functools.cache
def _library():
    lib = load_library(SOURCE)
    lib.int8_matmul.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.int8_matmul.restype = ctypes.c_int
    lib.int8_matmul_prepare.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.int8_matmul_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _device_limits(dev: int) -> tuple[int, dict]:
    """Runs `int8_matmul_prepare` (opts the GEMM in to its dynamic shared
    memory) once per device; returns the device's shared-memory limit and
    the quantize blocks its SMs hold at once, by (x dtype, vectors)."""
    dtypes = (torch.bfloat16, torch.float32)
    resident = (ctypes.c_int * (len(dtypes) * len(VECTORS)))()
    with torch.cuda.device(dev):
        have = _library().int8_matmul_prepare(dev, resident)
    if have < 0:
        raise RuntimeError(f"could not set the int8 kernel's shared memory "
                           f"limit on cuda:{dev}")
    keys = [(d, v) for d in dtypes for v in VECTORS]
    return have, dict(zip(keys, resident))


def _aligned(*tensors):
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)


def _launch(x, w_scale, group, w_kmajor, bias, K, N):
    M = x.shape[0]
    plan = int8_plan(max(M, 1), N, K, group, x.dtype)
    if w_kmajor is None or w_kmajor.dtype != torch.int8 \
            or tuple(w_kmajor.shape) != (N, K):
        raise ValueError(f"the int8 kernel needs the weight K-major, int8 "
                         f"[{N}, {K}] (quant.QuantizedKernel.w_kmajor)")
    for name, t in (("w_kmajor", w_kmajor), ("w_scale", w_scale),
                    ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"x on {x.device}, {name} on {t.device}")
    if not _aligned(x, w_kmajor, w_scale) or not (
            bias is None or bias.is_contiguous()):
        raise ValueError("x, w_kmajor, w_scale and the bias must be "
                         "contiguous, the first three 16-byte aligned")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    lib = _library()
    smem, resident = _device_limits(x.device.index)
    check_smem(plan.smem_bytes, smem, "the int8 GEMM")
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    base = scratch.data_ptr()
    with launch_context(x) as stream:
        err = lib.int8_matmul(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            w_kmajor.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == torch.bfloat16),
            base, base + plan.sx_offset, y.data_ptr(), M, N, K, group,
            plan.bn, plan.stages, plan.smem_bytes, plan.team, plan.vectors,
            plan.quantize_grid(resident[x.dtype, plan.vectors]), stream)
    if err >= 2000:
        raise RuntimeError(f"int8_matmul: no kernel for the plan "
                           f"({plan.describe()})")
    if err >= 1000:
        raise RuntimeError(f"int8_matmul: tensor map not encoded: "
                           f"CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
    fused_int8_matmul.launches += 1
    return y


def fused_int8_matmul(x, w_i8, w_scale, group: int = DEFAULT_GROUP,
                      w_kmajor=None, bias=None):
    """x [M, K] bf16/f32 @ (w_i8 [K, N] int8, w_scale [N] f32) -> [M, N] in
    x.dtype, with one activation scale per (row, `group` of K); with `bias`
    [N] (f32 or bf16), + bias rounded to x.dtype, after the rounding.

    CPU tensor: the plain version.  CUDA tensor: the kernel, which reads
    `w_kmajor` ([N, K], w_i8 transposed and made contiguous once by the
    caller), or an error naming why it cannot run."""
    K, N = _check_args(x, w_i8, w_scale, group, bias)
    if x.device.type == "cpu":
        return fused_int8_matmul_reference(x, w_i8, w_scale, group, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {x.device}")
    return _launch(x, w_scale, group, w_kmajor, bias, K, N)


fused_int8_matmul.launches = 0
