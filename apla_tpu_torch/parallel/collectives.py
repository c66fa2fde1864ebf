"""Collectives on the default process group.

Counterpart of `apla_tpu/parallel/collectives.py`.  JAX drives its mesh
from one process and XLA inserts the collectives; the port runs one
process per rank (`parallel.launch`) and issues them itself:

  JAX                         here
  ---                         ----
  psum / pmean                psum / pmean (a new tensor; `psum_grad`:
                              the same with a gradient, summed again in
                              backward)
  all_gather (tiled)          all_gather (dim 0, rank-major)
  mesh_average                mesh_average (mean of the rows, over ranks)
  mesh_all_gather             mesh_all_gather (with a gradient: backward
                              returns the rank's slice of the summed
                              cotangent; KoLeo reads it)
  host_allgather              host_allgather (a list, one item a rank)
  synchronize                 synchronize (a barrier)
  is_rank0 / print_once       is_rank0 / print_once
  XLA's gradient psum         reduce_gradients (one flat all-reduce of the
                              trainable gradients per update)

Every function is the identity (rank 0, world 1) when no group is
initialised, so the one-device paths run no collective at all; in a group
of one rank the collectives run (a sum over one rank and a division by 1
change no bit).

Under NCCL every collective runs on the device.  Under gloo,
`torch.distributed` takes CUDA tensors for `all_reduce` and `broadcast`
only (its backend table), so every other collective here copies a CUDA
tensor to host memory, runs there and copies the result back.  That is
the design for gloo (two ranks sharing one card, where NCCL refuses),
decided from the backend, and printed once per kind.

`COUNTS` holds the bytes passed to each collective, by kind:
"gradients" (the once-per-update reduction of the trainable gradients),
"all_reduce" and "all_gather" (FSDP's gathers among them).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()
_STAGED_SHOWN: set = set()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_rank0() -> bool:
    return rank() == 0


def print_once(*args, **kwargs):
    if is_rank0():
        print(*args, **kwargs)


def reset_counts() -> None:
    COUNTS.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind] += t.numel() * t.element_size()


def _staged(kind: str, t: torch.Tensor) -> bool:
    """True when `t` must pass through host memory for `kind`: a CUDA
    tensor under gloo, for anything but all_reduce and broadcast."""
    if not (t.is_cuda and dist.get_backend() == "gloo"):
        return False
    if kind not in _STAGED_SHOWN:
        _STAGED_SHOWN.add(kind)
        print_once(f"gloo: {kind} of CUDA tensors staged through host "
                   "memory (gloo takes CUDA tensors for all_reduce and "
                   "broadcast only)")
    return True


def _all_reduce_(t: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    _count(kind, t)
    dist.all_reduce(t)
    return t


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ranks (a new tensor)."""
    if not initialized():
        return x
    return _all_reduce_(x.detach().clone())


def pmean(x: torch.Tensor) -> torch.Tensor:
    if not initialized():
        return x
    return psum(x) / world_size()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors stacked on dim 0 in rank order ([W * n, ...]);
    every rank's `x` has the same shape."""
    if not initialized():
        return x
    n = world_size()
    x = x.detach().contiguous()
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    _count("all_gather", x)
    if _staged("all_gather", x):
        src = x.cpu()
    elif not x.is_cuda and dist.get_backend() == "nccl":
        src = x.cuda()             # NCCL takes device tensors only
    else:
        src = x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src)
    out = torch.cat(parts, dim=0).to(x.device)
    return out.bool() if is_bool else out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy (every rank's
    loss reads y)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.contiguous().clone())


def psum_grad(x: torch.Tensor) -> torch.Tensor:
    """`psum` that gradients flow through (BatchNorm's global batch
    statistics)."""
    if not initialized():
        return x
    return _AllReduceSum.apply(x)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather whose backward returns this rank's rows of the
    cotangent summed over ranks."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather(x)

    @staticmethod
    def backward(ctx, dy):
        dy = _all_reduce_(dy.contiguous().clone())
        r, n = rank(), ctx.rows
        return dy[r * n:(r + 1) * n]


def mesh_all_gather(x: torch.Tensor) -> torch.Tensor:
    """The global batch of a rank-sharded tensor, in global order, with a
    gradient (the reference's `dist_gather_tensor`)."""
    if not initialized():
        return x
    return _AllGather.apply(x)


def mesh_average(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean of the global batch's rows of a rank-sharded tensor (equal
    rows on every rank), the same on every rank; no gradient reaches the
    other ranks."""
    return pmean(x.mean(dim=0, keepdim=keepdim))


def loss_normaliser(n: torch.Tensor) -> torch.Tensor:
    """The divisor that makes a rank's `local_sum / divisor`, averaged over
    ranks, equal the global `sum / max(count, 1)`: max(psum(n), 1) / W.
    With one rank, max(n, 1)."""
    n = n.detach().float()
    if not initialized():
        return n.clamp(min=1.0)
    return psum(n).clamp(min=1.0) / world_size()


@torch.no_grad()
def reduce_gradients(params) -> None:
    """Average the `.grad` of `params` over ranks in place: one all-reduce
    of the flattened gradients (a buffer a dtype), then / W.  Call once
    per update, after accumulation and before the clip."""
    if not initialized():
        return
    n = world_size()
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        _all_reduce_(flat, "gradients")
        flat.div_(n)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def any_rank(flag: bool, device) -> bool:
    """True on every rank when `flag` is true on any (a preemption signal
    stops every rank at the same step boundary)."""
    if not initialized():
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(psum(t).item() > 0)


def host_allgather(obj):
    """Every rank's `obj`, as a list in rank order; `obj` itself without a
    group (the reference's Gloo-group CPU gather)."""
    if not initialized():
        return obj
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def synchronize() -> None:
    """Barrier over every rank (the reference's `synchronize`)."""
    if initialized():
        dist.barrier()


def gather_rows(valid, *tensors):
    """The global batch of per-row outputs: each of `tensors` [n, ...]
    (this rank's rows) gathered in global order, keeping the rows whose
    gathered `valid` [n] is true (the padding of an uneven last batch
    goes).  With one rank, the rows where `valid` is true."""
    valid = torch.as_tensor(valid, dtype=torch.bool)
    keep = all_gather(valid)
    out = []
    for t in tensors:
        t = torch.as_tensor(t)
        g = all_gather(t)
        out.append(g[keep.to(g.device)])
    return out if len(out) != 1 else out[0]
