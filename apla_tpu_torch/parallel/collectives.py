"""Collectives on the mesh's process groups.

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
  GSPMD's model-axis          reduce_from_model, scatter_tokens,
  collectives                 split_tokens, gather_trunk (autograd
                              operators below); gather_dim1 and
                              reduce_scatter_dim1, which
                              `parallel.tensor`'s column products call
  ppermute over 'model'       stage_send / stage_recv (point to point
  (the pipeline)              between neighbouring stages of the model
                              group)
  psum of the last stage's    stage_broadcast (from the last stage to
  outputs (the pipeline)      the model group; `parallel.pipeline`'s
                              backward keeps the last stage's cotangent)

The groups.  `parallel.mesh.make_mesh(n_data, n_model)` records the mesh
here (`set_axes`): global rank r is data index r // T and model index
r % T, so a model group is T consecutive ranks and a data group the D
ranks of one model index.  Every collective takes `group=`; its default is
named by the collective's kind:

- over samples (psum, pmean, all_gather, mesh_average, mesh_all_gather,
  psum_grad, loss_normaliser, gather_rows, and the data average of
  `reduce_gradients`): DATA, the rank's data group.  The T ranks of a model
  group hold the same rows, so a reduction over the world would count each
  sample T times (BatchNorm statistics, KoLeo neighbours, the DINO
  centers, the eval gathers);
- over heads or tokens (the operators, and the model-axis sum of
  `reduce_gradients`): MODEL, the rank's model group;
- host_allgather, broadcast_object, any_rank, synchronize: the world.

Without a model axis DATA is the world and MODEL is empty (size 1), so
data-parallel runs issue what they issued before.

The two kinds of gather along the tokens, which sequence parallelism
needs both of, and which must not be confused:

- the gather before qkv and fc1 (`parallel.tensor`'s column products,
  through `gather_dim1`): its consumer is a column-parallel product,
  whose cotangent on each rank is the rank's share (its heads' or
  hidden columns' part of dx).  Backward is a reduce-scatter
  (`reduce_scatter_dim1`): the shares summed over the model group, the
  rank's tokens kept.
- `gather_trunk` (the end of the trunk): its consumers (the final norm,
  the cls token, the heads and the loss) run replicated on every rank of
  the model group, so each rank's cotangent is already the whole one.
  Backward keeps the rank's own slice and does NOT sum: a reduce-scatter
  there would multiply the trunk's gradient by T.

Every function is the identity (rank 0, world 1) when no group is
initialised, so the one-device paths run no collective at all; in a group
of one rank the collectives run (a sum over one rank and a division by 1
change no bit).

Under NCCL every collective runs on the device.  Under gloo,
`torch.distributed` takes CUDA tensors for `all_reduce` and `broadcast`
only (its backend table), so every other collective here copies a CUDA
tensor to host memory, runs there and copies the result back; gloo has no
reduce-scatter, so `scatter_tokens` there is an all-reduce and a slice.
That is the design for gloo (ranks sharing one card, where NCCL refuses),
decided from the backend, and printed once per kind.

Point to point (the pipeline's): gloo sends and receives host tensors
only, so a CUDA tensor is copied to host memory for its send and a
received one copied back; under NCCL they stay on the card.  Half
precision tensors travel as their bytes.  Every message of a
pipelined trunk call carries the same tag (`PIPE_TAG`): messages between
two ranks arrive in the order they were sent, and every rank sends and
receives in the same order (`parallel.pipeline`).

`COUNTS` holds the bytes passed to each collective, by kind:
"gradients" (the once-per-update data-axis reduction of the trainable
gradients), "model_gradients" (its model-axis sum), "model" (the
operators' activations and cotangents), "pipeline" (what a stage sends
and receives, and the broadcast of the trunk's output), "all_reduce"
and "all_gather" (FSDP's gathers among them).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()
_STAGED_SHOWN: set = set()


@dataclasses.dataclass(frozen=True)
class Axes:
    """The mesh's model-axis size T and the rank's two groups: None for
    DATA means the world (no model axis), None for MODEL no group."""
    n_model: int = 1
    data_group: object = None
    model_group: object = None


_AXES = Axes()


def set_axes(axes: Axes) -> None:
    """Record the mesh (`parallel.mesh.make_mesh` calls it)."""
    global _AXES
    _AXES = axes


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def model_size() -> int:
    """T, the ranks of a model group (1 without a model axis)."""
    return _AXES.n_model if initialized() else 1


def data_size() -> int:
    """D, the ranks on the data axis: the global batch's shares."""
    return world_size() // model_size()


def data_rank() -> int:
    """This rank's index on the data axis (its share of the batch)."""
    return rank() // model_size()


def model_rank() -> int:
    return rank() % model_size()


# the default groups, by name
DATA, MODEL = "data", "model"


def _resolve(group):
    """(process group or None for the world, its size, this rank in it)."""
    if group == DATA and _AXES.data_group is not None:
        return _AXES.data_group, data_size(), data_rank()
    if group == MODEL:
        return _AXES.model_group, model_size(), model_rank()
    if group in (None, DATA):
        return None, world_size(), rank()
    return group, dist.get_world_size(group), dist.get_rank(group)


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


def _idle(group, g, n: int) -> bool:
    """True when a collective over `group` has nothing to do: a group of
    one rank, or MODEL without a model axis (never the world's stand-in
    for it); a world of one rank still runs it."""
    return n == 1 and (g is not None or group == MODEL)


def all_reduce_(t: torch.Tensor, kind: str = "all_reduce",
                 group=DATA) -> torch.Tensor:
    g, n, _ = _resolve(group)
    if not _idle(group, g, n):
        _count(kind, t)
        dist.all_reduce(t, group=g)
    return t


def psum(x: torch.Tensor, group=DATA) -> torch.Tensor:
    """Sum over the group's ranks (a new tensor)."""
    if not initialized():
        return x
    return all_reduce_(x.detach().clone(), group=group)


def pmean(x: torch.Tensor, group=DATA) -> torch.Tensor:
    if not initialized():
        return x
    return psum(x, group) / _resolve(group)[1]


def all_gather(x: torch.Tensor, group=DATA,
               kind: str = "all_gather") -> torch.Tensor:
    """The group's tensors stacked on dim 0 in rank order ([n * rows,
    ...]); every rank's `x` has the same shape."""
    if not initialized():
        return x
    g, n, _ = _resolve(group)
    x = x.detach().contiguous()
    if _idle(group, g, n):
        return x
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    _count(kind, x)
    if _staged(kind, x):
        src = x.cpu()
    elif not x.is_cuda and dist.get_backend() == "nccl":
        src = x.cuda()             # NCCL takes device tensors only
    else:
        src = x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=g)
    out = torch.cat(parts, dim=0).to(x.device)
    return out.bool() if is_bool else out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x; dx = sum over the group of dy (every
    rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.contiguous().clone(), group=ctx.group), None


def psum_grad(x: torch.Tensor, group=DATA) -> torch.Tensor:
    """`psum` that gradients flow through (BatchNorm's global batch
    statistics)."""
    if not initialized():
        return x
    return _AllReduceSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather whose backward returns this rank's rows of the
    cotangent summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.group = x.shape[0], group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, dy):
        dy = all_reduce_(dy.contiguous().clone(), group=ctx.group)
        r, n = _resolve(ctx.group)[2], ctx.rows
        return dy[r * n:(r + 1) * n], None


def mesh_all_gather(x: torch.Tensor, group=DATA) -> torch.Tensor:
    """The global batch of a rank-sharded tensor, in global order, with a
    gradient (the reference's `dist_gather_tensor`)."""
    if not initialized():
        return x
    return _AllGather.apply(x, group)


def mesh_average(x: torch.Tensor, keepdim: bool = False,
                 group=DATA) -> torch.Tensor:
    """The mean of the global batch's rows of a rank-sharded tensor (equal
    rows on every rank), the same on every rank; no gradient reaches the
    other ranks."""
    return pmean(x.mean(dim=0, keepdim=keepdim), group)


def loss_normaliser(n: torch.Tensor, group=DATA) -> torch.Tensor:
    """The divisor that makes a rank's `local_sum / divisor`, averaged over
    the group, equal the global `sum / max(count, 1)`: max(psum(n), 1) /
    D.  With one rank, max(n, 1)."""
    n = n.detach().float()
    if not initialized():
        return n.clamp(min=1.0)
    return psum(n, group).clamp(min=1.0) / _resolve(group)[1]


# --------------------------------------------------------------------------- #
# the model axis: tensor and sequence parallelism's operators
# --------------------------------------------------------------------------- #

def token_split(n: int, parts: int) -> list:
    """[(start, length)] of each model rank's tokens of a length-n stream:
    contiguous, the first n % parts ranks one token longer."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        length = base + (i < extra)
        out.append((start, length))
        start += length
    return out


def own_tokens(n: int) -> tuple:
    """(start, length) of this rank's tokens of a length-n stream."""
    return token_split(n, model_size())[model_rank()]


def gather_dim1(x: torch.Tensor, n: int) -> torch.Tensor:
    """The model group's token shards of x [B, n_r, ...] (uneven, as
    `token_split(n, T)`) gathered along dim 1 into [B, n, ...]: each shard
    padded to the longest, gathered, the padding dropped."""
    T = model_size()
    split = token_split(n, T)
    longest = split[0][1]
    xt = x.transpose(0, 1)                       # [n_r, B, ...]
    if xt.shape[0] < longest:
        pad = xt.new_zeros((longest - xt.shape[0],) + xt.shape[1:])
        xt = torch.cat([xt, pad])
    parts = all_gather(xt, MODEL, "model").reshape(
        (T, longest) + xt.shape[1:])
    full = torch.cat([parts[i, :length] for i, (_, length)
                      in enumerate(split)])
    return full.transpose(0, 1).contiguous()


def reduce_scatter_dim1(x: torch.Tensor) -> torch.Tensor:
    """x [B, n, ...] summed over the model group, this rank's tokens kept:
    NCCL's reduce-scatter; under gloo (which has none) an all-reduce and a
    slice."""
    n = x.shape[1]
    start, length = own_tokens(n)
    if dist.get_backend() != "nccl":
        full = all_reduce_(x.contiguous().clone(), "model", MODEL)
        return full[:, start:start + length].contiguous()
    T = model_size()
    split = token_split(n, T)
    longest = split[0][1]
    xt = x.transpose(0, 1)                       # [n, B, ...]
    chunks = []
    for s, ln in split:
        c = xt[s:s + ln]
        if ln < longest:
            c = torch.cat([c, c.new_zeros((longest - ln,) + c.shape[1:])])
        chunks.append(c)
    src = torch.cat(chunks).contiguous()
    out = src.new_empty((longest,) + xt.shape[1:])
    _count("model", src)
    dist.reduce_scatter_tensor(out, src, group=_AXES.model_group)
    return out[:length].transpose(0, 1).contiguous()


class _ReduceFromModel(torch.autograd.Function):
    """After a row-parallel product: the partial products summed over the
    model group (in the input's dtype: the callers pass f32); identity
    backward."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.contiguous().clone(), "model", MODEL)

    @staticmethod
    def backward(ctx, dy):
        return dy


class _ScatterTokens(torch.autograd.Function):
    """After a row-parallel product: the partials summed over the model
    group, own tokens kept (a reduce-scatter); backward: the token
    shards' cotangents gathered into the whole stream."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[1]
        return reduce_scatter_dim1(x)

    @staticmethod
    def backward(ctx, dy):
        return gather_dim1(dy, ctx.n)


class _SplitTokens(torch.autograd.Function):
    """The whole stream (the same on every rank) -> this rank's tokens;
    backward gathers the shards' cotangents, so what made the stream
    (token prep, replicated) gets the whole cotangent on every rank."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[1]
        start, length = own_tokens(ctx.n)
        return x[:, start:start + length].contiguous()

    @staticmethod
    def backward(ctx, dy):
        return gather_dim1(dy, ctx.n)


class _GatherTrunk(torch.autograd.Function):
    """Token shards -> the whole stream at the end of the trunk, whose
    consumers run replicated; backward keeps the rank's own slice of the
    cotangent and does not sum it."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return gather_dim1(x, n)

    @staticmethod
    def backward(ctx, dy):
        start, length = own_tokens(ctx.n)
        return dy[:, start:start + length].contiguous(), None


def reduce_from_model(x):
    return _ReduceFromModel.apply(x) if model_size() > 1 else x


def scatter_tokens(x):
    return _ScatterTokens.apply(x) if model_size() > 1 else x


def split_tokens(x):
    return _SplitTokens.apply(x) if model_size() > 1 else x


def gather_trunk(x, n: int):
    return _GatherTrunk.apply(x, int(n)) if model_size() > 1 else x


# --------------------------------------------------------------------------- #
# the model axis: the pipeline's stages
# --------------------------------------------------------------------------- #

PIPE_TAG = 24


def _stage_rank(stage: int) -> int:
    """The global rank of `stage` in this rank's model group."""
    return data_rank() * model_size() + int(stage)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A half-precision tensor as its bytes (a view: gloo has no int16,
    and not every build's gloo takes bfloat16)."""
    return t.view(torch.uint8) if t.dtype in (torch.bfloat16,
                                              torch.float16) else t


def _wire_device(device) -> torch.device:
    """Where the backend sends and receives: host memory under gloo, the
    tensor's card under NCCL."""
    return torch.device("cpu") if dist.get_backend() == "gloo" \
        else torch.device(device)


class _Sent:
    """A send in flight: the work and the tensor it reads, kept alive
    until `wait`."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def stage_send(t: torch.Tensor, stage: int) -> _Sent:
    """Send `t` to `stage` of this rank's model group without waiting
    for it to be received; `.wait()` the result before the step ends."""
    t = t.detach().contiguous()
    _count("pipeline", t)
    buf = _bits(t.to(_wire_device(t.device)))
    work = dist.isend(buf, dst=_stage_rank(stage), group=_AXES.model_group,
                      tag=PIPE_TAG)
    return _Sent(work, buf)


def stage_recv(shape, dtype, device, stage: int) -> torch.Tensor:
    """The next tensor (`shape`, `dtype`) that `stage` of this rank's
    model group sent here, on `device`."""
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device=_wire_device(device))
    dist.recv(_bits(buf), src=_stage_rank(stage), group=_AXES.model_group,
              tag=PIPE_TAG)
    _count("pipeline", buf)
    return buf.to(device)


def stage_broadcast(t: torch.Tensor, stage: int) -> torch.Tensor:
    """`stage`'s `t` on every rank of the model group, in place (gloo
    takes CUDA tensors for broadcast)."""
    _count("pipeline", t)
    dist.broadcast(_bits(t), src=_stage_rank(stage), group=_AXES.model_group)
    return t


def gather_objects(obj, group=MODEL) -> list:
    """Every rank's picklable `obj` over `group`, in rank order."""
    if not initialized():
        return [obj]
    g, n, _ = _resolve(group)
    if _idle(group, g, n):
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=g)
    return out


# --------------------------------------------------------------------------- #
# the gradients
# --------------------------------------------------------------------------- #

def _flat_reduce(grads, kind, group, divide) -> None:
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group_grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group_grads])
        all_reduce_(flat, kind, group)
        if divide != 1:
            flat.div_(divide)
        off = 0
        for g in group_grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


# a trainable tensor's model-axis rule (`parallel.mesh.tp_plan` and
# `pp_plan` set it on the parameter as `model_grad`): "sum" where the
# rank's use was a share (or, in a pipeline, where only some stages' use
# reaches it); "stage" where the tensor is a pipeline stage's own, held by
# that stage alone: never reduced over the model group, its norms summed
# over it; anything else ("keep") where every rank computed the same
MODEL_SUM, MODEL_STAGE = "sum", "stage"


def is_stage_owned(p) -> bool:
    return getattr(p, "model_grad", None) == MODEL_STAGE


@torch.no_grad()
def reduce_gradients(params) -> None:
    """The `.grad` of `params` reduced in place, once per update after
    accumulation and before the clip: first summed over the model group
    where the parameter's `model_grad` rule is "sum" (the rank used a
    slice of it, or applied it to its token shard; a rank whose use did
    not reach it adds zeros), then averaged over the data group (one
    all-reduce of the flattened gradients a dtype, then / D)."""
    if not initialized():
        return
    if model_size() > 1:
        for p in params:
            if p.grad is None and getattr(p, "model_grad", None) == \
                    MODEL_SUM:
                p.grad = torch.zeros_like(p)
        shares = [p.grad for p in params if p.grad is not None
                  and getattr(p, "model_grad", None) == MODEL_SUM]
        if shares:
            _flat_reduce(shares, "model_gradients", MODEL, 1)
    grads = [p.grad for p in params if p.grad is not None]
    g, n, _ = _resolve(DATA)
    if not _idle(DATA, g, n):
        _flat_reduce(grads, "gradients", DATA, n)


def any_rank(flag: bool, device) -> bool:
    """True on every rank when `flag` is true on any (a preemption signal
    stops every rank at the same step boundary)."""
    if not initialized():
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(psum(t, None).item() > 0)


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


def gather_rows(valid, *tensors, group=DATA):
    """The global batch of per-row outputs: each of `tensors` [n, ...]
    (this rank's rows) gathered in global order over the data group,
    keeping the rows whose gathered `valid` [n] is true (the padding of an
    uneven last batch goes).  With one rank, the rows where `valid` is
    true."""
    valid = torch.as_tensor(valid, dtype=torch.bool)
    keep = all_gather(valid, group)
    out = []
    for t in tensors:
        t = torch.as_tensor(t)
        g = all_gather(t, group)
        out.append(g[keep.to(g.device)])
    return out if len(out) != 1 else out[0]
