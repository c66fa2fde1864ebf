"""The data axis, FSDP placement of the frozen backbone, and the rank's rows
of a batch.

Counterpart of `apla_tpu/parallel/mesh.py`'s data-parallel half.  JAX
builds one `Mesh` over every device; here each rank is a process and
`make_mesh` is a record of the default group: world size, rank, device,
backend.  The model axis (tensor and pipeline parallelism) is ROADMAP
A 9's second half.

- `shard_params(model, mesh, "replicated" | "fsdp")`: the trainable tensors
  stay whole on every rank; under "fsdp" each large frozen parameter keeps
  only this rank's slice (`fsdp_plan`, JAX's `fsdp_sharding_tree` rule).
  `gathered(module)` puts the whole tensors back for the span of a forward
  (a ViT or Swin block, the patch embedding) and drops the module's
  reference after it: what an op saved for its backward (the frozen
  projection that row 2's dO = g W^T reads) lives until that backward,
  as the replicated run's does.
- `rank_rows(n, mesh, accum)`: the positions of the global batch this
  rank holds.  JAX's micro-batch i is rows [i B/accum, (i+1) B/accum) of
  the global batch, sharded over the data axis, so the rank's micro-batch
  i is its W-th share of those rows.
- `rand_rows`: a random draw for the rank's rows, drawn for the global
  batch and sliced, so every rank's generator moves alike and the rank
  gets the 1-device run's values (JAX's draws under sharding are the
  unsharded ones).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np
import torch
from torch import nn

from . import collectives

ROADMAP_A9 = ("ROADMAP A 9, second half: tensor, sequence and pipeline "
              "parallelism")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis as one rank sees it."""
    world: int = 1
    rank: int = 0
    backend: str | None = None

    @property
    def shape(self) -> dict:
        return {"data": self.world}

    @property
    def distributed(self) -> bool:
        return self.world > 1


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The default group as a data axis.  `n_data` None: the group's size
    (one device without a group); a size that differs from the group's,
    or > 1 without a group, raises: a run never shrinks to one process
    quietly."""
    if int(n_model or 1) != 1:
        raise NotImplementedError(f"a model axis of {n_model} ({ROADMAP_A9})")
    world = collectives.world_size()
    if n_data is not None and int(n_data) != world:
        if not collectives.initialized():
            raise RuntimeError(
                f"n_devices={n_data} asked for, but this process is not a "
                "rank of a process group: start it through "
                "apla_tpu_torch.parallel.launch (the CLIs do) or torchrun")
        raise ValueError(f"n_devices={n_data}, but the process group has "
                         f"{world} ranks")
    backend = torch.distributed.get_backend() \
        if collectives.initialized() else None
    return Mesh(world=world, rank=collectives.rank(), backend=backend)


# --------------------------------------------------------------------------- #
# the rank's rows
# --------------------------------------------------------------------------- #

def rank_rows(n: int, mesh: Mesh, accum: int = 1) -> np.ndarray:
    """Positions in a global batch of `n` rows (a multiple of W * accum)
    that this rank holds, micro-batch by micro-batch."""
    w, r = mesh.world, mesh.rank
    if n % (accum * w):
        raise ValueError(f"a batch of {n} rows does not split into "
                         f"{accum} micro-batches over {w} ranks")
    mb, share = n // accum, n // (accum * w)
    return np.concatenate([np.arange(i * mb + r * share,
                                     i * mb + (r + 1) * share)
                           for i in range(accum)])


def padded_rows(n: int, multiple: int) -> int:
    return n + (-n) % multiple


def shard_batch(batch, mesh: Mesh, accum: int = 1):
    """This rank's rows of a global batch (a dict of tensors or arrays with
    the batch on dim 0, a multiple of W * accum rows)."""
    if mesh.world == 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    idx = rank_rows(n, mesh, accum)
    return {k: v[torch.as_tensor(idx)] if isinstance(v, torch.Tensor)
            else v[idx] for k, v in batch.items()}


def pad_to_multiple(batch, multiple: int):
    """Pad the leading dim of every array (numpy or torch) to a multiple,
    repeating the last row (edge mode); returns (padded, true count)."""
    n = next(iter(batch.values())).shape[0]
    rem = (-n) % multiple

    def pad(x):
        if rem == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand((rem,) + x.shape[1:])])
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)])

    return {k: pad(v) for k, v in batch.items()}, n


_ROWS: tuple | None = None      # (world, rank, micro-batch rows a rank)


@contextlib.contextmanager
def batch_rows(rows: int):
    """Within the block, `rand_rows` draws for `rows` rows a rank per
    micro-batch (a data-parallel step's); nothing changes with one rank."""
    global _ROWS
    saved = _ROWS
    w = collectives.world_size()
    _ROWS = (w, collectives.rank(), int(rows)) if w > 1 else None
    try:
        yield
    finally:
        _ROWS = saved


def rand_rows(shape, generator, device) -> torch.Tensor:
    """`torch.rand(shape)` for this rank's rows.  Inside `batch_rows(m)`
    with W > 1 and a leading dim of k * m (k micro-batches or stacked
    crops of m rows each), the draw is [k, W, m, ...] (the 1-device run's
    [k * W * m, ...]) and the rank takes [:, rank]."""
    shape = tuple(shape)
    kw = dict(generator=generator, device=device)
    if _ROWS is None or not shape or shape[0] % _ROWS[2]:
        return torch.rand(shape, **kw)
    w, r, m = _ROWS
    k = shape[0] // m
    full = torch.rand((k, w, m) + shape[1:], **kw)
    return full[:, r].reshape(shape)


# --------------------------------------------------------------------------- #
# FSDP of the frozen parameters
# --------------------------------------------------------------------------- #

def fsdp_dim(shape, n: int, min_size: int = 2 ** 16):
    """JAX's `fsdp_sharding_tree` rule for one leaf of `shape`: the
    largest dim (trailing on ties) that `n` divides, never dim 0 (the
    stacked depth axis); None (replicated) for a leaf under `min_size`
    elements, without such a dim, or with n == 1."""
    shape = tuple(int(s) for s in shape)
    if n == 1 or int(np.prod(shape)) < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: (shape[i], i),
                    reverse=True):
        if i > 0 and shape[i] % n == 0:
            return i
    return None


def _stacked_blocks(model: nn.Module) -> dict:
    """{prefix of a ViT's `blocks.`: depth}: the leaves JAX stacks [L, ...]
    (`utils.pretrained._split_blocks` maps them to `blocks.{i}.*`)."""
    from ..models.vit import ViT
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ViT):
            out[(name + "." if name else "") + "blocks."] = len(m.blocks)
    return out


def fsdp_plan(model: nn.Module, n: int, min_size: int = 2 ** 16) -> dict:
    """{frozen parameter name: port dim it is sharded on} by JAX's rule on
    the leaf JAX holds: a ViT block's tensor is decided as the stacked
    [L, ...] leaf, and JAX dim d is the port's dim d - 1; every other
    tensor (the Swin's blocks are a list in JAX too) as it is."""
    stacked = _stacked_blocks(model)
    plan = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            continue
        depth = next((L for pre, L in stacked.items()
                      if name.startswith(pre)
                      and re.match(r"\d+\.", name[len(pre):])), None)
        if depth is not None:
            d = fsdp_dim((depth,) + tuple(p.shape), n, min_size)
            d = None if d is None else d - 1
        else:
            d = fsdp_dim(p.shape, n, min_size)
        if d is not None:
            plan[name] = d
    return plan


def _owner(model: nn.Module, name: str):
    mod_name, _, attr = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), attr


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh, policy: str = "replicated",
                 min_size: int = 2 ** 16) -> dict:
    """Place `model`'s frozen parameters by `policy`: "replicated" leaves
    them whole; "fsdp" keeps this rank's slice of each tensor of
    `fsdp_plan` (the slice's own storage: the whole tensor is freed).
    Returns the plan (name -> dim)."""
    if policy in ("tp", "pp"):
        raise NotImplementedError(f"param_sharding {policy!r} ({ROADMAP_A9})")
    if policy not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_sharding policy: {policy!r}")
    if policy == "replicated" or mesh.world == 1:
        return {}
    plan = fsdp_plan(model, mesh.world, min_size)
    for name, dim in plan.items():
        owner, attr = _owner(model, name)
        p = getattr(owner, attr)
        full_shape = tuple(p.shape)
        p.data = p.data.chunk(mesh.world, dim=dim)[mesh.rank].clone()
        shards = owner.__dict__.setdefault("_fsdp_shards", {})
        shards[attr] = (dim, full_shape)
    return plan


def is_sharded(model: nn.Module) -> bool:
    return any(getattr(m, "_fsdp_shards", None) for m in model.modules())


def _gather_dim(shard: torch.Tensor, dim: int) -> torch.Tensor:
    x = shard.movedim(dim, 0).contiguous()
    return collectives.all_gather(x).movedim(0, dim).contiguous()


def _sharded_in(module: nn.Module, exclude=()):
    skip = set()
    for m in exclude:
        skip.update(id(s) for s in m.modules())
    for m in module.modules():
        if id(m) in skip:
            continue
        for attr, (dim, _) in (getattr(m, "_fsdp_shards", None)
                               or {}).items():
            yield m, attr, dim


@contextlib.contextmanager
def gathered(module: nn.Module, exclude=()):
    """The sharded frozen parameters under `module` (but not under the
    modules of `exclude`) whole for the block: each is all-gathered into a
    new tensor that the module holds until the block ends.  A no-op for an
    unsharded module."""
    items = list(_sharded_in(module, exclude))
    if not items:
        yield
        return
    saved = []
    for m, attr, dim in items:
        shard = getattr(m, attr)
        saved.append((m, attr, shard))
        setattr(m, attr, nn.Parameter(_gather_dim(shard.detach(), dim),
                                      requires_grad=False))
    try:
        yield
    finally:
        for m, attr, shard in saved:
            setattr(m, attr, shard)


def whole_state(model: nn.Module, state: dict) -> dict:
    """`state` (name -> tensor of `model`) with each tensor that `model`
    holds sharded gathered whole; every rank must call it."""
    if not is_sharded(model):
        return state
    out = {}
    for name, t in state.items():
        owner, attr = _owner(model, name)
        info = (getattr(owner, "_fsdp_shards", None) or {}).get(attr)
        out[name] = _gather_dim(t.detach(), info[0]) if info else t
    return out


def local_state(model: nn.Module, state: dict) -> dict:
    """`state` (name -> whole tensor) with the tensors that `model` holds
    sharded cut to this rank's slice, so that it loads into the placed
    model (`load_session` re-applies the placement)."""
    if not is_sharded(model):
        return state
    w, r = collectives.world_size(), collectives.rank()
    out = dict(state)
    for name, t in state.items():
        mod_name, _, attr = name.rpartition(".")
        try:
            owner = model.get_submodule(mod_name) if mod_name else model
        except AttributeError:
            continue
        info = (getattr(owner, "_fsdp_shards", None) or {}).get(attr)
        if info and tuple(t.shape) == info[1]:
            out[name] = t.chunk(w, dim=info[0])[r].clone()
    return out


def resident_bytes(model: nn.Module, frozen_only: bool = True) -> int:
    """Bytes of the (frozen) parameters this rank holds."""
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if not (frozen_only and p.requires_grad))
