"""The (data x model) mesh, the placement of the parameters on it, and the
rank's rows of a batch.

Counterpart of `apla_tpu/parallel/mesh.py`.  JAX builds one `Mesh` over
every device, `devices.reshape(n_data, n_model)` with axes ("data",
"model"); here each rank is a process and `make_mesh(n_data, n_model)`
records its place: global rank r is data index r // T and model index
r % T (a model group is T consecutive ranks, on one node the NVLink
neighbours), and the two sets of groups are made with `dist.new_group`
(`collectives.set_axes`).  A pipeline's stages are the model axis too:
stage s is model index s.

- `shard_params(model, mesh, "replicated" | "fsdp" | "tp" | "pp")`: the
  trainable tensors stay whole on every rank; under "fsdp" each large
  frozen tensor (W8A8's int8 buffers among them) keeps only this rank's
  slice over the data group (`fsdp_plan`, JAX's `fsdp_sharding_tree`
  rule on the data axis); under "tp" (`tp_plan`, JAX's `tp_sharding_tree`
  made head-aligned) the column- and row-parallel frozen tensors keep the
  rank's share over the model group and the ViT runs on its placement
  (`parallel.tensor`).  `gathered(module)` puts FSDP's whole tensors back
  for the span of a forward (a ViT or Swin block, the patch embedding) and
  drops the module's reference after it: what an op saved for its
  backward (the frozen projection that row 2's dO = g W^T reads) lives
  until that backward, as the replicated run's does.
- With a `pipeline` (`parallel.pipeline.PipelineSpec`) every ViT of the
  model runs its trunk through it (`ViT.pipeline`).  Under "pp"
  (`pp_plan`, JAX's `pp_sharding_tree`) a rank keeps only its stage's
  blocks, frozen and trainable: every tensor of another stage's block is
  an empty placeholder of its rank, so names and the optimizer's order
  stay those of the whole model; under "replicated" and "fsdp" it keeps
  every block as those policies do, and runs its stage's.
- Each trainable tensor's model-axis gradient rule is recorded once, by
  `tp_plan` or `pp_plan`, on the parameter (`model_grad`): "sum" where
  the rank's use was a share (in a pipeline: token prep, whose cotangent
  stage 0 alone receives, and under "replicated" / "fsdp" the blocks,
  each stage's gradients those of its own), "stage" where a stage alone
  holds the tensor, "keep" where every rank of the group computed the
  same; `collectives.reduce_gradients` reads it.
- `rank_rows(n, mesh, accum)`: the positions of the global batch this
  rank holds, by its data index (the T ranks of a model group hold the
  same rows).  JAX's micro-batch i is rows [i B/accum, (i+1) B/accum) of
  the global batch, sharded over the data axis, so the rank's micro-batch
  i is its D-th share of those rows.
- `rand_rows`: a random draw for the rank's rows, drawn for the global
  batch and sliced, so every rank's generator moves alike and the rank
  gets the 1-device run's values (JAX's draws under sharding are the
  unsharded ones); inside `micro_rows` (a pipeline microbatch) the draw
  is the rank's whole micro-step's, and the microbatch takes its rows.
  `block_seeds` gives each ViT block a generator of its own, so a
  pipeline stage draws what its blocks draw in the one-rank trunk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import re

import numpy as np
import torch
from torch import nn

from . import collectives
from .tensor import Placement, shard_index, unshard


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh as one rank sees it.  `world` and `rank` are the data
    axis (its size D and this rank's index on it: the batch's shares);
    `n_model` and `model_index` the model axis; `sequence_parallel`: the
    token stream is split over the model axis too."""
    world: int = 1
    rank: int = 0
    backend: str | None = None
    n_model: int = 1
    model_index: int = 0
    sequence_parallel: bool = False

    @property
    def shape(self) -> dict:
        out = {"data": self.world}
        if self.n_model > 1:
            out["model"] = self.n_model
        return out

    @property
    def distributed(self) -> bool:
        return self.world * self.n_model > 1


def make_mesh(n_data: int | None = None, n_model: int = 1,
              sequence_parallel: bool = False) -> Mesh:
    """The default group as a (data x model) mesh.  `n_data` None: the
    group's size over `n_model` (one device without a group); a size that
    differs from the group's, or > 1 without a group, raises: a run never
    shrinks to one process quietly."""
    n_model = int(n_model or 1)
    world = collectives.world_size()
    if sequence_parallel and n_model == 1:
        raise ValueError("sequence_parallel needs a model axis: set "
                         "tensor_parallel N")
    want = None if n_data is None else int(n_data) * n_model
    if (want is not None and want != world) or (world % n_model):
        if not collectives.initialized():
            raise RuntimeError(
                f"n_devices={want or n_model} asked for, but this process "
                "is not a rank of a process group: start it through "
                "apla_tpu_torch.parallel.launch (the CLIs do) or torchrun")
        raise ValueError(f"a mesh of {want or n_model} ranks ({n_data} x "
                         f"{n_model}), but the process group has {world}")
    axes = collectives.Axes()
    if n_model > 1:
        import torch.distributed as dist
        D, r = world // n_model, collectives.rank()
        model_groups = [dist.new_group(list(range(d * n_model,
                                                  (d + 1) * n_model)))
                        for d in range(D)]
        data_groups = [dist.new_group(list(range(m, world, n_model)))
                       for m in range(n_model)]
        axes = collectives.Axes(n_model=n_model,
                                data_group=data_groups[r % n_model],
                                model_group=model_groups[r // n_model])
    collectives.set_axes(axes)
    backend = torch.distributed.get_backend() \
        if collectives.initialized() else None
    return Mesh(world=world // n_model, rank=collectives.data_rank(),
                backend=backend, n_model=n_model,
                model_index=collectives.model_rank(),
                sequence_parallel=bool(sequence_parallel))


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


_ROWS: tuple | None = None      # (D, data index, micro-batch rows a rank)


@contextlib.contextmanager
def batch_rows(rows: int):
    """Within the block, `rand_rows` draws for `rows` rows a rank per
    micro-batch (a data-parallel step's); nothing changes on one data
    rank."""
    global _ROWS
    saved = _ROWS
    w = collectives.data_size()
    _ROWS = (w, collectives.data_rank(), int(rows)) if w > 1 else None
    try:
        yield
    finally:
        _ROWS = saved


_MICRO: tuple | None = None     # (start, stop, rows) of a microbatch


@contextlib.contextmanager
def micro_rows(start: int, stop: int, rows: int):
    """Within the block, a draw whose leading dim is stop - start (a
    pipeline microbatch) is the draw for the rank's `rows` rows, of which
    it takes [start, stop)."""
    global _MICRO
    saved = _MICRO
    _MICRO = (int(start), int(stop), int(rows))
    try:
        yield
    finally:
        _MICRO = saved


def rand_rows(shape, generator, device) -> torch.Tensor:
    """`torch.rand(shape)` for this rank's rows.  Inside `batch_rows(m)`
    with D > 1 and a leading dim of k * m (k micro-batches or stacked
    crops of m rows each), the draw is [k, D, m, ...] (the 1-device run's
    [k * D * m, ...]) and the rank takes [:, data index].  Inside
    `micro_rows`, that draw is made for the rank's rows and sliced."""
    shape = tuple(shape)
    if _MICRO is not None and shape and shape[0] == _MICRO[1] - _MICRO[0]:
        start, stop, rows = _MICRO
        return _rank_rand((rows,) + shape[1:], generator, device)[start:stop]
    return _rank_rand(shape, generator, device)


def _rank_rand(shape, generator, device) -> torch.Tensor:
    kw = dict(generator=generator, device=device)
    if _ROWS is None or not shape or shape[0] % _ROWS[2]:
        return torch.rand(shape, **kw)
    w, r, m = _ROWS
    k = shape[0] // m
    full = torch.rand((k, w, m) + shape[1:], **kw)
    return full[:, r].reshape(shape)


def block_seeds(generator: torch.Generator, n: int) -> list:
    """`n` seeds, one per ViT block, from `generator`'s state (read on the
    host: no wait on the device), which then moves on by one draw so that
    the next trunk call gets others."""
    state = generator.get_state().numpy().tobytes()
    seeds = [int.from_bytes(hashlib.blake2b(
        state + i.to_bytes(4, "little"), digest_size=8).digest(),
        "little") >> 1 for i in range(n)]
    torch.rand((1,), generator=generator, device=generator.device)
    return seeds


def seeded(seed: int | None, device) -> torch.Generator | None:
    """A generator on `device` seeded with `seed` (None: None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)




# --------------------------------------------------------------------------- #
# FSDP of the frozen tensors (over the data group)
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


def _frozen_leaves(model: nn.Module):
    """(name, tensor) of the frozen parameters and of W8A8's int8 leaves
    (`QuantizedKernel`'s `w_int8` and `scale`: the JAX quant dict's)."""
    from ..ops.quant import QuantizedKernel
    for name, p in model.named_parameters():
        if not p.requires_grad:
            yield name, p
    for name, m in model.named_modules():
        if isinstance(m, QuantizedKernel):
            yield name + ".w_int8", m.w_int8
            yield name + ".scale", m.scale


def fsdp_plan(model: nn.Module, n: int, min_size: int = 2 ** 16) -> dict:
    """{frozen tensor name: port dim it is sharded on} by JAX's rule on
    the leaf JAX holds: a ViT block's tensor is decided as the stacked
    [L, ...] leaf, and JAX dim d is the port's dim d - 1; every other
    tensor (the Swin's blocks are a list in JAX too) as it is.  A W8A8
    kernel's `w_int8` and `scale` are leaves like any other; its
    `w_kmajor` (the codes transposed) follows `w_int8` on the transposed
    dim."""
    stacked = _stacked_blocks(model)
    plan = {}
    for name, p in _frozen_leaves(model):
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
            if name.endswith(".w_int8"):
                plan[name[:-len("w_int8")] + "w_kmajor"] = 1 - d
    return plan


# --------------------------------------------------------------------------- #
# TP: the model axis
# --------------------------------------------------------------------------- #

# JAX's `tp_sharding_tree`: column-parallel qkv / fc1 / w12 (kernel and
# bias), row-parallel proj / fc2 / w3 (kernel); the port's qkv and w12
# shares are head-aligned and half-paired (`tensor.shard_index`)
_TP_SHARDS = {"attn.qkv.kernel": ("qkv", 1), "attn.qkv.bias": ("qkv", 0),
              "mlp.fc1.kernel": ("col", 1), "mlp.fc1.bias": ("col", 0),
              "mlp.w12.kernel": ("w12", 1), "mlp.w12.bias": ("w12", 0),
              "attn.proj.kernel": ("row", 0), "mlp.fc2.kernel": ("row", 0),
              "mlp.w3.kernel": ("row", 0)}
# trainable tensors the rank uses by its rows (APLA's columns)
_TP_USED_BY_ROWS = ("attn.proj_wt",)


@dataclasses.dataclass(frozen=True)
class TPEntry:
    """One tensor's place under "tp": `kind` / `dim` of its share (None:
    whole) and its gradient's model-axis rule ("sum" or "keep")."""
    kind: str | None
    dim: int | None
    grad: str


def tp_plan(model: nn.Module, n_model: int,
            sequence_parallel: bool = False) -> dict:
    """{parameter name: TPEntry} for every parameter of `model` and the
    int8 leaves.  In a ViT block: the column- and row-parallel tensors are
    shares, except where W8A8 keeps them whole (an int8 qkv with its bias;
    an MLP with an int8 kernel, all of it); a tensor the rank uses by a
    share, or (SP) applies to its token shard, has its gradient summed
    over the model group; every other tensor (token prep, the final norm,
    the heads: run replicated) keeps its gradient."""
    from ..ops.quant import QuantizedKernel
    quantized = {n for n, m in model.named_modules()
                 if isinstance(m, QuantizedKernel)}
    blocks = tuple(_stacked_blocks(model))
    token_rule = "sum" if sequence_parallel else "keep"
    plan = {}
    for name in [n for n, _ in model.named_parameters()] + [
            q + leaf for q in sorted(quantized)
            for leaf in (".w_int8", ".scale")]:
        pre = next((b for b in blocks if name.startswith(b)
                    and re.match(r"\d+\.", name[len(b):])), None)
        if pre is None:
            plan[name] = TPEntry(None, None, "keep")
            continue
        idx, rest = name[len(pre):].split(".", 1)
        blk = f"{pre}{idx}."
        int8_qkv = blk + "attn.qkv.kernel" in quantized
        int8_mlp = any(f"{blk}mlp.{d}.kernel" in quantized
                       for d in ("fc1", "fc2", "w12", "w3"))
        if any(name.startswith(q + ".") for q in quantized):
            entry = TPEntry(None, None, "keep")
        elif rest.startswith("attn.qkv.") and int8_qkv:
            entry = TPEntry(None, None, "sum")        # used by its columns
        elif rest.startswith("mlp.") and int8_mlp:
            entry = TPEntry(None, None, token_rule)   # the MLP runs whole
        elif rest in _TP_SHARDS:
            entry = TPEntry(*_TP_SHARDS[rest], "sum")
        elif rest in _TP_USED_BY_ROWS:
            entry = TPEntry(None, None, "sum")
        else:
            entry = TPEntry(None, None, token_rule)
        plan[name] = entry
    return plan


# --------------------------------------------------------------------------- #
# PP: the pipeline's stages on the model axis
# --------------------------------------------------------------------------- #

# a ViT's token prep (what the trunk runs before its blocks)
_TOKEN_PREP = ("patch_embed.", "cls_token", "pos_embed", "register_tokens",
               "mask_token")


@dataclasses.dataclass(frozen=True)
class PPEntry:
    """One tensor's place under a pipeline: `stage` that holds it under
    "pp" (None: every rank) and its gradient's model-axis rule."""
    stage: int | None
    grad: str


def pp_plan(model: nn.Module, n_stages: int, stage_owned: bool = True
            ) -> dict:
    """{parameter or buffer name: PPEntry} for every tensor of `model`,
    by JAX's `pp_sharding_tree`: each tensor of a ViT block (JAX's stacked
    [L, ...] leaf) belongs to stage i // (L / S) when S divides the depth
    L, every other tensor to every rank.  Gradient rules: a block's
    trainable tensor is "stage" (`stage_owned`, the "pp" policy) or "sum"
    (the other policies keep every block, and a stage's gradient reaches
    only its own); a ViT's token prep is "sum" (stage 0 alone receives
    the stream's cotangent); anything else (the final norm, the heads:
    every stage runs them on the broadcast output) "keep"."""
    from ..models.vit import ViT
    n = int(n_stages)
    stacked = _stacked_blocks(model)
    preps = tuple((name + "." if name else "") + leaf
                  for name, m in model.named_modules() if isinstance(m, ViT)
                  for leaf in _TOKEN_PREP)
    plan = {}
    for name, _ in list(model.named_parameters()) + list(
            model.named_buffers()):
        pre = next((b for b in stacked if name.startswith(b)
                    and re.match(r"\d+\.", name[len(b):])), None)
        if pre is not None:
            depth = stacked[pre]
            i = int(name[len(pre):].split(".", 1)[0])
            stage = i // (depth // n) if n > 1 and depth % n == 0 else None
            rule = "stage" if stage is not None and stage_owned else "sum"
            plan[name] = PPEntry(stage, rule)
        else:
            plan[name] = PPEntry(None, "sum" if name.startswith(preps)
                                 else "keep")
    return plan


def _to_placeholder(owner: nn.Module, attr: str, t: torch.Tensor) -> None:
    """`owner.attr` becomes an empty tensor of `t`'s rank, dtype and
    device (a parameter stays one, trainable as it was)."""
    empty = t.data.new_empty((0,) * t.dim())
    if attr in owner._buffers:
        owner._buffers[attr] = empty
    else:
        setattr(owner, attr, nn.Parameter(empty,
                                          requires_grad=t.requires_grad))


def _place_pipeline(model: nn.Module, mesh: Mesh, policy: str,
                    pipeline) -> dict:
    """The pipeline's placement (see `shard_params`); returns the
    stage-placed tensors (name -> stage) under "pp", else {}."""
    from ..models.vit import ViT
    for m in model.modules():
        if isinstance(m, ViT):
            m.pipeline, m.placement = pipeline, None
    pp = policy == "pp"
    out = {}
    for name, e in pp_plan(model, pipeline.n_stages, pp).items():
        owner, attr = _owner(model, name)
        t = getattr(owner, attr)
        if pp and e.stage is not None:
            owner.__dict__.setdefault("_pp_stages", {})[attr] = (
                e.stage, tuple(t.shape))
            if e.stage != mesh.model_index:
                _to_placeholder(owner, attr, t)
                t = getattr(owner, attr)
            out[name] = e.stage
        if isinstance(t, nn.Parameter) and t.requires_grad:
            t.model_grad = e.grad
    return out


def _owner(model: nn.Module, name: str):
    mod_name, _, attr = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), attr


def _set(module: nn.Module, attr: str, t: torch.Tensor) -> None:
    """`module.attr` = t, a buffer's or a (frozen) parameter's data."""
    if attr in module._buffers:
        module._buffers[attr] = t
    else:
        setattr(module, attr, nn.Parameter(t, requires_grad=False))


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh, policy: str = "replicated",
                 min_size: int = 2 ** 16, pipeline=None) -> dict:
    """Place `model`'s frozen tensors by `policy`: "replicated" leaves
    them whole; "fsdp" keeps this rank's slice of each tensor of
    `fsdp_plan` over the data group; "tp" this rank's share of each
    column- and row-parallel frozen tensor of `tp_plan` over the model
    group (the slice's own storage: the whole tensor is freed).  With a
    model axis under "tp", or under any policy with `sequence_parallel`,
    the model's ViTs run on the placement and each trainable tensor gets
    its gradient rule.  With a `pipeline` (`parallel.pipeline.
    PipelineSpec` over the mesh's model axis) the model's ViTs run their
    trunks through it and each trainable tensor gets its `pp_plan` rule;
    under "pp" the rank keeps its stage's block tensors, trainable ones
    included, and every other block tensor becomes an empty placeholder;
    "tp" is then the replicated placement (the model axis holds the
    stages).  "pp" without a pipeline, and "tp" without a model axis, are
    the replicated placement, as JAX's rules give them on a model axis of
    one.  Returns the sharded tensors (name -> dim; under "pp" name ->
    stage)."""
    from ..models.vit import ViT
    if policy not in ("replicated", "fsdp", "tp", "pp"):
        raise ValueError(f"unknown param_sharding policy: {policy!r}")
    if pipeline is not None:
        out = _place_pipeline(model, mesh, policy, pipeline)
        if policy != "fsdp" or mesh.world == 1:
            return out
        return _place_fsdp(model, mesh, min_size)
    placed = mesh.n_model > 1 and (policy == "tp"
                                   or mesh.sequence_parallel)
    pl = Placement(mesh.n_model, mesh.model_index,
                   mesh.sequence_parallel) if placed else None
    for m in model.modules():
        if isinstance(m, ViT):
            m.placement = pl
    out = {}
    if placed:
        for name, e in tp_plan(model, mesh.n_model,
                               mesh.sequence_parallel).items():
            owner, attr = _owner(model, name)
            t = getattr(owner, attr)
            if isinstance(t, nn.Parameter) and t.requires_grad:
                t.model_grad = e.grad
            elif policy == "tp" and e.kind is not None:
                full_shape = tuple(t.shape)
                idx = shard_index(e.kind, full_shape[e.dim], mesh.n_model,
                                  mesh.model_index).to(t.device)
                _set(owner, attr, t.data.index_select(e.dim, idx).clone())
                owner.__dict__.setdefault("_tp_shards", {})[attr] = (
                    e.kind, e.dim, full_shape)
                out[name] = e.dim
    if policy != "fsdp" or mesh.world == 1:
        return out
    out.update(_place_fsdp(model, mesh, min_size))
    return out


def _place_fsdp(model: nn.Module, mesh: Mesh, min_size: int) -> dict:
    out = {}
    for name, dim in fsdp_plan(model, mesh.world, min_size).items():
        owner, attr = _owner(model, name)
        t = getattr(owner, attr)
        full_shape = tuple(t.shape)
        _set(owner, attr,
             t.data.chunk(mesh.world, dim=dim)[mesh.rank].clone())
        owner.__dict__.setdefault("_fsdp_shards", {})[attr] = (dim,
                                                               full_shape)
        out[name] = dim
    return out


def is_sharded(model: nn.Module) -> bool:
    return any(getattr(m, "_fsdp_shards", None)
               or getattr(m, "_tp_shards", None)
               or getattr(m, "_pp_stages", None) for m in model.modules())


def _stage_placed(model: nn.Module) -> bool:
    return any(getattr(m, "_pp_stages", None) for m in model.modules())


def _gather_dim(shard: torch.Tensor, dim: int) -> torch.Tensor:
    x = shard.movedim(dim, 0).contiguous()
    return collectives.all_gather(x).movedim(0, dim).contiguous()


def _gather_share(shard: torch.Tensor, kind: str, dim: int) -> torch.Tensor:
    """A TP share gathered whole over the model group."""
    x = shard.movedim(dim, 0).contiguous()
    parts = collectives.all_gather(x, collectives.MODEL).chunk(
        collectives.model_size())
    return unshard(list(parts), kind, 0).movedim(0, dim).contiguous()


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
    """The FSDP-sharded frozen tensors under `module` (but not under the
    modules of `exclude`) whole for the block: each is all-gathered over
    the data group into a new tensor that the module holds until the block
    ends.  A no-op for an unsharded module."""
    items = list(_sharded_in(module, exclude))
    if not items:
        yield
        return
    saved = []
    for m, attr, dim in items:
        shard = getattr(m, attr)
        saved.append((m, attr, shard))
        _set(m, attr, _gather_dim(shard.detach(), dim))
    try:
        yield
    finally:
        for m, attr, shard in saved:
            if attr in m._buffers:
                m._buffers[attr] = shard
            else:
                setattr(m, attr, shard)


def _shard_info(model: nn.Module, name: str):
    """(FSDP (dim, full shape) or None, TP (kind, dim, full shape) or None,
    PP (stage, full shape) or None) of the tensor `name`; an SSL state's
    `teacher.<name>` is the EMA twin of the model's `<name>`."""
    for cand in (name, name.removeprefix("teacher.")):
        mod_name, _, attr = cand.rpartition(".")
        try:
            owner = model.get_submodule(mod_name) if mod_name else model
        except AttributeError:
            continue
        if not hasattr(owner, attr):
            continue
        return ((getattr(owner, "_fsdp_shards", None) or {}).get(attr),
                (getattr(owner, "_tp_shards", None) or {}).get(attr),
                (getattr(owner, "_pp_stages", None) or {}).get(attr))
    return None, None, None


def whole_state(model: nn.Module, state: dict) -> dict:
    """`state` (name -> tensor of `model`) with each tensor that `model`
    holds sharded gathered whole (FSDP's over the data group, TP's over
    the model group, and under "pp" every stage's block tensors from the
    stage that holds them: a name that only its stage's `state` has, a
    gradient, is added); every rank must call it."""
    if not is_sharded(model):
        return state
    out, own = {}, {}
    device = next((t.device for t in state.values()), torch.device("cpu"))
    for name, t in state.items():
        fsdp, tp, pp = _shard_info(model, name)
        t = t.detach()
        if pp:
            if pp[0] == collectives.model_rank():
                own[name] = t.cpu()
            continue
        if fsdp:
            t = _gather_dim(t, fsdp[0])
        if tp:
            t = _gather_share(t, tp[0], tp[1])
        out[name] = t
    if _stage_placed(model):
        for part in collectives.gather_objects(own):
            out.update((n, t.to(device)) for n, t in part.items())
    return out


def local_state(model: nn.Module, state: dict) -> dict:
    """`state` (name -> whole tensor) with the tensors that `model` holds
    sharded cut to this rank's share (TP's, then FSDP's slice of it; under
    "pp" another stage's block tensor becomes the empty placeholder), so
    that it loads into the placed model (`load_session` re-applies the
    placement)."""
    if not is_sharded(model):
        return state
    out = dict(state)
    for name, t in state.items():
        fsdp, tp, pp = _shard_info(model, name)
        if pp and pp[0] != collectives.model_rank():
            out[name] = t.new_empty((0,) * t.dim())
            continue
        if tp and tuple(t.shape) == tp[2]:
            idx = shard_index(tp[0], tp[2][tp[1]], collectives.model_size(),
                              collectives.model_rank()).to(t.device)
            t = t.index_select(tp[1], idx)
        if fsdp and tuple(t.shape) == fsdp[1]:
            t = t.chunk(collectives.data_size(), dim=fsdp[0])[
                collectives.data_rank()]
        out[name] = t.clone() if t is not state[name] else t
    return out


def _param_stages(model: nn.Module) -> dict:
    """{id of a parameter: the stage that holds it} under "pp"."""
    return {id(getattr(m, attr)): stage for m in model.modules()
            for attr, (stage, _) in (getattr(m, "_pp_stages", None)
                                     or {}).items()}


def whole_optimizer_state(model: nn.Module, state: dict, params) -> dict:
    """A `torch.optim` state dict over `params` (the optimizer's order)
    with, under "pp", each stage-held parameter's entry from the stage
    that holds it (a placeholder's entry is dropped); every rank must call
    it."""
    if not _stage_placed(model):
        return state
    stages, mine = _param_stages(model), collectives.model_rank()
    where = [stages.get(id(p)) for p in params]
    cpu = lambda v: v.detach().cpu() if isinstance(  # noqa: E731
        v, torch.Tensor) else v
    own = {i: {k: cpu(v) for k, v in st.items()}
           for i, st in state["state"].items() if where[i] == mine}
    merged = {i: st for i, st in state["state"].items() if where[i] is None}
    for part in collectives.gather_objects(own):
        merged.update(part)
    return {"state": dict(sorted(merged.items())),
            "param_groups": state["param_groups"]}


def local_optimizer_state(model: nn.Module, state: dict, params) -> dict:
    """A whole optimizer state dict (`whole_optimizer_state`'s) without
    the entries of the parameters another stage holds."""
    if not _stage_placed(model):
        return state
    stages, mine = _param_stages(model), collectives.model_rank()
    keep = {i for i, p in enumerate(params)
            if stages.get(id(p), mine) == mine}
    return {"state": {i: st for i, st in state["state"].items()
                      if i in keep},
            "param_groups": state["param_groups"]}


def resident_bytes(model: nn.Module, frozen_only: bool = True) -> int:
    """Bytes of the (frozen) parameters and the buffers (W8A8's int8
    codes and scales, APLA's indices) this rank holds."""
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if not (frozen_only and p.requires_grad)) \
        + sum(b.numel() * b.element_size() for b in model.buffers())
