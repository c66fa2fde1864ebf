"""Rank bodies for `parallel.launch`: a classifier trained for a few
updates on given global batches, as `tests/test_parallel.py` drives JAX's
(data x model) mesh, and the kernel-free probes of the collectives.  The CPU tests
and `chip_smoke.py` hold these runs at W ranks against the same run at one
rank (and the tests against JAX's 1-device step); they live in the port
because a spawned rank imports its body's module.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from . import collectives
from .mesh import make_mesh, pad_to_multiple, resident_bytes, shard_batch, \
    shard_params, whole_state

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _by_rank(x) -> list:
    """Every rank's `x`, in rank order (a list of one without a group)."""
    out = collectives.host_allgather(x)
    return out if collectives.initialized() else [out]


def _gradient_rule_fault(model, fault: str) -> None:
    """The deliberate faults of the model-axis gradient rule: "skip_wt_sum"
    keeps APLA's columns' gradients unsummed (each rank's rows only),
    "sum_head" sums the head's over the model group (T or S times the
    one-rank gradient), "skip_prep_sum" keeps a pipeline's token-prep
    gradients unsummed (the stages after the first hold zeros)."""
    prep = ("backbone.patch_embed.", "backbone.cls_token",
            "backbone.pos_embed")
    for name, p in model.named_parameters():
        if fault == "skip_wt_sum" and name.endswith("attn.proj_wt"):
            p.model_grad = "keep"
        elif fault == "sum_head" and name.startswith("fc."):
            p.model_grad = "sum"
        elif fault == "skip_prep_sum" and name.startswith(prep):
            p.model_grad = "keep"


@contextlib.contextmanager
def _own_projection_partial():
    """The deliberate fault of a model-axis run: in every attention block
    this rank reads its own partial product of the projection in place of
    the model group's sum (the sum still runs, and its backward, so the
    ranks' collectives stay matched)."""
    from . import tensor
    attention, leave = tensor.attention, tensor.leave

    def own_leave(partial, pl, dtype, bias=None):
        y = leave(partial, pl, dtype, bias)
        own = partial
        if pl.sequence_parallel:
            start, length = collectives.own_tokens(partial.shape[1])
            own = partial[:, start:start + length]
        own = own.to(dtype) + (0 if bias is None else bias.to(dtype))
        return y + (own - y).detach()

    def faulty_attention(*args, **kwargs):
        tensor.leave = own_leave
        try:
            return attention(*args, **kwargs)
        finally:
            tensor.leave = leave

    tensor.attention = faulty_attention
    try:
        yield
    finally:
        tensor.attention = attention


def _skip_own_reduction(params) -> None:
    """The deliberate fault: this rank takes part in the gradients'
    all-reduce but keeps its own gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    collectives.all_reduce_(flat, "gradients")


def classifier_run(spec: dict) -> dict | None:
    """Train a classifier for `len(spec["batches"])` updates on this rank's
    rows of each global batch; rank 0 returns the run's record.

    `spec`: "vit" (ViTConfig keywords, "compute_dtype" by name), "state"
    ((trainable, frozen) name -> tensor maps) or "seed" with "n_classes"
    and "partial_size", "optimizer" (type, params), "grad_clip", "lr",
    "batches" (global {"image", "label"} numpy batches), "accum",
    "policy" ("replicated" | "fsdp" | "tp" | "pp"), "min_size" (the FSDP
    threshold), "tensor_parallel" (T, the model axis) and
    "sequence_parallel", or "pipeline_parallel" (S, the model axis as a
    pipeline's stages) and "pp_microbatches" (M, default S), "quantize"
    (W8A8: the frozen qkv / fc1 / fc2 in int8 before the placement),
    "device" (default: the rank's card, or the CPU), "seed" of the step
    draws, "fault": "skip_reduction": rank 0 (whose record comes back)
    keeps its own gradients; "skip_wt_sum" / "sum_head" /
    "skip_prep_sum": the gradient rule broken on APLA's columns / the
    head / a pipeline's token prep.  Returns {"losses", "grad_norms",
    "grads" (the first update's reduced gradients, before the clip, and
    with a pipeline "stage_grads": each stage's of the tensors every stage
    holds, in stage order),
    "trainable" (CPU tensors, whole), "frozen_bytes" (a rank's resident
    frozen bytes, by rank), "trainable_bytes", "counts" (bytes by
    collective kind, per update), "plan" (the sharded tensors), "world",
    "n_model", "embed" (the embed step's output on the first batch's
    images after training, its first "embed_rows" when given)}."""
    from ..apla.core import AplaConfig
    from ..models.classifier import classifier_from_state, init_classifier
    from ..models.vit import ViTConfig
    from ..train import steps as steps_mod
    from ..train.losses import cross_entropy
    from ..train.optim import build_optimizer
    from ..train.train_state import TrainState

    from .pipeline import PipelineSpec

    device = torch.device(spec.get("device") or "cuda")
    T = int(spec.get("tensor_parallel", 1))
    S = int(spec.get("pipeline_parallel", 1))
    mesh = make_mesh(None, max(T, S), bool(spec.get("sequence_parallel")))
    pipeline = PipelineSpec(mesh, S, int(spec.get("pp_microbatches", S))) \
        if S > 1 else None
    vit_kw = dict(spec["vit"])
    vit_kw["compute_dtype"] = _DTYPES[vit_kw.get("compute_dtype",
                                                 "float32")]
    cfg = ViTConfig(**vit_kw)
    if spec.get("state") is not None:
        t_state, f_state = spec["state"]
        model = classifier_from_state(cfg, t_state, f_state, device)
    else:
        model = init_classifier(
            cfg, int(spec["n_classes"]),
            apla_cfg=AplaConfig(partial_size=spec.get("partial_size", 8)),
            generator=torch.Generator().manual_seed(int(spec.get("seed", 0))),
            device=device)
    if spec.get("quantize"):
        from ..ops.quant import quantize_frozen_backbone
        quantize_frozen_backbone(model)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0
    plan = shard_params(model, mesh, spec.get("policy", "replicated"),
                        min_size=int(spec.get("min_size", 2 ** 16)),
                        pipeline=pipeline)
    if spec.get("fault") in ("skip_wt_sum", "sum_head", "skip_prep_sum"):
        _gradient_rule_fault(model, spec["fault"])
    after = torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt_type, opt_params = spec.get("optimizer",
                                    ("AdamW", {"lr": 1e-3,
                                               "weight_decay": 1e-5}))
    opt = build_optimizer(opt_type, dict(opt_params), named,
                          grad_clip=spec.get("grad_clip", 1.0))
    state = TrainState(0, model, opt)
    accum = int(spec.get("accum", 1))
    saved = steps_mod.reduce_gradients
    reduce = _skip_own_reduction if (spec.get("fault") == "skip_reduction"
                                     and mesh.rank == 0) else saved
    first = {}

    def reduce_and_keep(params):
        reduce(params)
        if not first:
            first.update((n, p.grad.detach().clone()) for n, p in named
                         if p.grad is not None)

    steps_mod.reduce_gradients = reduce_and_keep
    try:
        step = steps_mod.make_train_step(cfg, opt, cross_entropy,
                                         accum_steps=accum)
        gen = torch.Generator(device=device)
        losses, norms, counts = [], [], []
        for i, batch in enumerate(spec["batches"]):
            batch, _ = pad_to_multiple(batch, mesh.world)
            batch = shard_batch(batch, mesh, accum)
            batch = {k: torch.as_tensor(np.asarray(v)).to(device)
                     for k, v in batch.items()}
            gen.manual_seed((int(spec.get("seed", 0)) << 32) + i)
            collectives.reset_counts()
            state, m = step(state, batch, float(spec.get("lr", 1e-3)), gen)
            counts.append(dict(collectives.COUNTS))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        steps_mod.reduce_gradients = saved
    # the embed step (kNN's) on the first global batch's images, whole
    from ..train.steps import make_embed_step
    rows = int(spec.get("embed_rows") or len(spec["batches"][0]["image"]))
    embed = make_embed_step(cfg)(model, torch.as_tensor(
        np.asarray(spec["batches"][0]["image"][:rows])).to(device)).cpu()
    frozen_bytes = _by_rank(resident_bytes(model))
    mem = _by_rank((before, after))
    t_bytes = sum(p.numel() * p.element_size() for _, p in named)
    grads = {n: g.cpu() for n, g in whole_state(model, first).items()}
    # a pipeline: each stage's gradients of the tensors every stage holds
    stage_grads = collectives.gather_objects(
        {n: g.cpu() for n, g in first.items() if n not in plan},
        collectives.MODEL) if pipeline is not None else None
    trainable = {n: t.cpu().clone() for n, t in whole_state(
        model, {n: p.detach() for n, p in named}).items()}
    if not collectives.is_rank0():
        return None
    return {"losses": losses, "grad_norms": norms, "embed": embed,
            "grads": grads, "stage_grads": stage_grads,
            "trainable": trainable,
            "frozen_bytes": frozen_bytes, "allocated": mem,
            "trainable_bytes": t_bytes, "counts": counts, "plan": plan,
            "world": mesh.world, "n_model": mesh.n_model}


def collectives_probe(device: str = "cpu") -> dict | None:
    """Each collective of `collectives` once on tensors of `device`
    (rank r holds rows 2r and 2r + 1 of arange): psum, pmean, all_gather,
    mesh_average, mesh_all_gather with its gradient, psum_grad
    with its gradient, host_allgather, gather_rows; rank 0 returns the
    values and the byte counts."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    w, r = collectives.world_size(), collectives.rank()
    collectives.reset_counts()
    x = torch.arange(2 * r, 2 * r + 2, dtype=torch.float32, device=dev)
    out = {"psum": collectives.psum(x).cpu(),
           "pmean": collectives.pmean(x).cpu(),
           "all_gather": collectives.all_gather(x).cpu(),
           "mesh_average": collectives.mesh_average(x[:, None]).cpu()}
    xg = x.clone().requires_grad_(True)
    g = collectives.mesh_all_gather(xg)
    (g * torch.arange(1.0, 2 * w + 1, device=dev)).sum().backward()
    out["mesh_all_gather"] = g.detach().cpu()
    out["mesh_all_gather_grad"] = collectives.all_gather(xg.grad).cpu()
    xs = x.clone().requires_grad_(True)
    s = collectives.psum_grad(xs)
    (s * s).sum().backward()
    out["psum_grad_grad"] = collectives.all_gather(xs.grad).cpu()
    out["host_allgather"] = _by_rank(r)
    valid = torch.tensor([True, r < w - 1])
    out["gather_rows"] = collectives.gather_rows(valid, x).cpu()
    out["counts"] = dict(collectives.COUNTS)
    out["world"] = w
    collectives.synchronize()
    return out if r == 0 else None


def _nccl_reduce_scatter_dim1(x: torch.Tensor) -> torch.Tensor:
    """`collectives.reduce_scatter_dim1` through its NCCL branch (the
    padded, rank-major chunks and `reduce_scatter_tensor`) on a group of
    another backend: `reduce_scatter_tensor` is an all-reduce of the
    chunks and the rank's chunk kept."""
    import torch.distributed as dist

    def reduce_scatter_tensor(out, src, group=None):
        full = src.clone()
        dist.all_reduce(full, group=group)
        out.copy_(full.chunk(dist.get_world_size(group))[
            dist.get_rank(group)])

    saved = dist.get_backend, dist.reduce_scatter_tensor
    dist.get_backend = lambda group=None: "nccl"
    dist.reduce_scatter_tensor = reduce_scatter_tensor
    try:
        return collectives.reduce_scatter_dim1(x)
    finally:
        dist.get_backend, dist.reduce_scatter_tensor = saved


def model_axis_probe(n_model: int, lengths=(17, 257), dim: int = 3,
                     device: str = "cpu") -> dict | None:
    """The model axis's operators on a (world / T) x T mesh, with their
    gradients, at each token count of `lengths` (a column-parallel
    product of identity columns, `tensor.column`, stands for qkv and
    fc1, with and without SP): the whole stream x [2,
    n, dim] is arange-valued and the same on every rank.  Per n, rank 0
    returns the rank's split, the gathers' and the scatter's outputs and
    the cotangents each operator gives its input under a loss that weighs
    every element by its global position plus one (scaled by the model
    rank plus one where the loss reads a rank's share); the token shards
    of the first model group's ranks as lists.  `reduce_scatter` and
    `reduce_scatter_nccl`: the same partials through
    `reduce_scatter_dim1`'s branch for the group's backend and through
    its NCCL branch."""
    from .mesh import make_mesh
    from .tensor import Placement, column
    dev = torch.device(device)
    make_mesh(None, n_model)
    T, m = collectives.model_size(), collectives.model_rank()
    eye = torch.eye(dim, device=dev)
    out = {}
    for n in lengths:
        x = torch.arange(2 * n * dim, dtype=torch.float32,
                         device=dev).reshape(2, n, dim)
        weight = x + 1.0
        start, length = collectives.own_tokens(n)
        # split -> gather_trunk: the stream back, and each rank's loss on
        # the whole stream gives its input the whole cotangent (no sum)
        xs = x.clone().requires_grad_(True)
        part = collectives.split_tokens(xs)
        whole = collectives.gather_trunk(part, n)
        (whole * weight).sum().backward()
        rec = {"split": part.detach().cpu(), "trunk": whole.detach().cpu(),
               "trunk_grad": xs.grad.cpu()}
        # SP's gather before a column-parallel product: the consumer's
        # shares sum back, the rank's tokens kept
        xp = part.detach().clone().requires_grad_(True)
        g = column(xp, eye, None, Placement(T, m, True), n)
        (g * weight * (m + 1)).sum().backward()
        rec["tokens"] = g.detach().cpu()
        rec["tokens_grad"] = _by_rank(xp.grad.cpu())[:T]
        # scatter_tokens: the ranks' partials summed, the rank's tokens
        xq = (x * (m + 1)).clone().requires_grad_(True)
        sc = collectives.scatter_tokens(xq)
        (sc * weight[:, start:start + length]).sum().backward()
        rec["scatter"] = _by_rank(sc.detach().cpu())[:T]
        rec["scatter_grad"] = xq.grad.cpu()
        xr = x * (m + 1)
        rec["reduce_scatter"] = _by_rank(
            collectives.reduce_scatter_dim1(xr).cpu())[:T]
        rec["reduce_scatter_nccl"] = _by_rank(
            _nccl_reduce_scatter_dim1(xr).cpu())[:T]
        # TP: the column product's dx summed / reduce_from_model
        xc = x.clone().requires_grad_(True)
        r = collectives.reduce_from_model(
            column(xc, eye, None, Placement(T, m), n) * (m + 1))
        (r * weight).sum().backward()
        rec["reduce"] = r.detach().cpu()
        rec["copy_grad"] = xc.grad.cpu()
        out[n] = rec
    out["T"], out["world"] = T, collectives.world_size()
    out["counts"] = dict(collectives.COUNTS)
    return out if collectives.is_rank0() else None


def no_model_axis_probe() -> dict | None:
    """On a data-only mesh of the group, a collective over MODEL (the
    empty axis) returns its input and counts no bytes; rank 0 returns
    what `all_reduce_` and `all_gather` gave back and the counts."""
    from .mesh import make_mesh
    make_mesh(None, 1)
    collectives.reset_counts()
    x = torch.arange(3.0) + collectives.rank()
    out = {"x": x.clone(),
           "all_reduce": collectives.all_reduce_(x.clone(), "model",
                                                 collectives.MODEL),
           "all_gather": collectives.all_gather(x, collectives.MODEL,
                                                "model"),
           "counts": dict(collectives.COUNTS)}
    return out if collectives.is_rank0() else None


def data_group_probe(n_model: int, world: bool = False) -> dict | None:
    """The reductions over samples on a (world / T) x T mesh, each rank
    holding rows 8 r_d .. 8 r_d + 7 of a seeded [8 D, 16] batch (r_d its
    data index): BatchNorm's statistics and the gradient through them
    (`ssl.heads.batch_norm`), the DINO center (`mesh_average`), KoLeo
    (`ssl.dinov2.koleo_loss`, with its gradient) and Sinkhorn-Knopp.
    `world` (the trap: the T ranks of a model group hold the same rows):
    the reductions over samples run over the world with the world's rank
    and size, as they did before the model axis.  A mean
    over rows that each appear T times is the mean, so BatchNorm's
    statistics and gradient and the center hold; KoLeo's gathered batch
    then holds each row's duplicate, its nearest neighbour.  Rank 0
    returns the values."""
    from ..ssl import dinov2, heads
    from .mesh import make_mesh
    make_mesh(None, n_model)
    saved = (collectives._AXES, collectives.data_size,
             collectives.data_rank)
    if world:
        collectives.set_axes(dataclasses.replace(collectives._AXES,
                                                 data_group=None))
        collectives.data_size = collectives.world_size
        collectives.data_rank = collectives.rank
        heads.data_size = dinov2.data_size = collectives.world_size
        dinov2.data_rank = collectives.rank
    try:
        D = collectives.world_size() // n_model
        r = collectives.rank() // n_model
        gen = torch.Generator().manual_seed(0)
        full = torch.randn((8 * D, 16), generator=gen)
        rows = torch.arange(8 * r, 8 * r + 8)
        x = full[rows].clone().requires_grad_(True)
        bn, state = heads._bn_init(16)
        y, new = heads.batch_norm(x, bn, state, train=True)
        (y * torch.arange(1.0, 17.0)).sum().backward()
        out = {"bn_mean": new["mean"], "bn_var": new["var"],
               "bn_grad": x.grad.clone()}
        out["center"] = collectives.mesh_average(full[rows] * 2.0,
                                                 keepdim=True)
        xk = full[rows].clone().requires_grad_(True)
        k = dinov2.koleo_loss(xk)
        k.backward()
        out["koleo"], out["koleo_grad"] = k.detach(), xk.grad.clone()
        out["sinkhorn"] = dinov2.sinkhorn_knopp_teacher(full[rows], 0.1)
    finally:
        collectives.set_axes(saved[0])
        collectives.data_size, collectives.data_rank = saved[1:]
        heads.data_size = dinov2.data_size = saved[1]
        dinov2.data_rank = saved[2]
    return {k: v.detach().cpu() for k, v in out.items()} \
        if collectives.is_rank0() else None


def trainer_run(params: dict, objective: str = "supervised",
                resume: bool = False) -> dict | None:
    """A recipe through its wrapper and trainer on this rank: train, then
    (supervised) the test table; `resume`: `load_session` again after
    training.  Rank 0 returns {"history", "test", "plan", "frozen_bytes"
    (by rank), "sharded_after_resume"}."""
    import types

    from ..ssl import get_ssl_wrapper_and_trainer
    from ..train.trainer import Trainer
    from ..wrapper import DefaultWrapper
    from .mesh import is_sharded

    if objective == "supervised":
        wrapper_cls, trainer_cls = DefaultWrapper, Trainer
    else:
        flags = {k: objective == k
                 for k in ("byol", "simsiam", "dino", "dinov2")}
        wrapper_cls, trainer_cls = get_ssl_wrapper_and_trainer(
            types.SimpleNamespace(**flags))
    wrapper = wrapper_cls(params)
    wrapper.instantiate()
    trainer = trainer_cls(wrapper)
    trainer.train()
    test = trainer.test() if wrapper.is_supervised else trainer.evaluate()
    sharded = None
    if resume:
        trainer.load_session()
        sharded = is_sharded(wrapper.model)
    frozen_bytes = _by_rank(resident_bytes(wrapper.model))
    if not collectives.is_rank0():
        return None
    return {"history": trainer.history, "test": test,
            "plan": dict(wrapper.fsdp_plan), "frozen_bytes": frozen_bytes,
            "sharded_after_resume": sharded}


def loaded_modules() -> list:
    """The module names a rank has imported (rank 0's)."""
    import sys
    names = sorted(sys.modules)
    return names if collectives.is_rank0() else None


def fail_on_rank(bad: int) -> None:
    """Rank `bad` raises; the others wait at a barrier for it (a launch
    must end them and report the failure)."""
    if collectives.rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    collectives.synchronize()


def _crop_rows(x, rows, n):
    """Rows `rows` of each crop of a crop-major stack [c * n, ...]."""
    x = torch.as_tensor(np.asarray(x))
    c = x.shape[0] // n
    return x.reshape((c, n) + x.shape[1:])[:, torch.as_tensor(rows)] \
        .reshape((-1,) + x.shape[1:])


def ssl_steps_run(objective: str, params: dict, payload: dict, batches,
                  calls) -> list | None:
    """An SSL objective's train step ("byol", "simsiam", "dino",
    "dinov2") on this rank's rows of each global batch, from the state
    `payload` ({"model": state dict, "aux": the state's `aux()`}).
    `batches`: BYOL's [views], DINO's (global stack, local stack), DINOv2's
    collated dicts; `calls`: per step {"lr", "momentum"} (+ "wd",
    "teacher_temp", "freeze" for DINO and DINOv2).  Rank 0 returns per
    step (trainable, aux, metrics), CPU tensors and floats."""
    import types

    from ..ssl import get_ssl_wrapper_and_trainer

    flags = {k: objective == k for k in ("byol", "simsiam", "dino",
                                         "dinov2")}
    wrapper_cls, _ = get_ssl_wrapper_and_trainer(
        types.SimpleNamespace(**flags))
    from .mesh import local_state
    w = wrapper_cls(params)
    w.instantiate()
    mesh = w.mesh
    with torch.no_grad():
        w.model.load_state_dict(local_state(w.model, payload["model"]),
                                strict=True)
    state = w.state
    state.load_aux(local_state(w.model, payload["aux"]))
    accum = int(params["training_params"].get("accum_steps", 1))
    if objective in ("byol", "simsiam"):
        from ..ssl.byol import make_byol_train_step
        step = make_byol_train_step(w.vit_cfg, w.optimizer,
                                    objective == "byol", accum_steps=accum)
    elif objective == "dino":
        from ..ssl.dino import make_dino_train_step
        steps = {f: make_dino_train_step(w.vit_cfg, w.optimizer, 2, 8,
                                         freeze_last_layer=f,
                                         accum_steps=accum)
                 for f in (True, False)}
    else:
        from ..ssl.dinov2 import ibot_mask_rows, make_dinov2_train_step
        ng = w.crops_params.n_global_crops
        steps = {f: make_dinov2_train_step(
            w.vit_cfg, w.optimizer, w.model_params.dinov2, ng,
            w.crops_params.n_local_crops, freeze_last_layer=f,
            accum_steps=accum) for f in (True, False)}
    from .mesh import rank_rows
    out = []
    for batch, c in zip(batches, calls):
        gen = torch.Generator().manual_seed(0)
        if objective in ("byol", "simsiam"):
            n = batch[0].shape[0]
            rows = torch.as_tensor(rank_rows(n, mesh, accum))
            views = [torch.as_tensor(np.asarray(v))[rows] for v in batch]
            state, m = step(state, views, c["lr"], c["momentum"], gen)
        elif objective == "dino":
            g, loc = batch
            n = g.shape[0] // 2
            rows = rank_rows(n, mesh, accum)
            state, m = steps[c["freeze"]](
                state, _crop_rows(g, rows, n), _crop_rows(loc, rows, n),
                c["lr"], c["wd"], c["momentum"], c["teacher_temp"], gen)
        else:
            n = batch["collated_global_crops"].shape[0] // ng
            rows = rank_rows(n, mesh, accum)
            tb = dict(batch)
            tb.update(ibot_mask_rows(batch, rows, n, ng,
                                     len(batch["mask_indices_list"])
                                     // (ng * n)))
            tb["collated_global_crops"] = batch["collated_global_crops"]
            tb = {k: torch.as_tensor(np.asarray(v)) for k, v in tb.items()
                  if v is not None and k not in ("label",
                                                 "n_masked_patches")}
            for k in ("collated_global_crops", "collated_local_crops"):
                if k in tb:
                    tb[k] = _crop_rows(tb[k], rows, n)
            state, m = steps[c["freeze"]](state, tb, c["lr"], c["wd"],
                                          c["momentum"], c["teacher_temp"],
                                          gen)
        out.append(({k: p.detach().cpu().clone() for k, p in whole_state(
                        w.model, state.trainable()).items()},
                    {k: t.detach().cpu().clone() for k, t in whole_state(
                        w.model, state.aux()).items()},
                    {k: float(v) for k, v in m.items()}))
    return out if collectives.is_rank0() else None


def _counters() -> tuple:
    """The launch-counting wrappers of the kernels these paths run."""
    from ..ops import (fused_apla_attn, fused_swin_attn, int8_matmul, mha,
                       proto_ce)
    return (fused_apla_attn.fused_apla_attn_fwd,
            fused_apla_attn.fused_apla_attn_bwd, proto_ce.proto_ce_fwd,
            proto_ce.proto_ce_dxs, proto_ce.proto_ce_dws,
            fused_swin_attn.fused_swin_attn_fwd,
            fused_swin_attn.fused_swin_attn_bwd, mha.mha_fwd, mha.mha_bwd,
            int8_matmul.fused_int8_matmul)


def kernel_launches() -> dict:
    """{kernel wrapper: launches} of this process's counters."""
    return {f.__name__: f.launches for f in _counters()}


def _reset_launches() -> None:
    for f in _counters():
        f.launches = 0


def recipe_updates(params: dict, objective: str = "supervised",
                   updates: int = 1, seed: int = 0,
                   fault: str | None = None) -> dict | None:
    """`updates` optimizer updates of a recipe through its wrapper (and,
    for an SSL objective, its trainer's `train_one`) on this rank's rows
    of the first global batches, the step draws seeded as the trainer
    seeds them.  `fault` "skip_reduction": rank 0 keeps its own
    gradients; "own_projection": rank 0 reads its own partial of every
    projection on the model axis (`_own_projection_partial`); "sum_head"
    / "skip_prep_sum": the gradient rule broken on the head / token prep
    (`_gradient_rule_fault`).
    Rank 0 returns {"losses" (per update: the metrics), "grads" (the
    reduced gradients of the first update, whole; with a pipeline also
    "stage_grads": each stage's of the tensors every stage holds),
    "trainable" (after the last),
    "frozen_bytes" and "allocated" (the frozen parameters' bytes and
    `torch.cuda.memory_allocated` before and after the placement, by
    rank), "counts" (bytes by collective kind, per update), "launches"
    (the kernels' launches summed over ranks), "update_s" (rank 0's wall
    seconds of each update, to its device's end), "world"}."""
    import time
    import types

    from ..ssl import get_ssl_wrapper_and_trainer
    from ..train import steps as steps_mod
    from ..train.trainer import Trainer
    from ..wrapper import DefaultWrapper
    from ..ssl import byol as byol_mod, dino as dino_mod, dinov2 as d2_mod

    if objective == "supervised":
        wrapper_cls, trainer_cls = DefaultWrapper, Trainer
    else:
        wrapper_cls, trainer_cls = get_ssl_wrapper_and_trainer(
            types.SimpleNamespace(**{k: objective == k for k in (
                "byol", "simsiam", "dino", "dinov2")}))
    wrapper = wrapper_cls(params)
    device = wrapper.device
    policy = wrapper.system_params.get("param_sharding") or "replicated"
    wrapper.system_params["param_sharding"] = "replicated"
    wrapper.instantiate(seed=seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0
    wrapper.fsdp_plan = shard_params(wrapper.model, wrapper.mesh, policy,
                                     pipeline=wrapper.pipeline_spec)
    if policy == "pp" and wrapper.pipeline_spec is not None:
        # the optimizer (and an SSL teacher) over the stage's tensors
        wrapper.init_optimization()
    if fault in ("sum_head", "skip_prep_sum"):
        _gradient_rule_fault(wrapper.model, fault)
    after = torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0
    trainer = trainer_cls(wrapper)
    mods = (steps_mod, byol_mod, dino_mod, d2_mod)
    saved = [m.reduce_gradients for m in mods]
    if fault == "skip_reduction" and wrapper.mesh.rank == 0:
        for m in mods:
            m.reduce_gradients = _skip_own_reduction
    losses, counts, grads, update_s = [], [], None, []
    stage_grads = None
    _reset_launches()
    loader = wrapper.dataloaders.trainloader
    loader.set_epoch(0)
    own = fault == "own_projection" and collectives.rank() == 0

    def one_update(i, batch):
        nonlocal grads, stage_grads
        collectives.reset_counts()
        t0 = time.perf_counter()
        if objective == "supervised":
            trainer.generator.manual_seed((trainer.seed << 32) + i)
            trainer.state, m = trainer.train_step(
                trainer.state, trainer._device_batch(batch),
                trainer.scheduler.lr(i), trainer.generator)
            m = {k: v for k, v in m.items() if k != "logits"}
        else:
            trainer.iters = i
            m, _ = trainer.train_one(batch, 0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        update_s.append(time.perf_counter() - t0)
        counts.append(dict(collectives.COUNTS))
        losses.append({k: float(v) for k, v in m.items()})
        if grads is None:
            named = [(n, p) for n, p in wrapper.model.named_parameters()
                     if p.requires_grad]
            grads = {n: p.grad.detach().float().cpu().clone()
                     for n, p in named if p.grad is not None}
            if wrapper.pipeline_spec is not None:
                # every stage's copy of what every stage holds (0 where
                # a stage has no gradient)
                stage_grads = {n: (p.grad.detach().float().cpu().clone()
                                   if p.grad is not None else
                                   torch.zeros(p.shape))
                               for n, p in named
                               if n not in wrapper.fsdp_plan}
    try:
        with _own_projection_partial() if own else \
                contextlib.nullcontext():
            for i, batch in zip(range(updates), loader):
                one_update(i, batch)
    finally:
        for m, f in zip(mods, saved):
            m.reduce_gradients = f
    launches = _by_rank(kernel_launches())
    frozen_bytes = _by_rank(resident_bytes(wrapper.model))
    mem = _by_rank((before, after))
    grads = whole_state(wrapper.model, grads)
    if stage_grads is not None:
        stage_grads = collectives.gather_objects(stage_grads,
                                                 collectives.MODEL)
    trainable = whole_state(wrapper.model, {
        n: p.detach().float().cpu() for n, p in
        wrapper.model.named_parameters() if p.requires_grad})
    if not collectives.is_rank0():
        return None
    return {"losses": losses, "grads": grads, "stage_grads": stage_grads,
            "trainable": {n: t.clone() for n, t in trainable.items()},
            "frozen_bytes": frozen_bytes, "allocated": mem,
            "trainable_bytes": sum(p.numel() * p.element_size()
                                   for p in wrapper.model.parameters()
                                   if p.requires_grad),
            "counts": counts, "plan": dict(wrapper.fsdp_plan),
            "launches": {k: sum(d[k] for d in launches)
                         for k in launches[0]},
            "update_s": update_s, "world": wrapper.mesh.world,
            "n_model": wrapper.mesh.n_model}


def sidecar_run(task: str, args: tuple, kwargs: dict) -> dict | None:
    """A side-car loop (`segdet.train_detection` for "det",
    `train_segmentation` for "seg") on this rank; rank 0 returns {"result",
    "launches" (the kernels' launches summed over ranks)}."""
    from .. import segdet
    _reset_launches()
    fn = segdet.train_detection if task == "det" \
        else segdet.train_segmentation
    result = fn(*args, **kwargs)
    launches = _by_rank(kernel_launches())
    if not collectives.is_rank0():
        return None
    return {"result": result,
            "launches": {k: sum(d[k] for d in launches)
                         for k in launches[0]}}


def sequence(calls, tag: str = "ranks") -> list | None:
    """The rank bodies `calls` ((name in this module, args, kwargs), ...)
    in turn in one group; rank 0 returns their results and prints each
    call's wall time under `tag`."""
    import time
    out = []
    for i, (name, args, kwargs) in enumerate(calls):
        t0 = time.perf_counter()
        out.append(globals()[name](*args, **kwargs))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        collectives.print_once(f"[{tag}] call {i} ({name}) "
                               f"{time.perf_counter() - t0:.1f} s")
    return out if collectives.is_rank0() else None
