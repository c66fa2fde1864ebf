"""Rank bodies for `parallel.launch`: a classifier trained for a few
updates on given global batches, as `tests/test_parallel.py` drives JAX's
data mesh, and the kernel-free probes of the collectives.  The CPU tests
and `chip_smoke.py` hold these runs at W ranks against the same run at one
rank (and the tests against JAX's 1-device step); they live in the port
because a spawned rank imports its body's module.
"""

from __future__ import annotations

import numpy as np
import torch

from . import collectives
from .mesh import make_mesh, pad_to_multiple, resident_bytes, shard_batch, \
    shard_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _by_rank(x) -> list:
    """Every rank's `x`, in rank order (a list of one without a group)."""
    out = collectives.host_allgather(x)
    return out if collectives.initialized() else [out]


def _skip_own_reduction(params) -> None:
    """The deliberate fault: this rank takes part in the gradients'
    all-reduce but keeps its own gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    collectives._all_reduce_(flat, "gradients")


def classifier_run(spec: dict) -> dict | None:
    """Train a classifier for `len(spec["batches"])` updates on this rank's
    rows of each global batch; rank 0 returns the run's record.

    `spec`: "vit" (ViTConfig keywords, "compute_dtype" by name), "state"
    ((trainable, frozen) name -> tensor maps) or "seed" with "n_classes"
    and "partial_size", "optimizer" (type, params), "grad_clip", "lr",
    "batches" (global {"image", "label"} numpy batches), "accum",
    "policy" ("replicated" | "fsdp"), "min_size" (the FSDP threshold),
    "device" (default: the rank's card, or the CPU), "seed" of the step
    draws, "fault": "skip_reduction": rank 0 (whose record comes back)
    keeps its own gradients.  Returns {"losses", "grad_norms", "trainable" (CPU
    tensors), "frozen_bytes" (a rank's resident frozen bytes, by rank),
    "trainable_bytes", "counts" (bytes by collective kind, per update),
    "plan" (the FSDP plan), "world"}."""
    from ..apla.core import AplaConfig
    from ..models.classifier import classifier_from_state, init_classifier
    from ..models.vit import ViTConfig
    from ..train import steps as steps_mod
    from ..train.losses import cross_entropy
    from ..train.optim import build_optimizer
    from ..train.train_state import TrainState

    device = torch.device(spec.get("device") or "cuda")
    mesh = make_mesh()
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
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0
    plan = shard_params(model, mesh, spec.get("policy", "replicated"),
                        min_size=int(spec.get("min_size", 2 ** 16)))
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
    if spec.get("fault") == "skip_reduction" and mesh.rank == 0:
        steps_mod.reduce_gradients = _skip_own_reduction
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
    frozen_bytes = _by_rank(resident_bytes(model))
    mem = _by_rank((before, after))
    t_bytes = sum(p.numel() * p.element_size() for _, p in named)
    if not collectives.is_rank0():
        return None
    return {"losses": losses, "grad_norms": norms,
            "trainable": {n: p.detach().cpu().clone() for n, p in named},
            "frozen_bytes": frozen_bytes, "allocated": mem,
            "trainable_bytes": t_bytes, "counts": counts, "plan": plan,
            "world": mesh.world}


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
    w = wrapper_cls(params)
    w.instantiate()
    mesh = w.mesh
    with torch.no_grad():
        w.model.load_state_dict(payload["model"], strict=True)
    state = w.state
    state.load_aux(payload["aux"])
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
        out.append(({k: p.detach().cpu().clone()
                     for k, p in state.trainable().items()},
                    {k: t.detach().cpu().clone()
                     for k, t in state.aux().items()},
                    {k: float(v) for k, v in m.items()}))
    return out if collectives.is_rank0() else None


def _counters() -> tuple:
    """The launch-counting wrappers of the kernels these paths run."""
    from ..ops import fused_apla_attn, fused_swin_attn, mha, proto_ce
    return (fused_apla_attn.fused_apla_attn_fwd,
            fused_apla_attn.fused_apla_attn_bwd, proto_ce.proto_ce_fwd,
            proto_ce.proto_ce_dxs, proto_ce.proto_ce_dws,
            fused_swin_attn.fused_swin_attn_fwd,
            fused_swin_attn.fused_swin_attn_bwd, mha.mha_fwd, mha.mha_bwd)


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
    gradients.
    Rank 0 returns {"losses" (per update: the metrics), "grads" (the
    reduced gradients of the first update), "trainable" (after the last),
    "frozen_bytes" and "allocated" (the frozen parameters' bytes and
    `torch.cuda.memory_allocated` before and after the placement, by
    rank), "counts" (bytes by collective kind, per update), "launches"
    (the kernels' launches summed over ranks), "world"}."""
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
    wrapper.fsdp_plan = shard_params(wrapper.model, wrapper.mesh, policy)
    after = torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0
    trainer = trainer_cls(wrapper)
    mods = (steps_mod, byol_mod, dino_mod, d2_mod)
    saved = [m.reduce_gradients for m in mods]
    if fault == "skip_reduction" and wrapper.mesh.rank == 0:
        for m in mods:
            m.reduce_gradients = _skip_own_reduction
    losses, counts, grads = [], [], None
    _reset_launches()
    loader = wrapper.dataloaders.trainloader
    loader.set_epoch(0)
    try:
        for i, batch in zip(range(updates), loader):
            collectives.reset_counts()
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
            counts.append(dict(collectives.COUNTS))
            losses.append({k: float(v) for k, v in m.items()})
            if grads is None:
                grads = {n: p.grad.detach().float().cpu().clone()
                         for n, p in wrapper.model.named_parameters()
                         if p.requires_grad and p.grad is not None}
    finally:
        for m, f in zip(mods, saved):
            m.reduce_gradients = f
    launches = _by_rank(kernel_launches())
    frozen_bytes = _by_rank(resident_bytes(wrapper.model))
    mem = _by_rank((before, after))
    if not collectives.is_rank0():
        return None
    return {"losses": losses, "grads": grads,
            "trainable": {n: p.detach().float().cpu().clone()
                          for n, p in wrapper.model.named_parameters()
                          if p.requires_grad},
            "frozen_bytes": frozen_bytes, "allocated": mem,
            "trainable_bytes": sum(p.numel() * p.element_size()
                                   for p in wrapper.model.parameters()
                                   if p.requires_grad),
            "counts": counts, "plan": dict(wrapper.fsdp_plan),
            "launches": {k: sum(d[k] for d in launches)
                         for k in launches[0]},
            "world": wrapper.mesh.world}


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


def sequence(calls) -> list | None:
    """The rank bodies `calls` ((name in this module, args, kwargs), ...)
    in turn in one group; rank 0 returns their results."""
    out = []
    for name, args, kwargs in calls:
        out.append(globals()[name](*args, **kwargs))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out if collectives.is_rank0() else None
