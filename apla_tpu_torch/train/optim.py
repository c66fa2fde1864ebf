"""Optimizer construction over the trainable parameters only.

Counterpart of `apla_tpu/train/optim.py`.  Two param groups carry the JAX
`wd_mask` rule: leaves named `bias`, `proj_bt`, `scale` or `gamma` are not
decayed, any other leaf is decayed if it has two or more dimensions.  The
updates are `torch.optim`'s, each the same update as the JAX package's optax
chain:

- AdamW: decoupled decay (optax.adamw with the mask);
- Adam: decay coupled into the gradient (add_decayed_weights + adam);
- SGD: coupled decay, momentum as a trace, optional Nesterov;
- RMSprop: coupled decay, eps outside the sqrt, the momentum buffer taking
  the unscaled updates and lr applied last (torch's RMSprop is exactly that
  chain);
- LAMB (`Lamb`, written here: torch has none): optax.lamb's chain, Adam
  moments with eps outside the sqrt, decoupled decay under the mask, then
  each JAX leaf's trust ratio |p| / |u| (1 where either norm is 0), then
  lr.  The JAX ViT stacks its blocks into one leaf per parameter
  ([depth, ...]); the port keeps a tensor per block, so the ratio is taken
  over the blocks' tensors together (`jax_leaves`).  Under a pipeline's
  "pp" placement a stage holds its blocks' tensors only, so a
  block-stacked leaf's norms are sums of squares over the model group.

`grad_norm` is optax's global norm of the trainable gradients: a tensor
that a pipeline stage alone holds counts once over the model group, every
other one once in total.  Clipping is optax's `clip_by_global_norm`
(`(g / norm) * max` once the norm reaches `max`, no epsilon;
`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm).  `set_lr` writes the lr (and optionally wd) into the param groups
before each step, as the JAX package injects them as hyperparameters.
"""

from __future__ import annotations

import re

import torch

from ..parallel import collectives

_NO_WD_NAMES = frozenset({"bias", "proj_bt", "scale", "gamma"})


def decays(name: str, p: torch.Tensor) -> bool:
    """The JAX `wd_mask` rule for one named parameter."""
    if name.rsplit(".", 1)[-1] in _NO_WD_NAMES:
        return False
    return p.dim() >= 2


def _sq(tensors) -> torch.Tensor:
    return sum(torch.sum(t.float() * t.float()) for t in tensors)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.sqrt(_sq(grads))


def grad_norm(params) -> torch.Tensor:
    """The global norm of the gradients of `params` (those that have
    one): the squares of the stage-held ones (`collectives.
    is_stage_owned`) summed over the model group."""
    grads = [p for p in params if p.grad is not None]
    own = [p.grad for p in grads if collectives.is_stage_owned(p)]
    sq = _sq([p.grad for p in grads if not collectives.is_stage_owned(p)])
    if own:
        sq = sq + collectives.psum(_sq(own), collectives.MODEL)
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def clip_by_global_norm_(grads, max_norm: float, g_norm: torch.Tensor):
    """In place, optax's rule: unchanged while g_norm < max_norm, else each
    g becomes (g / g_norm) * max_norm.  No host sync."""
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm))


_BLOCK = re.compile(r"(^|\.)blocks\.\d+\.")


def jax_leaves(named_params):
    """The parameters grouped as the JAX trees' leaves: a ViT block's
    tensors join their block-stacked leaf (`blocks.{i}.attn.proj_wt` of
    every i: one leaf `blocks.proj_wt`), any other tensor is its own leaf
    (the Swin's blocks are lists in JAX, so `stages.*` tensors stay
    apart)."""
    leaves: dict = {}
    for name, p in named_params:
        key = name if ".stages." in f".{name}" else _BLOCK.sub(r"\1blocks.",
                                                              name)
        leaves.setdefault(key, []).append(p)
    return list(leaves.values())


class Lamb(torch.optim.Optimizer):
    """optax.lamb(lr, b1, b2, eps, weight_decay, mask) over param groups
    carrying `weight_decay` (0 for the not-decayed group): per tensor the
    bias-corrected Adam direction m_hat / (sqrt(v_hat) + eps), plus wd * p;
    then per leaf of `leaves` (lists of parameters) the update is scaled by
    |p| / |u| over the leaf's tensors, 1 where either norm is 0, and
    p -= lr * u."""

    def __init__(self, params, lr, betas, eps, leaves):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=0.0))
        self.leaves = leaves

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        updates, lrs = {}, {}
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                g = p.grad
                mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
                nu = state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu / (1 - b1 ** t)) / (
                    (nu / (1 - b2 ** t)).sqrt() + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                updates[p], lrs[p] = u, group["lr"]
        leaves = [[p for p in leaf if p in updates] for leaf in self.leaves]
        leaves = [leaf for leaf in leaves if leaf]
        sq = [torch.stack([_sq(leaf), _sq(updates[p] for p in leaf)])
              for leaf in leaves]
        # a stage-held leaf spans the model group's stages
        staged = [i for i, leaf in enumerate(leaves)
                  if collectives.is_stage_owned(leaf[0])]
        if staged:
            summed = collectives.psum(torch.stack([sq[i] for i in staged]),
                                      collectives.MODEL)
            for j, i in enumerate(staged):
                sq[i] = summed[j]
        for leaf, (p_sq, u_sq) in zip(leaves, sq):
            p_norm, u_norm = torch.sqrt(p_sq), torch.sqrt(u_sq)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            for p in leaf:
                p.sub_(lrs[p] * (updates[p] * ratio.to(p.dtype)))


class Optimizer:
    """A `torch.optim` optimizer over the decayed and the not-decayed group,
    with the global-norm clip and the injected lr / wd."""

    def __init__(self, opt: torch.optim.Optimizer, grad_clip: float | None):
        self.opt = opt
        self.grad_clip = float(grad_clip) if grad_clip else None

    @property
    def params(self):
        return [p for group in self.opt.param_groups for p in group["params"]]

    def set_lr(self, lr: float, wd: float | None = None) -> None:
        for group in self.opt.param_groups:
            group["lr"] = float(lr)
            if wd is not None and group["decay"]:
                group["weight_decay"] = float(wd)

    def get_lr(self) -> float:
        return self.opt.param_groups[0]["lr"]

    def step(self, g_norm: torch.Tensor) -> None:
        """Clip the gradients held in `.grad` (by `g_norm`, their global
        norm) and apply one update."""
        if self.grad_clip:
            clip_by_global_norm_([p.grad for p in self.params
                                  if p.grad is not None],
                                 self.grad_clip, g_norm)
        self.opt.step()

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)


def build_optimizer(opt_type: str, opt_params: dict, named_params,
                    grad_clip: float | None = None) -> Optimizer:
    """`opt_type` in 'AdamW', 'Adam', 'SGD', 'RMSprop', 'LAMB' over
    `named_params` ((name, parameter) pairs, the trainable ones);
    `opt_params` follows the YAML schema ({'lr', 'weight_decay',
    betas/eps/momentum/alpha/nesterov})."""
    opt_params = dict(opt_params)
    lr = float(opt_params.pop("lr", 1e-3))
    wd = float(opt_params.pop("weight_decay", 0.0))
    betas = tuple(opt_params.pop("betas", (0.9, 0.999)))
    eps = float(opt_params.pop("eps", 1e-8))
    momentum = float(opt_params.pop("momentum", 0.0))
    alpha = float(opt_params.pop("alpha", 0.99))
    nesterov = bool(opt_params.pop("nesterov", False))
    named_params = list(named_params)
    groups = [
        {"params": [p for n, p in named_params if decays(n, p)],
         "weight_decay": wd, "decay": True},
        {"params": [p for n, p in named_params if not decays(n, p)],
         "weight_decay": 0.0, "decay": False},
    ]
    groups = [g for g in groups if g["params"]]
    if opt_type == "AdamW":
        opt = torch.optim.AdamW(groups, lr=lr, betas=betas, eps=eps)
    elif opt_type == "Adam":
        opt = torch.optim.Adam(groups, lr=lr, betas=betas, eps=eps)
    elif opt_type == "SGD":
        opt = torch.optim.SGD(groups, lr=lr, momentum=momentum,
                              nesterov=nesterov)
    elif opt_type == "RMSprop":
        opt = torch.optim.RMSprop(groups, lr=lr, alpha=alpha, eps=eps,
                                  momentum=momentum)
    elif opt_type == "LAMB":
        opt = Lamb(groups, lr=lr, betas=betas, eps=eps,
                   leaves=jax_leaves(named_params))
    else:
        raise NotImplementedError(f"optimizer {opt_type}")
    return Optimizer(opt, grad_clip)
