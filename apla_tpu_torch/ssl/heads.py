"""SSL projection and prediction heads.

Counterpart of `apla_tpu/ssl/heads.py`:

- the BYOL/SimSiam heads (`:20-107`): [Linear-BN-ReLU] x (n - 1) ->
  Linear-BN projection and the Linear-BN-ReLU-Linear predictor.  The
  BatchNorm is the JAX package's own (`batch_norm`): statistics in f32, the
  running stats updated with the biased variance and `momentum` weighting
  the OLD stats, which `F.batch_norm` does not do (it takes the unbiased
  variance and weights the new value).  The running stats are not module
  state: they are a nested dict ({'bn0': {'mean', 'var'}, ...}) threaded
  through the forward as in JAX, so one set of modules serves the student
  and, with the teacher's tensors swapped in, the teacher with its own
  stats.  The products run in x's dtype.
- the DINO head (`:110-160`): MLP (exact GELU) -> L2-norm ->
  weight-normalised linear onto the prototypes.

The parameters keep the JAX layout and names (`fc{i}.kernel` [d_in, d_out],
`fc{i}.bias`, `bn{i}.scale`, `bn{i}.bias`; `mlp.{i}.kernel`, `last_v`
[bottleneck, n_prototypes], `last_g` [n_prototypes]).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vit import Dense, trunc_normal
from ..parallel.collectives import data_size, psum_grad


# --------------------------------------------------------------------------- #
# BatchNorm and the BYOL / SimSiam heads
# --------------------------------------------------------------------------- #

class BatchNorm(nn.Module):
    """The affine part of a BatchNorm: `scale` and `bias` [dim]."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


@torch.no_grad()
def _linear(d_in: int, d_out: int, generator: torch.Generator,
            bias: bool = True) -> Dense:
    """A Dense with a truncated-normal (std 0.02) kernel and zero bias."""
    layer = Dense(d_in, d_out, bias=bias)
    layer.kernel.copy_(trunc_normal((d_in, d_out), generator))
    return layer


def _bn_init(dim: int):
    """(BatchNorm module, its running stats {'mean': 0, 'var': 1})."""
    return BatchNorm(dim), {"mean": torch.zeros(dim),
                            "var": torch.ones(dim)}


def batch_norm(x, bn: BatchNorm, state: dict, train: bool,
               momentum: float = 0.9, eps: float = 1e-5):
    """(y, new_state) for x [B, D].  In f32, cast back to x's dtype.  In
    training the batch statistics normalise (gradients flow through them)
    and the running stats become momentum * old + (1 - momentum) * batch,
    with the biased variance; in eval the running stats normalise.  With
    more than one data rank the batch is the global one: the data group's
    counts, means and M2 combine through all-reduces that gradients flow
    through (`parallel.collectives.psum_grad`), as JAX's statistics run
    over the data-sharded batch (the ranks of a model group hold the same
    rows, so the world group would count each row T times)."""
    xf = x.float()
    if train:
        w = data_size()
        if w > 1:
            m_r = xf.mean(dim=0)
            mean = psum_grad(m_r) / w       # every rank holds as many rows
            m2 = psum_grad(((xf - m_r) ** 2).sum(dim=0)
                           + xf.shape[0] * (m_r - mean) ** 2)
            var = m2 / (xf.shape[0] * w)
        else:
            mean = xf.mean(dim=0)
            var = xf.var(dim=0, unbiased=False)
        new_state = {
            "mean": (momentum * state["mean"]
                     + (1 - momentum) * mean).detach(),
            "var": (momentum * state["var"]
                    + (1 - momentum) * var).detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * bn.scale.float() + bn.bias.float()
    return y.to(x.dtype), new_state


def _dense(x, layer: Dense):
    return torch.matmul(x, layer.kernel.to(x.dtype)) + layer.bias.to(x.dtype)


class BYOLHead(nn.Module):
    """`fc{i}` and `bn{i}` for i < num_layers."""

    def __init__(self, in_size: int, out_size: int, hidden_size: int = 4096,
                 num_layers: int = 2):
        super().__init__()
        if not 1 < num_layers < 4:
            raise ValueError(f"num_layers {num_layers}: 2 or 3")
        dims = [in_size] + [hidden_size] * (num_layers - 1) + [out_size]
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", Dense(dims[i], dims[i + 1]))
            self.add_module(f"bn{i}", BatchNorm(dims[i + 1]))


@torch.no_grad()
def init_byol_head(in_size: int, out_size: int, hidden_size: int = 4096,
                   num_layers: int = 2, *, generator: torch.Generator):
    """(BYOLHead, running stats {'bn{i}': {'mean', 'var'}}) by the JAX init
    rule; `generator` is a CPU generator."""
    head = BYOLHead(in_size, out_size, hidden_size, num_layers)
    state = {}
    for i in range(num_layers):
        fc = getattr(head, f"fc{i}")
        setattr(head, f"fc{i}", _linear(*fc.kernel.shape, generator))
        bn, state[f"bn{i}"] = _bn_init(fc.kernel.shape[1])
        setattr(head, f"bn{i}", bn)
    return head, state


def byol_head_forward(x, head: BYOLHead, state: dict, train: bool):
    """[B, in] -> ([B, out] in x's dtype, new running stats)."""
    n = head.num_layers
    new_state = dict(state)
    for i in range(n):
        x = _dense(x, getattr(head, f"fc{i}"))
        x, new_state[f"bn{i}"] = batch_norm(x, getattr(head, f"bn{i}"),
                                            state[f"bn{i}"], train)
        if i < n - 1:
            x = F.relu(x)
    return x, new_state


class PredictionMLP(nn.Module):
    """`fc0`, `bn0`, `fc1`."""

    def __init__(self, in_size: int, out_size: int, hidden_size: int = 4096):
        super().__init__()
        self.fc0 = Dense(in_size, hidden_size)
        self.bn0 = BatchNorm(hidden_size)
        self.fc1 = Dense(hidden_size, out_size)


@torch.no_grad()
def init_prediction_mlp(in_size: int, out_size: int, hidden_size: int = 4096,
                        *, generator: torch.Generator):
    """(PredictionMLP, running stats {'bn0': ...}) by the JAX init rule."""
    mlp = PredictionMLP(in_size, out_size, hidden_size)
    mlp.fc0 = _linear(in_size, hidden_size, generator)
    mlp.fc1 = _linear(hidden_size, out_size, generator)
    mlp.bn0, stats = _bn_init(hidden_size)
    return mlp, {"bn0": stats}


def prediction_mlp_forward(x, mlp: PredictionMLP, state: dict, train: bool):
    x = _dense(x, mlp.fc0)
    x, bn_s = batch_norm(x, mlp.bn0, state["bn0"], train)
    x = _dense(F.relu(x), mlp.fc1)
    return x, {"bn0": bn_s}


# --------------------------------------------------------------------------- #
# DINO head
# --------------------------------------------------------------------------- #

class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, nlayers: int = 3,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256):
        super().__init__()
        dims = ([in_dim, bottleneck_dim] if nlayers == 1
                else [in_dim] + [hidden_dim] * (nlayers - 1)
                + [bottleneck_dim])
        self.mlp = nn.ModuleList(Dense(dims[i], dims[i + 1])
                                 for i in range(len(dims) - 1))
        self.last_v = nn.Parameter(torch.zeros(bottleneck_dim, out_dim))
        self.last_g = nn.Parameter(torch.ones(out_dim))


@torch.no_grad()
def init_dino_head(in_dim: int, out_dim: int, nlayers: int = 3,
                   hidden_dim: int = 2048, bottleneck_dim: int = 256, *,
                   generator: torch.Generator) -> DINOHead:
    """The JAX init rule: truncated-normal (std 0.02) kernels and `last_v`,
    zero biases, `last_g` at 1.  `generator` is a CPU generator."""
    head = DINOHead(in_dim, out_dim, nlayers, hidden_dim, bottleneck_dim)
    for layer in head.mlp:
        layer.kernel.copy_(trunc_normal(tuple(layer.kernel.shape), generator))
    head.last_v.copy_(trunc_normal(tuple(head.last_v.shape), generator))
    return head


def dino_head_bottleneck(x, head: DINOHead):
    """MLP + L2-norm: [*, in_dim] -> [*, bottleneck] f32 unit rows.  The MLP
    runs in x's dtype."""
    n = len(head.mlp)
    for i, layer in enumerate(head.mlp):
        x = torch.matmul(x, layer.kernel.to(x.dtype)) + layer.bias.to(x.dtype)
        if i < n - 1:
            x = F.gelu(x, approximate="none")
    x = x.float()
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def dino_head_last_w(head: DINOHead, norm_last_layer: bool = True):
    """The weight-normalised prototype layer [bottleneck, out_dim] f32:
    g * v / ||v||_col; with `norm_last_layer` the magnitude g is a constant
    (detached)."""
    v = head.last_v.float()
    v = v / (torch.linalg.vector_norm(v, dim=0, keepdim=True) + 1e-12)
    g = head.last_g.float()
    if norm_last_layer:
        g = g.detach()
    return v * g


def dino_head_forward(x, head: DINOHead, norm_last_layer: bool = True,
                      matmul_bf16: bool = False):
    """[*, in_dim] -> prototype logits [*, out_dim] f32.  `matmul_bf16`:
    the prototype product takes bf16-rounded inputs (f32 products)."""
    x = dino_head_bottleneck(x, head)
    w = dino_head_last_w(head, norm_last_layer)
    if matmul_bf16:
        return torch.matmul(x.to(torch.bfloat16).float(),
                            w.to(torch.bfloat16).float())
    return torch.matmul(x, w)
