"""The DINO head.

Counterpart of `apla_tpu/ssl/heads.py:110-160`: MLP (exact GELU) ->
L2-norm -> weight-normalised linear onto the prototypes.  The parameters
keep the JAX layout and names (`mlp.{i}.kernel` [d_in, d_out], `mlp.{i}.
bias`, `last_v` [bottleneck, n_prototypes], `last_g` [n_prototypes]).  The
BYOL/SimSiam heads (BatchNorm MLPs) wait for their objectives (ROADMAP
queue A: BYOL/SimSiam/DINO v1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vit import Dense, trunc_normal


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
