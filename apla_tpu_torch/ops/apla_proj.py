"""APLA partial-trainable output projection, forward only.

Counterpart of `apla_tpu/ops/apla_proj.py`.  Weights keep the JAX layout:
kernel `[d_in, d_out]`, and `inds` ([k], int64) index the trainable OUTPUT
columns, so `W = W_frozen` with `W_t` written into columns `inds`, then
`out = x @ W + b`.  The autograd `Function` (dW_t = x^T g[..., inds], no
gradient for the frozen matrix) comes with the training slice.
"""

from __future__ import annotations

import torch


def assemble(w_t: torch.Tensor, b_t: torch.Tensor, w_frozen: torch.Tensor,
             b_frozen: torch.Tensor, inds: torch.Tensor):
    """Full kernel [d_in, d_out] and bias [d_out] with the trainable columns
    (and bias entries) written in at `inds`."""
    w = w_frozen.index_copy(1, inds, w_t.to(w_frozen.dtype))
    b = b_frozen.index_copy(0, inds, b_t.to(b_frozen.dtype))
    return w, b


def apla_proj(x, w_t, b_t, w_frozen, b_frozen, inds):
    """[..., d_in] -> [..., d_out] in x.dtype (bias added in x.dtype)."""
    w, b = assemble(w_t, b_t, w_frozen, b_frozen, inds)
    return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)
