"""APLA partial-trainable output projection.

Counterpart of `apla_tpu/ops/apla_proj.py`.  Weights keep the JAX layout:
kernel `[d_in, d_out]`, and `inds` ([k], int64) index the trainable OUTPUT
columns, so `W = W_frozen` with `W_t` written into columns `inds`, then
`out = x @ W + b`.

`AplaProj` is the JAX custom VJP as an autograd `Function`: dx = g W^T,
dW_t = x^T g[..., inds] and db_t = sum g[..., inds] in float32; the frozen
matrix gets no gradient, so the `[d, d]` weight gradient is never formed.
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


class AplaProj(torch.autograd.Function):
    """`apla_tpu/ops/apla_proj.py:56-80` as an autograd `Function`.
    `partial`: a row-parallel share (`parallel.tensor`): x [..., K] by the
    rows [K, d_out] of the projection, the product in f32 without the
    bias (the caller sums the ranks' partials, rounds once and adds the
    assembled bias); dx and dW_t as above, no db_t."""

    @staticmethod
    def forward(ctx, x, w_t, b_t, w_frozen, b_frozen, inds, partial=False):
        w, b = assemble(w_t, b_t, w_frozen, b_frozen, inds)
        ctx.save_for_backward(x, w, inds)
        ctx.dtypes = (w_t.dtype, b_t.dtype)
        ctx.partial = partial
        if partial:
            return torch.matmul(x.float(), w.to(x.dtype).float())
        return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, inds = ctx.saved_tensors
        wt_dtype, bt_dtype = ctx.dtypes
        g = g.to(x.dtype)
        dx = torch.matmul(g, w.to(g.dtype).t())
        g2 = g.index_select(-1, inds).reshape(-1, inds.numel()).float()
        x2 = x.reshape(-1, x.shape[-1]).float()
        dw_t = torch.matmul(x2.t(), g2).to(wt_dtype)
        db_t = None if ctx.partial else g2.sum(dim=0).to(bt_dtype)
        return dx, dw_t, db_t, None, None, None, None


def apla_proj(x, w_t, b_t, w_frozen, b_frozen, inds, partial=False):
    """[..., d_in] -> [..., d_out] in x.dtype (bias added in x.dtype).
    Differentiable in (x, w_t, b_t).  `partial`: see `AplaProj`."""
    return AplaProj.apply(x, w_t, b_t, w_frozen, b_frozen, inds, partial)
