"""Dense helper that may take an int8-quantized frozen kernel.

Counterpart of `apla_tpu/ops/quant.py:maybe_quantized_dot`.  Only the float
branch is ported: a `{'w_int8', 'scale'}` leaf (the W8A8 serving path) is not
yet supported.
"""

from __future__ import annotations

import torch


def maybe_quantized_dot(x, kernel_or_quant, bias=None):
    """x [..., d_in] @ kernel [d_in, d_out] in x.dtype, bias added in the
    result's dtype."""
    if isinstance(kernel_or_quant, dict) and "w_int8" in kernel_or_quant:
        raise NotImplementedError("W8A8 serving: ROADMAP B6")
    y = torch.matmul(x, kernel_or_quant.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
