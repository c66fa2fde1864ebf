"""Analytic FLOP model for the APLA ViT train step, and MFU accounting.

The port's own copy of `apla_tpu/utils/flops.py`.  Standard MFU convention
(PaLM appendix B): matmul FLOPs only (2·M·N·K per matmul), forward plus
backward, without rematerialisation recompute, so the MFU is the model's
useful-work share of the card's peak.

APLA trains only `partial_size` output channels of each block's attention
out-projection, so backward weight-gradient matmuls are counted only for
trainable weights: a frozen matmul's backward computes dX alone, a
trainable one's dX and dW.  Under APLA-k the out-projection contributes a
dW of [d, k]; every other weight is frozen and contributes none.  The
classifier head is always trainable.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

# Peak dense bf16 tensor-core throughput per card, by a substring of
# `torch.cuda.get_device_name()` (lower case, spaces removed).  Source:
# NVIDIA's H100 Tensor Core GPU datasheet: H100 SXM5 989.4 TFLOPS, H100
# PCIe 756 (both dense; the datasheet's 1,979 and 1,513 are with
# sparsity).  The card named "NVIDIA H100 80GB HBM3" is the SXM5 part.
# Override with APLA_PEAK_TFLOPS for other hardware.
_PEAK_TFLOPS_BF16 = {
    "h10080gbhbm3": 989.4,
    "h100sxm": 989.4,
    "h100pcie": 756.0,
    "cpu": 1.0,  # placeholder; MFU on the CPU is not meaningful
}


def peak_tflops(device_kind: str | None = None) -> float:
    """The card's peak dense bf16 TFLOPS (NaN for a kind not in the
    table); `device_kind` defaults to the first CUDA device's name."""
    env = os.environ.get("APLA_PEAK_TFLOPS")
    if env:
        return float(env)
    if device_kind is None:
        import torch
        device_kind = torch.cuda.get_device_name(0)
    kind = device_kind.lower().replace(" ", "")
    for key, val in _PEAK_TFLOPS_BF16.items():
        if key in kind:
            return val
    return float("nan")


def vit_train_step_flops(cfg: Any, n_classes: int, batch: int,
                         apla_k: Any = 128) -> Dict[str, float]:
    """Matmul FLOPs for one supervised APLA fine-tune step of `batch` images.

    cfg: ViTConfig-like (img_size, patch_size, embed_dim, depth, num_heads,
    mlp_ratio, use_swiglu, num_register_tokens, in_chans).
    apla_k: int rank, or "full" (whole [d,d] out-projection trainable), or 0
    (nothing trainable but the head — pure linear probe), or "finetune"
    (every weight trainable — the full fine-tune comparison point).
    Returns dict with fwd/bwd/total FLOPs (floats).
    """
    d = cfg.embed_dim
    L = cfg.depth
    p = cfg.patch_size
    n_patch = (cfg.img_size // p) ** 2
    n = n_patch + 1 + getattr(cfg, "num_register_tokens", 0)  # + cls
    hidden = getattr(cfg, "mlp_hidden", int(d * cfg.mlp_ratio))

    full_ft = apla_k == "finetune"
    probe = apla_k == 0  # head-only linear probe: no trunk backward at all

    def mm(m_, n_, k_, trainable=False, need_dx=True):
        """One weight matmul [m_,k_]x[k_,n_]: fwd, plus only the backward
        matmuls that run: dX when a consumer below needs a cotangent, dW
        when the weight is trainable."""
        f = 2.0 * m_ * n_ * k_
        b = (f if need_dx else 0.0) + (f if (trainable or full_ft) else 0.0)
        return f, b

    fwd = 0.0
    bwd = 0.0

    # patch embed: conv == matmul [n_patch, p*p*C] x [p*p*C, d].  Its input
    # is the DATA — dX is never computed (in any mode); dW only on full FT.
    f, b = mm(n_patch, d, p * p * cfg.in_chans, need_dx=False)
    fwd += f
    bwd += 0.0 if probe else b

    for i in range(L):
        # In the first block nothing below the attention out-projection is
        # trainable (unless full FT), so the qkv/scores/AV backward and the
        # projection's own dX do not run (autograd needs no cotangent
        # there).
        attn_bwd_live = (not probe) and (full_ft or i > 0)
        f, b = mm(n, 3 * d, d, need_dx=attn_bwd_live)       # qkv
        fwd += f
        bwd += b if attn_bwd_live else 0.0
        # attention scores + AV: activation-activation matmuls — backward
        # needs grads w.r.t. BOTH operands (2x fwd each) when live
        f_attn = 2.0 * n * n * d * 2      # QK^T and AV
        fwd += f_attn
        bwd += 2.0 * f_attn if attn_bwd_live else 0.0
        # out-projection: frozen [d, d-k] part + trainable [d, k] part
        if apla_k == "full" or full_ft:
            f, b = mm(n, d, d, trainable=True, need_dx=attn_bwd_live)
            fwd += f
            bwd += 0.0 if probe else b
        else:
            f = 2.0 * n * d * d           # fwd is one full matmul either way
            fwd += f
            if not probe:
                if attn_bwd_live:
                    bwd += f              # dX: full [d,d]
                k = int(apla_k)
                bwd += 2.0 * n * d * k    # dW_t: only the trainable columns
        # MLP: dX is live in every block (it carries the cotangent to the
        # attention-output residual that dW_t needs), dW only on full FT
        mlp_dx = not probe
        if getattr(cfg, "use_swiglu", False):
            f, b = mm(n, 2 * hidden, d, need_dx=mlp_dx)     # w12
            fwd += f; bwd += 0.0 if probe else b
            f, b = mm(n, d, hidden, need_dx=mlp_dx)         # w3
            fwd += f; bwd += 0.0 if probe else b
        else:
            f, b = mm(n, hidden, d, need_dx=mlp_dx)         # fc1
            fwd += f; bwd += 0.0 if probe else b
            f, b = mm(n, d, hidden, need_dx=mlp_dx)         # fc2
            fwd += f; bwd += 0.0 if probe else b

    # classifier head: always trainable; its dX feeds the trunk backward
    # except in probe mode
    f, b = mm(1, n_classes, d, trainable=True, need_dx=not probe)
    fwd += f
    bwd += b

    return {"fwd_flops": fwd * batch, "bwd_flops": bwd * batch,
            "total_flops": (fwd + bwd) * batch}


def mfu(img_per_sec: float, flops_per_image: float,
        device_kind: str | None = None) -> Dict[str, float]:
    """Model-FLOPs-utilisation given measured throughput.  Omits the
    peak-relative fields when the device kind is unknown (NaN would break
    the bench's one-line JSON contract)."""
    peak = peak_tflops(device_kind)
    achieved_tflops = img_per_sec * flops_per_image / 1e12
    out = {"model_tflops": round(achieved_tflops, 1)}
    if not math.isnan(peak):
        out["peak_tflops"] = peak
        out["mfu_pct"] = round(100.0 * achieved_tflops / peak, 1)
    return out
