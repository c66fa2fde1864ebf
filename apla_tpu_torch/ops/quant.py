"""Int8 quantization of FROZEN weights: the W8A8 dense path.

Counterpart of `apla_tpu/ops/quant.py`.  APLA freezes almost the whole
backbone, so its large kernels (qkv, fc1, fc2; w12, w3 under SwiGLU) can be
quantized once, at export: symmetric per-output-channel int8 weights, and
activations quantized per row at every call.  The APLA slices, the
projections and the heads stay float.

A quantized kernel is a `QuantizedKernel` module in the place of the float
`kernel` parameter (`blocks.{i}.mlp.fc1.kernel`), holding the JAX quant
dict's leaves as buffers, `w_int8` [d_in, d_out] and `scale` [d_out], so a
state's names are the JAX tree's flattened (`...fc1.kernel.w_int8`).  Beside
them it keeps `w_kmajor`, the int8 weight transposed to [d_out, d_in] once
(the int8 kernel reads B K-major); no checkpoint stores it.

`int8_matmul` is the JAX custom VJP as an autograd `Function`: its forward
is `ops.int8_matmul.fused_int8_matmul` with one group over the whole K (the
hand-written kernel on a card, its plain version on the CPU), which also
adds a frozen bias after the rounding, as `maybe_quantized_dot` would; its
backward is the JAX package's, dx = g @ dequant(W)^T in g's dtype, a plain
product.
"""

from __future__ import annotations

import torch
from torch import nn

from .int8_matmul import fused_int8_matmul, scale_of

# the kernels `quantize_frozen_backbone` quantizes by default, by name
QUANTIZABLE = ("qkv", "fc1", "fc2", "w12", "w3")


def quantize_weight(w):
    """w [d_in, d_out] float -> (w_int8 [d_in, d_out], scale [d_out] f32),
    symmetric per output channel."""
    wf = w.float()
    scale = scale_of(wf.abs().amax(dim=0, keepdim=True))
    w_i8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_i8, scale.reshape(-1)


def dequantize_weight(w_i8, scale):
    return w_i8.float() * scale[None, :]


def _quantize_rows(x):
    """x [..., d] float -> (x_int8, row_scale [..., 1] f32)."""
    xf = x.float()
    scale = scale_of(xf.abs().amax(dim=-1, keepdim=True))
    x_i8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_i8, scale


class QuantizedKernel(nn.Module):
    """An int8 frozen kernel: buffers `w_int8` [d_in, d_out], `scale`
    [d_out] f32 (saved) and `w_kmajor` [d_out, d_in] (made here and after
    every state load, never per call).  Under FSDP `w_int8` and `scale`
    are leaves sharded by JAX's rule and `w_kmajor` follows `w_int8` on
    the transposed dim (`parallel.mesh.fsdp_plan`); on a model axis all
    three stay whole (`parallel.tensor`)."""

    def __init__(self, w_int8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("w_int8", w_int8)
        self.register_buffer("scale", scale)
        self.register_buffer("w_kmajor", w_int8.t().contiguous(),
                             persistent=False)

    @classmethod
    def empty(cls, d_in: int, d_out: int) -> "QuantizedKernel":
        return cls(torch.zeros((d_in, d_out), dtype=torch.int8),
                   torch.ones((d_out,)))

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        with torch.no_grad():
            self.w_kmajor.copy_(self.w_int8.t())


class Int8Matmul(torch.autograd.Function):
    """`apla_tpu/ops/quant.py:int8_matmul`'s custom VJP: the gradient
    reaches x only (the weight is frozen by construction)."""

    @staticmethod
    def forward(ctx, x, w_i8, w_scale, w_kmajor, bias):
        ctx.save_for_backward(w_i8, w_scale)
        ctx.x_dtype = x.dtype
        K = x.shape[-1]
        y = fused_int8_matmul(x.reshape(-1, K).contiguous(), w_i8, w_scale,
                              group=K, w_kmajor=w_kmajor, bias=bias)
        return y.reshape(*x.shape[:-1], w_i8.shape[1])

    @staticmethod
    def backward(ctx, g):
        w_i8, w_scale = ctx.saved_tensors
        # dx = g @ W^T with W dequantized, exact w.r.t. the forward's weights
        w = w_i8.to(g.dtype) * w_scale[None, :].to(g.dtype)
        return torch.matmul(g, w.t()).to(ctx.x_dtype), None, None, None, None


def int8_matmul(x, w_i8, w_scale, w_kmajor=None, bias=None):
    """y = dequant(quant_rows(x)) @ dequant(w): x [..., d_in] bf16/f32,
    w_i8 [d_in, d_out], w_scale [d_out] -> [..., d_out] in x.dtype, plus
    `bias` [d_out] rounded to x.dtype, if given, after the rounding (a
    frozen bias: no gradient reaches it).  `w_kmajor` ([d_out, d_in],
    `QuantizedKernel.w_kmajor`) is what the kernel reads on a card."""
    if bias is not None and bias.requires_grad:
        raise ValueError("int8_matmul adds a frozen bias only")
    return Int8Matmul.apply(x, w_i8, w_scale, w_kmajor, bias)


def maybe_quantized_dot(x, kernel_or_quant, bias=None):
    """x [..., d_in] @ kernel [d_in, d_out] in x.dtype: a float kernel
    through `torch.matmul`, a `QuantizedKernel` through `int8_matmul`.  The
    bias is added in the result's dtype: by the int8 kernel's epilogue when
    it is frozen (`requires_grad` False, as in every W8A8 artifact), else
    after the product."""
    if isinstance(kernel_or_quant, QuantizedKernel):
        fused = bias is not None and not bias.requires_grad
        y = int8_matmul(x, kernel_or_quant.w_int8, kernel_or_quant.scale,
                        kernel_or_quant.w_kmajor, bias if fused else None)
        if fused:
            return y
    else:
        y = torch.matmul(x, kernel_or_quant.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _set_kernel(dense, quantized: QuantizedKernel) -> None:
    """`dense.kernel`, a parameter, replaced by the module `quantized`."""
    del dense.kernel
    dense.kernel = quantized


def _candidates(model, which=QUANTIZABLE):
    """The `Dense`s of the quantizable kernels of a ViT or Swin backbone
    (`model` itself or its `backbone`), the layouts
    `apla_tpu/ops/quant.py:quantize_frozen_backbone` walks."""
    bb = getattr(model, "backbone", model)
    if hasattr(bb, "blocks"):                       # ViT
        blocks = list(bb.blocks)
        names = which
    elif hasattr(bb, "stages"):                     # Swin
        blocks = [blk for stage in bb.stages for blk in stage.blocks]
        names = [n for n in which if n in ("qkv", "fc1", "fc2")]
    else:
        return []
    out = []
    for blk in blocks:
        for name in names:
            owner = blk.attn if name == "qkv" else blk.mlp
            dense = getattr(owner, name, None)
            if dense is not None:
                out.append(dense)
    return out


def is_quantized(model) -> bool:
    """True if any quantizable kernel of the ViT or Swin backbone is already
    int8 (callers use it to avoid quantizing twice)."""
    return any(isinstance(d.kernel, QuantizedKernel)
               for d in _candidates(model))


@torch.no_grad()
def quantize_frozen_backbone(model, which=QUANTIZABLE):
    """Quantize the frozen large kernels of a ViT or Swin backbone in
    place (`model` a bare backbone or a classifier, segmenter or detector
    holding one as `backbone`): the qkv / mlp kernels named in `which`
    become `QuantizedKernel`s.  Trainable kernels (a full fine-tune) stay
    float, as they are absent from JAX's frozen tree; so do the projections
    (the APLA scatter writes trainable columns into them, and the
    segmenter's "full" projection trains in place), LayerNorms, biases and
    embeddings.  Returns `model`."""
    for dense in _candidates(model, which):
        k = dense.kernel
        if isinstance(k, QuantizedKernel) or k.requires_grad:
            continue
        _set_kernel(dense, QuantizedKernel(*quantize_weight(k.detach())))
    return model


def quantize_like_state(model, state: dict):
    """Give `model` a `QuantizedKernel` at every float kernel whose int8
    weight the state names (`<dense>.kernel.w_int8`), on the device of the
    kernel it replaces, so that the state loads (a W8A8 checkpoint into a
    float model).  In place; returns `model`."""
    suffix = ".kernel.w_int8"
    for name, w in state.items():
        if name.endswith(suffix):
            dense = model.get_submodule(name[:-len(suffix)])
            if not isinstance(dense.kernel, QuantizedKernel):
                _set_kernel(dense, QuantizedKernel.empty(*w.shape).to(
                    dense.kernel.device))
    return model
