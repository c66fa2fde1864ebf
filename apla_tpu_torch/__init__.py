"""apla_tpu_torch — the PyTorch/CUDA port of apla_tpu for NVIDIA Hopper.

Mirrors `apla_tpu/`'s layout (`apla_tpu/X/y.py` -> `apla_tpu_torch/X/y.py`)
with PyTorch idiom inside: `nn.Module`s holding per-block parameters in an
`nn.ModuleList`, plain functions on tensors, an explicit `device` everywhere.
Public functions keep the JAX package's layouts (kernels `[d_in, d_out]`,
APLA `inds` index output columns, images NHWC) so the two packages can be
held against each other.  The JAX package is the reference; this package
imports `torch` and never `jax`.

Every Pallas kernel on a ported path has a hand-written Hopper kernel under
`csrc/`, built with `nvcc` at first CUDA use (`ops/cuda_build.py`).
"""

__version__ = "0.1.0"
