"""Model configs from a recipe's params dict.

Counterpart of `apla_tpu/wrapper.py:DefaultWrapper.build_vit_config` and
`build_apla_config`, as plain functions of the merged params dict (what
`apla_tpu.utils.config.load_merged_params` returns, or an equivalent plain
dict).  The rest of the wrapper (data, optimizer, mesh) comes with training.
TPU-only knobs (`fused_vmem_mb`, `remat`) have no meaning here and are not
read.
"""

from __future__ import annotations

import torch

from .apla.core import AplaConfig
from .models.vit import VIT_BUILDERS, ViTConfig


def build_vit_config(params: dict) -> ViTConfig:
    mp = params["model_params"]
    tp = mp.get("transformers_params") or {}
    builder = VIT_BUILDERS[mp["backbone_type"]]
    block_conf = tp.get("block_conf") or {}
    img_size = tp.get("img_size", [224])
    img_size = img_size[0] if isinstance(img_size, (list, tuple)) else img_size
    use_mp = (params.get("training_params") or {}).get(
        "use_mixed_precision", True)
    return builder(
        img_size=int(img_size),
        patch_size=int(tp.get("patch_size", 16)),
        drop_rate=float(tp.get("drop_rate", 0.0)),
        attn_drop_rate=float(tp.get("attn_drop_rate", 0.0)),
        drop_path_rate=float(tp.get("drop_path_rate", 0.0)),
        has_layerscale=bool(block_conf.get("has_layerscale", False)),
        layerscale_init=float(block_conf.get("layerscale_init_values", 1e-5)),
        num_register_tokens=int(tp.get("num_register_tokens", 0)),
        compute_dtype=torch.bfloat16 if use_mp else torch.float32,
        use_flash=bool(tp.get("is_memory_efficient", False)),
        use_fused_apla=bool(tp.get("use_fused_apla", False)),
        gelu_tanh=bool(tp.get("gelu_tanh", False)),
    )


def build_apla_config(params: dict) -> AplaConfig | None:
    adaptation = params["model_params"].get("adaptation")
    if not adaptation or adaptation.get("mode") != "apla":
        return None
    p = adaptation.get("params") or {}
    return AplaConfig(partial_size=p.get("partial_size", 32),
                      inds_path=p.get("inds_path"),
                      seed=int(p.get("seed", 0)))
