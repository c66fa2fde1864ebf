"""APLA parameter surgery on the port's modules.

Counterpart of `apla_tpu/apla/core.py`.  The JAX package partitions a
pytree into (trainable, frozen); here the partition is each parameter's
`requires_grad`.  `build_apla` freezes the whole ViT and gives every block's
`Attention` module

  proj_wt [d, k], proj_bt [k]   trainable parameters, copied out of the
                                projection's columns `inds`
  inds    [k] int64             a buffer (output-column indices)

while `proj.kernel` / `proj.bias` stay as frozen parameters whose columns
`inds` are shadowed by the trainable copies at forward time.
`partial_size == "full"` makes the whole projection trainable instead.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AplaConfig:
    # int rank, or "full" for whole-projection training
    partial_size: Any = 32
    # optional path to a JSON of pre-defined trainable indices per block
    inds_path: Optional[str] = None
    seed: int = 0


def load_indices(inds_path: str, depth: int, dim: int) -> np.ndarray:
    """Per-block trainable indices from the reference's JSON format
    ({'block_0': [...], ...}).  Returns int32 [depth, k]."""
    with open(inds_path) as f:
        inds_dict = json.load(f)
    rows = []
    for i in range(depth):
        row = inds_dict[f"block_{i}"]
        if max(row) >= dim:
            raise ValueError(f"index {max(row)} out of range for dim {dim}")
        rows.append(row)
    k = len(rows[0])
    if any(len(r) != k for r in rows):
        raise ValueError("ragged per-block index lists")
    return np.asarray(rows, dtype=np.int32)


def sample_indices(seed: int, depth: int, dim: int, k: int) -> np.ndarray:
    """k distinct output channels per block, drawn with numpy exactly as
    the JAX package draws them (same seed -> same indices)."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.permutation(dim)[:k].astype(np.int32) for _ in range(depth)])


def resolve_indices(apla_cfg: AplaConfig, depth: int, dim: int) -> np.ndarray:
    """The [depth, k] index table an `AplaConfig` asks for."""
    k = int(apla_cfg.partial_size)
    if apla_cfg.inds_path:
        inds = load_indices(apla_cfg.inds_path, depth, dim)
        if inds.shape[1] < k:
            raise ValueError(
                f"inds file provides {inds.shape[1]} indices, need {k}")
        return inds[:, :k]
    return sample_indices(apla_cfg.seed, depth, dim, k)


def build_apla(vit: torch.nn.Module, apla_cfg: AplaConfig):
    """Freeze `vit` (a `models.vit.ViT`) and make each block's projection
    partially trainable per `apla_cfg`.  Modifies and returns `vit`."""
    for p in vit.parameters():
        p.requires_grad_(False)
    if apla_cfg.partial_size == "full":
        for blk in vit.blocks:
            for p in blk.attn.proj.parameters():
                p.requires_grad_(True)
        return vit
    inds = resolve_indices(apla_cfg, len(vit.blocks), vit.cfg.embed_dim)
    for blk, row in zip(vit.blocks, inds):
        blk.attn.add_apla(torch.as_tensor(row, dtype=torch.int64))
    return vit


def merge_apla_params(state: dict) -> dict:
    """A plain ViT/classifier state (name -> tensor) from an APLA one: each
    block's `proj_wt`/`proj_bt` written into `proj.kernel`/`proj.bias` at
    `inds`, and the APLA entries dropped (export / checkpoint interop)."""
    out = dict(state)
    for name in [n for n in state if n.endswith("attn.inds")]:
        pre = name[:-len("inds")]
        inds = out.pop(name).long()
        wt, bt = out.pop(pre + "proj_wt"), out.pop(pre + "proj_bt")
        out[pre + "proj.kernel"] = out[pre + "proj.kernel"].index_copy(
            1, inds, wt.to(out[pre + "proj.kernel"].dtype))
        out[pre + "proj.bias"] = out[pre + "proj.bias"].index_copy(
            0, inds, bt.to(out[pre + "proj.bias"].dtype))
    return out


def count_params(tensors: Iterable[torch.Tensor]) -> int:
    """Total element count, e.g. `count_params(p for p in m.parameters()
    if p.requires_grad)` for the trainable count."""
    return sum(int(t.numel()) for t in tensors)
