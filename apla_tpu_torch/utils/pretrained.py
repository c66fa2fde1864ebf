"""Weight bridges into the port.

`params_from_jax` turns the JAX package's `(trainable, frozen)` trees (nested
dicts and lists of numpy arrays, block leaves stacked `[L, ...]`) into the
port's module state, split the same way: two flat `name -> tensor` maps whose
names are the port's parameter and buffer names (a W8A8 tree's
`{'w_int8', 'scale'}` kernels become `<dense>.kernel.w_int8` / `.scale`, the
buffers of `ops.quant.QuantizedKernel`).  Every parity test goes
through it, and `models.classifier.classifier_from_state` builds a module
from it.  `dinov2_state_from_jax` carries a JAX DINOv2 train state across:
student trainable tree, teacher tree, frozen tree (with `mask_token`) and
both centers; `byol_state_from_jax` a BYOL/SimSiam one (with the BN running
stats) and `dino_state_from_jax` a DINO v1 one (with its center);
`seg_state_from_jax` a JAX SETR-PUP segmenter.

The DINO / DINOv2 ViT checkpoints: `convert_torch_vit_state_dict` (the
torch.hub layout, chunked blocks too) and `convert_vit_hf_dinov2_state_dict`
(HF `Dinov2Model`) map a `.pth` state dict straight onto the port's ViT
parameter names; `export_torch_vit_state_dict` is the inverse of the first;
`load_torch_checkpoint` unwraps a training checkpoint and
`maybe_load_pretrained_backbone` imports `model_params.
pretrained_checkpoint` into a ViT module in place, as
`apla_tpu/utils/pretrained.py` imports it into the JAX trees.

The Swin side: a Swin tree's flat names are the port's module names
(`stages.{s}.blocks.{i}.attn.qkv.kernel`, lists indexed), so
`swin_state_from_tree` flattens one, `swin_tree_from_state` nests a state
back, and `det_state_from_jax` carries a JAX detector's trees across (the
APLA-trainable `proj` goes back under its block's `attn`).  The Hugging Face
`SwinModel` key maps (`convert_swin_hf_state_dict`,
`swin_arch_from_hf_state_dict`, `export_swin_hf_state_dict`) work on such
trees, over a state dict read with a local `torch.load`.
"""

from __future__ import annotations

import math
import os
import re
import warnings

import numpy as np
import torch

from ..models.vit import fit_optional_leaves

# Leaves of the APLA trainable block tree, placed under the block's attn.
_APLA_LEAVES = ("proj_wt", "proj_bt")


def _tensor(a) -> torch.Tensor:
    """float32, int64 indices, or int8 (a W8A8 tree's `w_int8` leaves)."""
    a = np.asarray(a)
    dtype = np.int8 if a.dtype == np.int8 else \
        np.int64 if a.dtype.kind in "iu" else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _flatten(tree, prefix: str, out: dict) -> None:
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            _flatten(val, name + ".", out)
        else:
            out[name] = val


def _split_blocks(flat: dict, prefix: str) -> dict:
    """Flat JAX names -> port names: `{prefix}blocks.<path>` leaves [L, ...]
    become `{prefix}blocks.{i}.<path>`; APLA leaves go under `attn.`."""
    out = {}
    for name, val in flat.items():
        head = f"{prefix}blocks."
        if not name.startswith(head):
            out[name] = _tensor(val)
            continue
        path = name[len(head):]
        if path in _APLA_LEAVES:
            path = "attn." + path
        for i, leaf in enumerate(np.asarray(val)):
            out[f"{head}{i}.{path}"] = _tensor(leaf)
    return out


def params_from_jax(trainable: dict, frozen: dict):
    """(trainable, frozen) JAX trees -> (trainable, frozen) port state.

    Accepts classifier trees (`{'backbone': ..., 'fc': ...}`, any of the
    APLA / linear-probe / full fine-tune partitions) and bare ViT trees
    (the `build_apla` output), whose names then carry no `backbone.`."""
    is_classifier = ("fc" in trainable or "backbone" in frozen
                     or "backbone" in trainable)
    prefix = "backbone." if is_classifier else ""
    states = []
    for tree in (trainable, frozen):
        flat = {}
        _flatten(tree, "", flat)
        states.append(_split_blocks(flat, prefix))
    return states[0], states[1]


def dinov2_state_from_jax(state, frozen: dict) -> dict:
    """A JAX `DINOv2TrainState` (numpy leaves) and its frozen tree -> the
    port's pieces: {'trainable', 'teacher', 'frozen'} name -> tensor maps
    (`DINOv2Model` names: `backbone.*`, `dino_head.mlp.{i}.*`,
    `dino_head.last_v`, `dino_head.last_g`, `backbone.mask_token`) and the
    'dino_center' / 'ibot_center' tensors [1, K]."""
    trainable, frozen_t = params_from_jax(dict(state.trainable), frozen)
    teacher, _ = params_from_jax(dict(state.teacher), {})
    return {"trainable": trainable, "teacher": teacher, "frozen": frozen_t,
            "dino_center": _tensor(state.dino_center),
            "ibot_center": _tensor(state.ibot_center)}


def byol_state_from_jax(state, frozen: dict) -> dict:
    """A JAX `SSLTrainState` (BYOL/SimSiam; numpy leaves) and its frozen
    tree -> {'trainable', 'teacher', 'frozen', 'model_state'} name -> tensor
    maps: `BYOLModel` names (`backbone.*`, `head.fc{i}.*`, `head.bn{i}.*`,
    `predictor.*`) and the BN running stats under their dotted paths
    (`student.head.bn0.mean`, `student.predictor.bn0.var`,
    `teacher.head.bn1.mean`, ...)."""
    trainable, frozen_t = params_from_jax(dict(state.trainable), frozen)
    teacher, _ = params_from_jax(dict(state.teacher), {})
    stats = {}
    _flatten(dict(state.model_state), "", stats)
    return {"trainable": trainable, "teacher": teacher, "frozen": frozen_t,
            "model_state": {n: _tensor(v) for n, v in stats.items()}}


def dino_state_from_jax(state, frozen: dict) -> dict:
    """A JAX `DINOTrainState` (numpy leaves) and its frozen tree ->
    {'trainable', 'teacher', 'frozen'} name -> tensor maps (`DINOModel`
    names: `backbone.*`, `head.mlp.{i}.*`, `head.last_v`, `head.last_g`)
    and the 'center' tensor [1, K]."""
    trainable, frozen_t = params_from_jax(dict(state.trainable), frozen)
    teacher, _ = params_from_jax(dict(state.teacher), {})
    return {"trainable": trainable, "teacher": teacher, "frozen": frozen_t,
            "center": _tensor(state.center)}


def seg_state_from_jax(trainable: dict, frozen: dict):
    """A JAX segmenter's trees (`models/seg.init_segmenter`: {"backbone",
    "head", "aux_heads"?} trainable, {"backbone"} frozen) -> the port's
    `(trainable, frozen)` state of `models.seg.Segmenter`: the backbone as
    `params_from_jax` maps it (under "full" the trainable
    `blocks.{i}.attn.proj`), the PUP convs with their HWIO kernels under
    `head.convs.{i}` and `aux_heads.{j}.convs.{i}`."""
    rest = dict(trainable)
    t_state, f_state = params_from_jax({"backbone": rest.pop("backbone")},
                                       frozen)
    flat = {}
    _flatten(rest, "", flat)
    t_state.update({name: _tensor(val) for name, val in flat.items()})
    return t_state, f_state


# --------------------------------------------------------------------------- #
# Swin and the detector
# --------------------------------------------------------------------------- #

def swin_state_from_tree(tree: dict, prefix: str = "") -> dict:
    """A nested Swin (or detector) tree of arrays -> flat `name -> tensor`
    state under `prefix`."""
    flat = {}
    _flatten(tree, prefix, flat)
    return {name: _tensor(val) for name, val in flat.items()}


def swin_tree_from_state(state: dict) -> dict:
    """Flat `name -> tensor` state -> the nested numpy tree (numeric name
    parts become list indices), the inverse of `swin_state_from_tree`."""
    tree: dict = {}
    for name, val in state.items():
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val.detach().cpu().numpy() \
            if isinstance(val, torch.Tensor) else np.asarray(val)

    def relist(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [relist(node[str(i)]) for i in range(len(node))]
        return {k: relist(v) for k, v in node.items()}

    return relist(tree)


def det_state_from_jax(trainable: dict, frozen: dict):
    """A JAX detector's trees -> the port's `(trainable, frozen)` state of
    `models.detection.Detector`.  `trainable` = {"backbone": the
    `build_apla_swin` trainable tree, "head": ... (with "coef" under the
    mask branch), "laterals": [...], and "protonet": {"convs": [...],
    "out": ...} under the mask branch}; `frozen` = the Swin tree without
    its `attn.proj`s.  Every name but the backbone's maps as it is nested
    (`protonet.convs.0.kernel`, `head.coef.bias`)."""
    t = swin_state_from_tree(trainable)
    out = {}
    for name, val in t.items():
        if name.startswith("backbone.") and ".proj." in name:
            head, tail = name.split(".proj.", 1)
            name = f"{head}.attn.proj.{tail}"
        out[name] = val
    return out, swin_state_from_tree(frozen, "backbone.")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def convert_swin_hf_state_dict(sd: dict, depths) -> dict:
    """HF `SwinModel` state_dict -> the Swin tree (`init_swin_params`
    layout, numpy), as `apla_tpu/utils/pretrained.py` maps it:

      embeddings.patch_embeddings.projection  -> patch_embed (OIHW->HWIO)
      embeddings.norm                         -> patch_norm
      encoder.layers.s.blocks.i.attention.self.{query,key,value}
                                              -> stages[s].blocks[i].attn.qkv
                                                 (packed [d, 3d])
      ...attention.self.relative_position_bias_table -> attn.rel_bias
      ...attention.output.dense               -> attn.proj
      ...layernorm_before/after               -> norm1/norm2
      ...intermediate.dense / output.dense    -> mlp.fc1 / fc2
      encoder.layers.s.downsample.{reduction,norm} -> stages[s].downsample
      layernorm (final)                       -> norms[-1]
    The earlier stages' pyramid norms have no HF counterpart and stay at
    their init (ones, zeros)."""

    def lin(prefix):
        p = {"kernel": _np(sd[prefix + ".weight"]).T}        # [in, out]
        if prefix + ".bias" in sd:
            p["bias"] = _np(sd[prefix + ".bias"])
        return p

    def ln(prefix):
        return {"scale": _np(sd[prefix + ".weight"]),
                "bias": _np(sd[prefix + ".bias"])}

    params = {
        "patch_embed": {
            "kernel": _np(sd["embeddings.patch_embeddings.projection.weight"]
                          ).transpose(2, 3, 1, 0),
            "bias": _np(sd["embeddings.patch_embeddings.projection.bias"]),
        },
        "patch_norm": ln("embeddings.norm"),
        "stages": [],
        "norms": [],
    }
    for s, depth in enumerate(depths):
        base = f"encoder.layers.{s}"
        blocks = []
        for i in range(depth):
            b = f"{base}.blocks.{i}"
            q, k, v = (lin(f"{b}.attention.self.{n}")
                       for n in ("query", "key", "value"))
            blocks.append({
                "norm1": ln(f"{b}.layernorm_before"),
                "attn": {
                    "qkv": {"kernel": np.concatenate(
                        [q["kernel"], k["kernel"], v["kernel"]], axis=1),
                            "bias": np.concatenate(
                        [q["bias"], k["bias"], v["bias"]])},
                    "proj": lin(f"{b}.attention.output.dense"),
                    "rel_bias": _np(sd[
                        f"{b}.attention.self.relative_position_bias_table"]),
                },
                "norm2": ln(f"{b}.layernorm_after"),
                "mlp": {"fc1": lin(f"{b}.intermediate.dense"),
                        "fc2": lin(f"{b}.output.dense")},
            })
        stage = {"blocks": blocks}
        if f"{base}.downsample.reduction.weight" in sd:
            stage["downsample"] = {
                "reduction": lin(f"{base}.downsample.reduction"),
                "norm": ln(f"{base}.downsample.norm"),
            }
        params["stages"].append(stage)
        dim = params["patch_embed"]["bias"].shape[0] * (2 ** s)
        params["norms"].append({"scale": np.ones((dim,), np.float32),
                                "bias": np.zeros((dim,), np.float32)})
    if "layernorm.weight" in sd:
        params["norms"][-1] = ln("layernorm")
    return params


def swin_arch_from_hf_state_dict(sd: dict) -> dict:
    """(embed_dim, depths, num_heads, window_size, patch_size) of an HF
    SwinModel state_dict, so `--swin_ckpt` users need not restate them."""
    embed_dim = int(
        _np(sd["embeddings.patch_embeddings.projection.bias"]).shape[0])
    depths, num_heads = [], []
    window = 0
    s = 0
    while f"encoder.layers.{s}.blocks.0.layernorm_before.weight" in sd:
        i = 0
        while (f"encoder.layers.{s}.blocks.{i}.layernorm_before.weight"
               in sd):
            i += 1
        depths.append(i)
        table = _np(sd[f"encoder.layers.{s}.blocks.0."
                       f"attention.self.relative_position_bias_table"])
        num_heads.append(int(table.shape[1]))
        window = (int(math.isqrt(table.shape[0])) + 1) // 2
        s += 1
    patch = int(_np(
        sd["embeddings.patch_embeddings.projection.weight"]).shape[-1])
    return {"embed_dim": embed_dim, "depths": tuple(depths),
            "num_heads": tuple(num_heads), "window_size": window,
            "patch_size": patch}


def export_swin_hf_state_dict(params: dict) -> dict:
    """A Swin tree -> HF `SwinModel` state_dict naming (numpy values; the
    inverse of `convert_swin_hf_state_dict`)."""
    sd = {}

    def put_lin(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            sd[prefix + ".bias"] = np.asarray(p["bias"])

    def put_ln(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["scale"])
        sd[prefix + ".bias"] = np.asarray(p["bias"])

    sd["embeddings.patch_embeddings.projection.weight"] = \
        np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd["embeddings.patch_embeddings.projection.bias"] = \
        np.asarray(params["patch_embed"]["bias"])
    if "patch_norm" in params:
        put_ln("embeddings.norm", params["patch_norm"])
    for s, stage in enumerate(params["stages"]):
        base = f"encoder.layers.{s}"
        for i, blk in enumerate(stage["blocks"]):
            b = f"{base}.blocks.{i}"
            qkv_k = np.asarray(blk["attn"]["qkv"]["kernel"])
            qkv_b = np.asarray(blk["attn"]["qkv"]["bias"])
            d = qkv_k.shape[0]
            for j, name in enumerate(("query", "key", "value")):
                put_lin(f"{b}.attention.self.{name}",
                        {"kernel": qkv_k[:, j * d:(j + 1) * d],
                         "bias": qkv_b[j * d:(j + 1) * d]})
            sd[f"{b}.attention.self.relative_position_bias_table"] = \
                np.asarray(blk["attn"]["rel_bias"])
            put_lin(f"{b}.attention.output.dense", blk["attn"]["proj"])
            put_ln(f"{b}.layernorm_before", blk["norm1"])
            put_ln(f"{b}.layernorm_after", blk["norm2"])
            put_lin(f"{b}.intermediate.dense", blk["mlp"]["fc1"])
            put_lin(f"{b}.output.dense", blk["mlp"]["fc2"])
        if stage.get("downsample"):
            put_lin(f"{base}.downsample.reduction",
                    stage["downsample"]["reduction"])
            put_ln(f"{base}.downsample.norm", stage["downsample"]["norm"])
    put_ln("layernorm", params["norms"][-1])
    return sd


# --------------------------------------------------------------------------- #
# DINO / DINOv2 ViT checkpoints (torch.hub and Hugging Face layouts)
# --------------------------------------------------------------------------- #

def _f32(t) -> torch.Tensor:
    """A state-dict value as a float32 CPU tensor of its own."""
    t = t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(
        np.asarray(t))
    return t.to(device="cpu", dtype=torch.float32).clone()


def _lin_t(t) -> torch.Tensor:
    """A torch Linear weight [out, in] -> the port's kernel [in, out]."""
    return _f32(t).t().contiguous()


def _conv_t(t) -> torch.Tensor:
    """A Conv2d weight OIHW -> the port's patch kernel HWIO."""
    return _f32(t).permute(2, 3, 1, 0).contiguous()


def convert_torch_vit_state_dict(sd: dict, depth: int, use_swiglu=False,
                                 has_layerscale=False) -> dict:
    """A DINO / DINOv2 `VisionTransformer` state dict (torch.hub layout)
    -> the port's ViT state: `name -> float32 tensor` under the `ViT`
    module's names (`blocks.{i}.attn.qkv.kernel`, ...), as
    `apla_tpu/utils/pretrained.py:convert_torch_vit_state_dict` builds its
    tree.  Read: the `module.` and `backbone.` prefixes, the chunked
    `blocks.<chunk>.<i>.` layout, separate q / k / v (packed into qkv),
    SwiGLU `w12` / `w3`, `ls1.gamma` or the older `gamma_1` (only with
    `has_layerscale`), `register_tokens` and `mask_token` ([1, 1, d])."""
    sd = {k.removeprefix("module.").removeprefix("backbone."): v
          for k, v in sd.items()}
    if any(k.startswith("blocks.0.0.") for k in sd):
        sd = {re.sub(r"^blocks\.\d+\.(\d+\.)", r"blocks.\1", k): v
              for k, v in sd.items()}
    out = {"cls_token": _f32(sd["cls_token"]),
           "pos_embed": _f32(sd["pos_embed"]),
           "patch_embed.kernel": _conv_t(sd["patch_embed.proj.weight"]),
           "patch_embed.bias": _f32(sd["patch_embed.proj.bias"]),
           "norm.scale": _f32(sd["norm.weight"]),
           "norm.bias": _f32(sd["norm.bias"])}
    if "register_tokens" in sd:
        out["register_tokens"] = _f32(sd["register_tokens"])
    if "mask_token" in sd:
        out["mask_token"] = _f32(sd["mask_token"]).reshape(1, 1, -1)
    mlp = ("w12", "w3") if use_swiglu else ("fc1", "fc2")
    for i in range(depth):
        p = f"blocks.{i}."
        if p + "attn.qkv.weight" in sd:
            out[p + "attn.qkv.kernel"] = _lin_t(sd[p + "attn.qkv.weight"])
            if p + "attn.qkv.bias" in sd:
                out[p + "attn.qkv.bias"] = _f32(sd[p + "attn.qkv.bias"])
        else:       # separate q / k / v, packed into the qkv layout
            out[p + "attn.qkv.kernel"] = torch.cat(
                [_lin_t(sd[f"{p}attn.{n}.weight"]) for n in "qkv"], dim=1)
            if p + "attn.q.bias" in sd:
                out[p + "attn.qkv.bias"] = torch.cat(
                    [_f32(sd[f"{p}attn.{n}.bias"]) for n in "qkv"])
        out[p + "attn.proj.kernel"] = _lin_t(sd[p + "attn.proj.weight"])
        out[p + "attn.proj.bias"] = _f32(sd[p + "attn.proj.bias"])
        for norm in ("norm1", "norm2"):
            out[f"{p}{norm}.scale"] = _f32(sd[f"{p}{norm}.weight"])
            out[f"{p}{norm}.bias"] = _f32(sd[f"{p}{norm}.bias"])
        for name in mlp:
            out[f"{p}mlp.{name}.kernel"] = _lin_t(sd[f"{p}mlp.{name}.weight"])
            out[f"{p}mlp.{name}.bias"] = _f32(sd[f"{p}mlp.{name}.bias"])
        if has_layerscale:
            for ls, old in (("ls1", "gamma_1"), ("ls2", "gamma_2")):
                key = p + f"{ls}.gamma" if p + "ls1.gamma" in sd else p + old
                if key in sd:
                    out[f"{p}{ls}.gamma"] = _f32(sd[key])
    return out


def export_torch_vit_state_dict(state: dict, use_swiglu=False) -> dict:
    """The inverse of `convert_torch_vit_state_dict`: a port ViT state
    (the `ViT` module's names, e.g. `vit.state_dict()`) -> a torch.hub
    DINO / DINOv2 state dict of float32 tensors (`torch.save` it).  An
    APLA-split state is merged first (`apla.core.merge_apla_params`)."""
    if any(n.endswith(("proj_wt", "proj_bt", "attn.inds")) for n in state):
        raise ValueError("merge the APLA columns first "
                         "(apla.core.merge_apla_params)")
    sd = {"cls_token": _f32(state["cls_token"]),
          "pos_embed": _f32(state["pos_embed"])}
    for name in ("register_tokens", "mask_token"):
        if state.get(name) is not None:
            sd[name] = _f32(state[name])
    if "mask_token" in sd:
        sd["mask_token"] = sd["mask_token"].reshape(1, -1)
    sd["patch_embed.proj.weight"] = _f32(state["patch_embed.kernel"]
                                         ).permute(3, 2, 0, 1).contiguous()
    sd["patch_embed.proj.bias"] = _f32(state["patch_embed.bias"])
    sd["norm.weight"] = _f32(state["norm.scale"])
    sd["norm.bias"] = _f32(state["norm.bias"])
    depth = sum(1 for n in state
                if re.fullmatch(r"blocks\.\d+\.norm1\.scale", n))
    mlp = ("w12", "w3") if use_swiglu else ("fc1", "fc2")
    for i in range(depth):
        p = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[f"{p}{norm}.weight"] = _f32(state[f"{p}{norm}.scale"])
            sd[f"{p}{norm}.bias"] = _f32(state[f"{p}{norm}.bias"])
        for dense in ["attn.qkv", "attn.proj"] + [f"mlp.{n}" for n in mlp]:
            sd[f"{p}{dense}.weight"] = _lin_t(state[f"{p}{dense}.kernel"])
            if state.get(f"{p}{dense}.bias") is not None:
                sd[f"{p}{dense}.bias"] = _f32(state[f"{p}{dense}.bias"])
        for ls in ("ls1", "ls2"):
            if state.get(f"{p}{ls}.gamma") is not None:
                sd[f"{p}{ls}.gamma"] = _f32(state[f"{p}{ls}.gamma"])
    return sd


def load_torch_checkpoint(path: str) -> dict:
    """A `.pth` read on the CPU, unwrapped from the first of its
    `teacher` / `student` / `model` / `state_dict` entries that holds a
    dict (DINO and DINOv2 training checkpoints)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("teacher", "student", "model", "state_dict"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            return ckpt[key]
    return ckpt


def convert_vit_hf_dinov2_state_dict(sd: dict, depth: int) -> dict:
    """A Hugging Face `Dinov2Model` state dict (the hub mirror of the
    dinov2 checkpoints) -> the port's ViT state, as
    `apla_tpu/utils/pretrained.py:convert_vit_hf_dinov2_state_dict`
    maps it: query / key / value packed into qkv, `layer_scale{1,2}.
    lambda1` as LayerScale when present, `mlp.weights_in` / `weights_out`
    as SwiGLU `w12` / `w3` when there is no `fc1`."""
    def lin(ours, theirs):
        out[ours + ".kernel"] = _lin_t(sd[theirs + ".weight"])
        if theirs + ".bias" in sd:
            out[ours + ".bias"] = _f32(sd[theirs + ".bias"])

    def ln(ours, theirs):
        out[ours + ".scale"] = _f32(sd[theirs + ".weight"])
        out[ours + ".bias"] = _f32(sd[theirs + ".bias"])

    emb = "embeddings."
    out = {"patch_embed.kernel": _conv_t(
               sd[emb + "patch_embeddings.projection.weight"]),
           "patch_embed.bias": _f32(
               sd[emb + "patch_embeddings.projection.bias"]),
           "cls_token": _f32(sd[emb + "cls_token"]),
           "pos_embed": _f32(sd[emb + "position_embeddings"])}
    ln("norm", "layernorm")
    if emb + "mask_token" in sd:
        out["mask_token"] = _f32(sd[emb + "mask_token"]).reshape(1, 1, -1)
    if emb + "register_tokens" in sd:
        out["register_tokens"] = _f32(sd[emb + "register_tokens"])
    for i in range(depth):
        b, p = f"encoder.layer.{i}.", f"blocks.{i}."
        qkv = [f"{b}attention.attention.{n}" for n in ("query", "key",
                                                       "value")]
        out[p + "attn.qkv.kernel"] = torch.cat(
            [_lin_t(sd[n + ".weight"]) for n in qkv], dim=1)
        out[p + "attn.qkv.bias"] = torch.cat([_f32(sd[n + ".bias"])
                                              for n in qkv])
        lin(p + "attn.proj", b + "attention.output.dense")
        ln(p + "norm1", b + "norm1")
        ln(p + "norm2", b + "norm2")
        if b + "mlp.fc1.weight" in sd:
            lin(p + "mlp.fc1", b + "mlp.fc1")
            lin(p + "mlp.fc2", b + "mlp.fc2")
        else:
            lin(p + "mlp.w12", b + "mlp.weights_in")
            lin(p + "mlp.w3", b + "mlp.weights_out")
        if b + "layer_scale1.lambda1" in sd:
            out[p + "ls1.gamma"] = _f32(sd[b + "layer_scale1.lambda1"])
            out[p + "ls2.gamma"] = _f32(sd[b + "layer_scale2.lambda1"])
    return out


@torch.no_grad()
def load_vit_state(vit, state: dict) -> None:
    """Put a converted ViT state (`convert_*` above) into the `ViT` module
    `vit` in place, so that its weights are the state's, as the JAX package
    replaces the backbone tree by the imported one: every tensor of the
    state replaces its parameter (`pos_embed` may change length); the
    optional leaves follow the state (`models.vit.fit_optional_leaves`;
    those added train only when the backbone does, a full fine-tune; the
    mask token stays when the state has none); APLA-k blocks take their
    trainable columns `inds` from the imported projection, and under APLA
    "full" the projection is the trainable parameter itself."""
    fit_optional_leaves(vit, state, keep_mask_token=True,
                        requires_grad=vit.cls_token.requires_grad)
    for name, value in state.items():
        vit.get_parameter(name).data = value.to(vit.cls_token.device)
    for blk in vit.blocks:
        attn = blk.attn
        if attn.inds is not None:
            attn.proj_wt.data = attn.proj.kernel.index_select(
                1, attn.inds).clone()
            attn.proj_bt.data = attn.proj.bias.index_select(
                0, attn.inds).clone()


def maybe_load_pretrained_backbone(vit, model_params, vit_cfg) -> bool:
    """`model_params.pretrained_checkpoint`, a local `.pth` (torch.hub or
    Hugging Face `Dinov2Model` layout), imported into the `ViT` module
    `vit` in place (`load_vit_state`).  Without such a file: the JAX
    package's warning, and the seeded init stays.  Returns whether weights
    were imported."""
    path = model_params.get("pretrained_checkpoint", "")
    if not path or not os.path.exists(path):
        warnings.warn(
            "model_params.pretrained=true but no local checkpoint found "
            f"(pretrained_checkpoint={path!r}); zero-egress environment "
            "cannot download dinov2 weights — continuing from random init.")
        return False
    sd = load_torch_checkpoint(path)
    if any(k.startswith("embeddings.patch_embeddings") for k in sd):
        state = convert_vit_hf_dinov2_state_dict(sd, vit_cfg.depth)
    else:
        state = convert_torch_vit_state_dict(
            sd, vit_cfg.depth, use_swiglu=vit_cfg.use_swiglu,
            has_layerscale=vit_cfg.has_layerscale)
    load_vit_state(vit, state)
    return True
