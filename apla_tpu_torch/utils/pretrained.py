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

import numpy as np
import torch

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
    `build_apla_swin` trainable tree, "head": ..., "laterals": [...]};
    `frozen` = the Swin tree without its `attn.proj`s."""
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
