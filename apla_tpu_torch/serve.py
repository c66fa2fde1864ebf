"""Serving: export a classifier, segmenter or detector artifact and answer
requests from it.

Counterpart of `apla_tpu/serve.py` (classifier, segmenter, detector).  The JAX
artifact holds flax msgpack params and `jax.export` programs; neither can be
read without jax, so this artifact is a directory of

  meta.json    format "apla_tpu_torch.serve/1", img_size, n_classes,
               batch_sizes, quantized_frozen and the model's config echoed
               (the ViT config, also for `task: "segmenter"`; for
               `task: "detector"` the Swin config, the strides and
               `with_masks`), because the port rebuilds the model at load
  params.npz   the model state as flat `trainable/<name>` and
               `frozen/<name>` arrays (float32 parameters, int64 APLA inds;
               with `quantize_frozen` the frozen qkv / fc1 / fc2 kernels as
               int8 `<dense>.kernel.w_int8` and f32 `.scale`)

`quantize_frozen=True` (`--quantize_frozen`) stores the frozen backbone's
qkv / fc1 / fc2 kernels in int8 (`ops.quant.quantize_frozen_backbone`, the
projections and heads stay float), and the reloaded model runs each of those
products through `ops.quant.int8_matmul`: the hand-written int8 kernel on a
card, its plain version on the CPU.

`load_predictor` rebuilds the model from `meta.json` on an explicit device
and runs it eagerly (`SegPredictor` for a segmenter, `DetPredictor` for a
detector).  `Predictor` keeps the JAX predictor's request policy: requests
are cut into calls at the exported batch sizes, the tail padded to the
smallest covering batch when that wastes at most half of it.

CLI (run from a checkout):
  python -m apla_tpu_torch.serve export --params_path RECIPE.yml \\
      --out ART [--pretrained_path CKPT_DIR] [--n_classes 1000] \\
      [--batch_sizes 1,8,64] [--seed 0] [--quantize_frozen]
  python -m apla_tpu_torch.serve export_seg --ckpt seg_best.pt --out ART \\
      [--backbone vit_large --img_size 512 --patch_size 16 --batch_sizes 1,4]
      [--quantize_frozen]
  python -m apla_tpu_torch.serve export_det --ckpt det_best.pt --out ART \\
      [--depths 2,2,6 --num_heads 3,6,12 --batch_sizes 1,8] [--quantize_frozen]
  python -m apla_tpu_torch.serve predict ART batch.npy [--device cuda]
  python -m apla_tpu_torch.serve info ART
  python -m apla_tpu_torch.serve eval ART --params_path RECIPE.yml [--knn]
  python -m apla_tpu_torch.serve eval ART --det_img_dir DIR --det_ann ANN
  python -m apla_tpu_torch.serve eval ART --seg_root ADE \\
      [--eval_img_size 640 --eval_stride S]

`export` builds the recipe's classifier as the wrapper does: the seeded
init, the recipe's pretrained DINOv2 `.pth`, then `--pretrained_path` (or
the recipe's `transfer_learning_params.pretrained_path`), a checkpoint
directory of the port adopted by `train.checkpoint.transfer_into`.  `eval`
scores an artifact as `apla_tpu/serve.py`'s does: a classifier's `--test`
table on a recipe's split (with `--knn` the kNN vote over its served
embeddings), a detector's box mAP@50 over a COCO set, a segmenter's mIoU
over an ADE20K-layout validation split (sliding windows past the crop).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import numpy as np
import torch

from .models.classifier import classifier_forward, classifier_from_state
from .models.vit import ViTConfig
from .ops.quant import is_quantized, quantize_frozen_backbone

FORMAT = "apla_tpu_torch.serve/1"
_PARAMS_FILE = "params.npz"
_META_FILE = "meta.json"


def _check_batch_sizes(batch_sizes):
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    return batch_sizes


def _cfg_echo(vit_cfg: ViTConfig) -> dict:
    echo = dataclasses.asdict(vit_cfg)
    echo["compute_dtype"] = str(vit_cfg.compute_dtype).replace("torch.", "")
    return echo


def _cfg_from_echo(echo: dict) -> ViTConfig:
    echo = dict(echo)
    echo["compute_dtype"] = getattr(torch, echo["compute_dtype"])
    return ViTConfig(**echo)


def _maybe_quantize(model, quantize_frozen: bool):
    """`model` with its frozen backbone kernels in int8 (qkv / fc1 / fc2 ->
    `QuantizedKernel`, `ops.quant.quantize_frozen_backbone`), made on a copy
    so the caller's model stays float; `model` itself when not asked, or
    when it is quantized already (a custom `which`: quantizing again would
    meet the int8 kernels)."""
    if not quantize_frozen or is_quantized(model):
        return model
    return quantize_frozen_backbone(copy.deepcopy(model))


def _write_state(path: str, model) -> None:
    """params.npz: the state (parameters, persistent buffers) as
    `trainable/<name>` and `frozen/<name>` arrays."""
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    arrays = {f"{'trainable' if n in trainable else 'frozen'}/{n}":
              t.detach().cpu().numpy()
              for n, t in model.state_dict().items()}
    np.savez(os.path.join(path, _PARAMS_FILE), **arrays)


def export_classifier(path: str, model, vit_cfg: ViTConfig,
                      batch_sizes=(1, 8, 64), quantize_frozen=False) -> dict:
    """Write a serving artifact for `model` (a `Classifier`) served with
    `vit_cfg`.  `quantize_frozen`: see `_maybe_quantize`.  Returns the meta
    dict."""
    model = _maybe_quantize(model, quantize_frozen)
    batch_sizes = _check_batch_sizes(batch_sizes)
    os.makedirs(path, exist_ok=True)
    _write_state(path, model)
    meta = {
        "format": FORMAT,
        "img_size": int(vit_cfg.img_size),
        "n_classes": int(model.fc.bias.shape[0]),
        "embed_dim": int(vit_cfg.embed_dim),
        "batch_sizes": batch_sizes,
        "quantized_frozen": is_quantized(model),
        "vit_config": _cfg_echo(vit_cfg),
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class Predictor:
    """Runs a classifier artifact's model on `device`, one call per exported
    batch size."""

    def __init__(self, meta: dict, model, vit_cfg: ViTConfig,
                 device: torch.device):
        self.meta = meta
        self.model = model.eval()
        self.vit_cfg = vit_cfg
        self.device = torch.device(device)
        self.batch_sizes = sorted(int(b) for b in meta["batch_sizes"])

    def _pick_batch(self, rem: int) -> int:
        """Exported batch for the next call on `rem` remaining images: pad
        up to the smallest covering batch when the waste is at most half
        that batch, otherwise take the largest batch that fits and recurse
        on the tail (same rule as the JAX predictor)."""
        covers = [b for b in self.batch_sizes if b >= rem]
        fits = [b for b in self.batch_sizes if b <= rem]
        if covers and (not fits or min(covers) - rem <= min(covers) // 2):
            return min(covers)
        return max(fits)

    def _iter_chunks(self, images: np.ndarray):
        """Yield (batch_size, n_real, padded_chunk) per call; tail chunks
        are zero-padded to the chosen batch."""
        n = images.shape[0]
        img = self.meta["img_size"]
        if images.ndim != 4 or images.shape[1:] != (img, img, 3):
            raise ValueError(
                f"expected [n, {img}, {img}, 3] images, got {images.shape}")
        images = np.asarray(images, np.float32)
        i = 0
        while i < n:
            rem = n - i
            b = self._pick_batch(rem)
            m = min(b, rem)
            chunk = images[i:i + m]
            if m < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - m,) + chunk.shape[1:], np.float32)])
            yield b, m, chunk
            i += m

    @torch.inference_mode()
    def _call(self, chunk: np.ndarray):
        x = torch.from_numpy(chunk).to(self.device)
        logits, emb = classifier_forward(self.model, x, self.vit_cfg,
                                         return_embedding=True)
        return logits.float(), emb.float()

    def _run_chunks(self, images: np.ndarray):
        out_l, out_e = [], []
        for _, m, chunk in self._iter_chunks(images):
            logits, emb = self._call(chunk)
            out_l.append(logits[:m].cpu().numpy())
            out_e.append(emb[:m].cpu().numpy())
        return (np.concatenate(out_l) if out_l
                else np.zeros((0, self.meta["n_classes"]), np.float32),
                np.concatenate(out_e) if out_e
                else np.zeros((0, self.meta["embed_dim"]), np.float32))

    def predict(self, images: np.ndarray) -> np.ndarray:
        """[n, H, W, 3] float images (normalized) -> [n, n_classes] logits."""
        return self._run_chunks(images)[0]

    def embed(self, images: np.ndarray) -> np.ndarray:
        """[n, H, W, 3] -> [n, embed_dim] backbone features."""
        return self._run_chunks(images)[1]

    def predict_and_embed(self, images: np.ndarray):
        """(logits, embeddings) from one pass over the calls."""
        return self._run_chunks(images)


# ------------------------------------------------------------------ #
# detector
# ------------------------------------------------------------------ #

def _swin_echo(swin_cfg) -> dict:
    echo = dataclasses.asdict(swin_cfg)
    echo["depths"] = list(swin_cfg.depths)
    echo["num_heads"] = list(swin_cfg.num_heads)
    echo["compute_dtype"] = str(swin_cfg.compute_dtype).replace("torch.", "")
    return echo


def _swin_from_echo(echo: dict):
    from .models.swin import SwinConfig
    echo = dict(echo)
    echo["compute_dtype"] = getattr(torch, echo["compute_dtype"])
    echo["depths"] = tuple(echo["depths"])
    echo["num_heads"] = tuple(echo["num_heads"])
    return SwinConfig(**echo)


def export_detector(path: str, model, swin_cfg, strides,
                    batch_sizes=(1, 8), quantize_frozen=False) -> dict:
    """Write a serving artifact for the FCOS detection side-car (`model` a
    `models.detection.Detector`, served with `swin_cfg`).  Calls compute
    the raw per-level maps (a detector trained with the mask branch, `segdet
    det --masks`, also its coefficient maps and prototype masks:
    `with_masks` in the meta); `DetPredictor.detect` decodes them per image
    on the host.  `quantize_frozen`: see `_maybe_quantize`.  Returns the
    meta dict."""
    model = _maybe_quantize(model, quantize_frozen)
    batch_sizes = _check_batch_sizes(batch_sizes)
    os.makedirs(path, exist_ok=True)
    _write_state(path, model)
    meta = {
        "format": FORMAT,
        "task": "detector",
        "img_size": int(swin_cfg.img_size),
        "n_classes": int(model.head.cls.bias.shape[0]),
        "strides": [int(s) for s in strides],
        "with_masks": model.protonet is not None,
        "batch_sizes": batch_sizes,
        "quantized_frozen": is_quantized(model),
        "swin_config": _swin_echo(swin_cfg),
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class DetPredictor(Predictor):
    """Runs a detector artifact: calls return the raw per-level FCOS maps
    (and the prototype masks of a mask export); `detect` decodes them per
    image on the host (sigmoid, score threshold, greedy NMS, and the
    prototype-mask assembly when present)."""

    def __init__(self, meta: dict, model, swin_cfg, device: torch.device):
        super().__init__(meta, model, None, device)
        self.swin_cfg = swin_cfg

    @torch.inference_mode()
    def _call(self, chunk: np.ndarray, m: int):
        """One call -> (levels, protos or None) as numpy, its first m
        images."""
        from .models.detection import detector_outputs
        x = torch.from_numpy(chunk).to(self.device)
        levels, protos = detector_outputs(self.model, x, self.swin_cfg)
        levels = [tuple(o[:m].float().cpu().numpy() for o in lvl)
                  for lvl in levels]
        return levels, (None if protos is None
                        else protos[:m].float().cpu().numpy())

    def _run_chunks(self, images: np.ndarray):
        outs = [self._call(chunk, m)
                for _, m, chunk in self._iter_chunks(images)]
        if not outs:
            # empty request: one call of the smallest batch on zeros, so
            # the per-level output shapes are still right (trimmed to 0)
            img, b = self.meta["img_size"], self.batch_sizes[0]
            outs = [self._call(np.zeros((b, img, img, 3), np.float32), 0)]
        levels = [tuple(np.concatenate([c[0][lvl][j] for c in outs])
                        for j in range(len(outs[0][0][lvl])))
                  for lvl in range(len(outs[0][0]))]
        protos = None if outs[0][1] is None \
            else np.concatenate([c[1] for c in outs])
        return levels, protos

    def predict(self, images: np.ndarray):
        """[n, H, W, 3] -> per-level raw maps [(cls_logits [n,H_l,W_l,K],
        box [n,H_l,W_l,4], ctr [n,H_l,W_l,1])] (+ a coefficient map per
        level for mask exports; `predict_protos` gives the prototypes)."""
        return self._run_chunks(images)[0]

    def predict_protos(self, images: np.ndarray):
        """[n, H, W, 3] -> prototype masks [n, Hm, Wm, P] (mask exports;
        None otherwise)."""
        return self._run_chunks(images)[1]

    def detect(self, images: np.ndarray, score_thresh=0.05, top_k=100):
        """[n, H, W, 3] -> list of n (boxes [M,4], scores [M], labels [M])
        tuples, (boxes, scores, labels, masks [M,Hm,Wm] bool) for mask
        exports (host-side decode + NMS per image)."""
        from .models.detection import decode_detections
        levels, protos = self._run_chunks(images)
        strides = self.meta["strides"]
        out = []
        for j in range(images.shape[0]):
            kw = {} if protos is None else {"protos": protos[j:j + 1],
                                            "mask_stride": strides[0]}
            out.append(decode_detections(
                [tuple(o[j:j + 1] for o in lvl) for lvl in levels], strides,
                score_thresh=score_thresh, top_k=top_k, **kw))
        return out

    def embed(self, images):
        raise NotImplementedError("detection artifacts have no embedding "
                                  "output")

    def predict_and_embed(self, images):
        raise NotImplementedError("detection artifacts have no embedding "
                                  "output")


def detector_from_state(swin_cfg, n_classes, trainable: dict, frozen: dict,
                        device) -> "torch.nn.Module":
    """A `Detector` holding the state maps (int8 kernels where the state
    has them; the mask branch where it has `head.coef`), trainable flags
    as named."""
    from .models.detection import Detector
    from .ops.quant import quantize_like_state
    state = {**frozen, **trainable}
    n_protos = int(state["head.coef.bias"].shape[0]) \
        if "head.coef.bias" in state else 0
    model = quantize_like_state(Detector(swin_cfg, n_classes, n_protos),
                                state)
    names = set(model.state_dict())
    if names != set(state):
        raise ValueError("the state does not name the detector's "
                         f"parameters: {sorted(names ^ set(state))[:5]}")
    model.load_state_dict(state, strict=True)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    return model.to(device)


# ------------------------------------------------------------------ #
# segmenter
# ------------------------------------------------------------------ #

def export_segmenter(path: str, model, vit_cfg: ViTConfig,
                     batch_sizes=(1, 4), quantize_frozen=False) -> dict:
    """Write a serving artifact for a SETR-PUP segmenter (`model` a
    `models.seg.Segmenter`, the side-car `segdet seg` trains), served with
    `vit_cfg`.  Calls compute per-pixel logits [B, H, W, n_classes]
    (float32); the artifact loads back as a `SegPredictor`.
    `quantize_frozen`: see `_maybe_quantize` (the "full" projections train
    in place and stay float).  Returns the meta dict."""
    model = _maybe_quantize(model, quantize_frozen)
    batch_sizes = _check_batch_sizes(batch_sizes)
    os.makedirs(path, exist_ok=True)
    _write_state(path, model)
    meta = {
        "format": FORMAT,
        "task": "segmenter",
        "img_size": int(vit_cfg.img_size),
        "n_classes": int(model.head.cls.bias.shape[0]),
        "batch_sizes": batch_sizes,
        "quantized_frozen": is_quantized(model),
        "vit_config": _cfg_echo(vit_cfg),
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def segmenter_from_state(vit_cfg: ViTConfig, trainable: dict, frozen: dict,
                         device) -> "torch.nn.Module":
    """A `Segmenter` holding the state maps (a `segdet` checkpoint or a
    serving artifact), trainable flags as named.  Head widths, the aux
    heads, the APLA split (trainable projections: "full"; else rank-k
    `attn.inds`) and the int8 kernels come from the state."""
    from .apla.core import AplaConfig
    from .models.seg import Segmenter, build_seg_apla
    from .ops.quant import quantize_like_state
    state = {**frozen, **trainable}
    n_aux = sum(1 for n in state if n.startswith("aux_heads.")
                and n.endswith(".cls.bias"))
    model = Segmenter(
        vit_cfg, int(state["head.cls.bias"].shape[0]),
        channels=int(state["head.convs.0.bias"].shape[0]), n_aux_heads=n_aux,
        aux_channels=(int(state["aux_heads.0.convs.0.bias"].shape[0])
                      if n_aux else 256))
    if "backbone.blocks.0.attn.proj.kernel" in trainable:
        build_seg_apla(model.backbone, AplaConfig(partial_size="full"))
    for i, blk in enumerate(model.backbone.blocks):
        inds = state.get(f"backbone.blocks.{i}.attn.inds")
        if inds is not None:
            blk.attn.add_apla(torch.zeros(inds.shape, dtype=torch.int64))
    quantize_like_state(model, state)
    model.load_state_dict(state, strict=True)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    return model.to(device)


class SegPredictor(Predictor):
    """Runs a segmenter artifact: calls return per-pixel logits
    [B, H, W, n_classes]."""

    @torch.inference_mode()
    def _call(self, chunk: np.ndarray):
        from .models.seg import segmenter_forward
        x = torch.from_numpy(chunk).to(self.device)
        return segmenter_forward(self.model, x, self.vit_cfg)

    def _run_chunks(self, images: np.ndarray):
        out = [self._call(chunk)[:m].cpu().numpy()
               for _, m, chunk in self._iter_chunks(images)]
        img = self.meta["img_size"]
        return (np.concatenate(out) if out
                else np.zeros((0, img, img, self.meta["n_classes"]),
                              np.float32))

    def predict(self, images: np.ndarray) -> np.ndarray:
        """[n, H, W, 3] -> [n, H, W, n_classes] per-pixel logits."""
        return self._run_chunks(images)

    def masks(self, images: np.ndarray) -> np.ndarray:
        """[n, H, W, 3] -> [n, H, W] int32 argmax class map."""
        return np.argmax(self._run_chunks(images), axis=-1).astype(np.int32)

    def predict_slide(self, images: np.ndarray,
                      stride: int | None = None) -> np.ndarray:
        """Sliding-window inference over images larger than the exported
        crop (`models.seg.segmenter_slide_forward`'s windows, cut on the
        host and sent through the calls in groups of the largest exported
        batch, logits averaged where windows overlap; default stride 2/3
        of the crop).  [n, H, W, 3], H, W >= crop -> [n, H, W, n_classes]."""
        from .models.seg import slide_starts, slide_stride
        crop = self.meta["img_size"]
        if images.ndim != 4 or images.shape[3] != 3 \
                or images.shape[1] < crop or images.shape[2] < crop:
            raise ValueError(
                f"expected [n, >={crop}, >={crop}, 3], got {images.shape}")
        n, H, W = images.shape[:3]
        if H == crop and W == crop:
            return self._run_chunks(images)
        stride = slide_stride(crop, stride)
        images = np.asarray(images, np.float32)
        positions = [(i, y, x) for i in range(n)
                     for y in slide_starts(H, crop, stride)
                     for x in slide_starts(W, crop, stride)]
        out = np.zeros((n, H, W, self.meta["n_classes"]), np.float32)
        cnt = np.zeros((n, H, W, 1), np.float32)
        # one group of window logits on the host at a time
        group_size = max(self.batch_sizes)
        for g in range(0, len(positions), group_size):
            group = positions[g:g + group_size]
            logits = self._run_chunks(np.stack(
                [images[i, y:y + crop, x:x + crop] for i, y, x in group]))
            for (i, y, x), lg in zip(group, logits):
                out[i, y:y + crop, x:x + crop] += lg
                cnt[i, y:y + crop, x:x + crop] += 1.0
        return out / cnt

    def masks_slide(self, images: np.ndarray,
                    stride: int | None = None) -> np.ndarray:
        return np.argmax(self.predict_slide(images, stride=stride),
                         axis=-1).astype(np.int32)

    def embed(self, images):
        raise NotImplementedError("segmentation artifacts have no "
                                  "embedding output")

    def predict_and_embed(self, images):
        raise NotImplementedError("segmentation artifacts have no "
                                  "embedding output")


def load_predictor(path: str, device) -> Predictor:
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"not an apla_tpu_torch serving artifact: {path}")
    trainable, frozen = {}, {}
    with np.load(os.path.join(path, _PARAMS_FILE)) as z:
        for key in z.files:
            group, name = key.split("/", 1)
            {"trainable": trainable, "frozen": frozen}[group][name] = \
                torch.from_numpy(z[key])
    if meta.get("task") == "segmenter":
        vit_cfg = _cfg_from_echo(meta["vit_config"])
        model = segmenter_from_state(vit_cfg, trainable, frozen,
                                     torch.device(device))
        return SegPredictor(meta, model, vit_cfg, device)
    if meta.get("task") == "detector":
        swin_cfg = _swin_from_echo(meta["swin_config"])
        model = detector_from_state(swin_cfg, meta["n_classes"], trainable,
                                    frozen, torch.device(device))
        return DetPredictor(meta, model, swin_cfg, device)
    vit_cfg = _cfg_from_echo(meta["vit_config"])
    model = classifier_from_state(vit_cfg, trainable, frozen,
                                  torch.device(device))
    return Predictor(meta, model, vit_cfg, device)


# ------------------------------------------------------------------ #
# CLI
# ------------------------------------------------------------------ #

def _build_from_params(params_path: str, pretrained_path: str | None,
                       n_classes: int | None, seed: int):
    """The recipe's classifier on the CPU, as `apla_tpu/serve.py:523-557`
    builds it: the seeded init (`--seed`), then the recipe's pretrained
    backbone (`model_params.pretrained`), then `pretrained_path` or the
    recipe's `transfer_learning_params.pretrained_path`, adopted through
    `transfer_into`.  `n_classes` None: the dataset class's."""
    from .data.datasets import get_dataset_class
    from .models.classifier import init_classifier
    from .train.checkpoint import transfer_into
    from .utils.config import load_merged_params
    from .utils.pretrained import maybe_load_pretrained_backbone
    from .wrapper import build_apla_config, build_vit_config

    params = load_merged_params(params_path)
    mp = params["model_params"]
    if n_classes is None:
        n_classes = int(get_dataset_class(
            params["dataset_params"]["dataset"]).n_classes)
    vit_cfg = build_vit_config(params)
    model = init_classifier(
        vit_cfg, n_classes, apla_cfg=build_apla_config(params),
        freeze_backbone=bool(mp.get("freeze_backbone", False)),
        generator=torch.Generator().manual_seed(seed),
        device=torch.device("cpu"))
    if mp.get("pretrained"):
        maybe_load_pretrained_backbone(model.backbone, mp, vit_cfg)
    ckpt = pretrained_path or (params.get("transfer_learning_params")
                               or {}).get("pretrained_path")
    if ckpt:
        transfer_into(model, ckpt, where="serve-export")
    return model, vit_cfg


def _load_inputs(inputs, img, mean, std):
    """A .npy batch, or image files (PNG or JPEG, by content) decoded,
    resized as Pillow's BICUBIC does and normalized (the port reads images
    without PIL)."""
    from .data.detection_data import read_image, resize
    npys = [p for p in inputs if p.endswith(".npy")]
    if npys:
        if len(inputs) > 1:
            raise SystemExit("pass ONE .npy batch, or image files — not a "
                             "mix of several")
        return np.load(npys[0]).astype(np.float32)
    mean = np.asarray([float(v) for v in mean.split(",")], np.float32)
    std = np.asarray([float(v) for v in std.split(",")], np.float32)
    ims = [resize(read_image(p), img, img, "bicubic") for p in inputs]
    return np.stack([(np.asarray(im, np.float32) / 255.0 - mean) / std
                     for im in ims])


def _export_det(args) -> dict:
    """export_det: a segdet checkpoint -> a detector artifact, at f32 on the
    plain window attention, as the JAX CLI exports it (with
    `--quantize_frozen` the int8 kernel takes the f32 activations)."""
    from .segdet import load_checkpoint, swin_config
    ckpt = load_checkpoint(args.ckpt)
    depths = tuple(int(x) for x in args.depths.split(","))
    cfg = swin_config(args.img_size, args.embed_dim, depths,
                      tuple(int(x) for x in args.num_heads.split(",")),
                      args.window_size, bf16=False, use_fused=False)
    n_classes = int(ckpt["trainable"]["head.cls.bias"].shape[0])
    model = detector_from_state(cfg, n_classes, ckpt["trainable"],
                                ckpt["frozen"], torch.device("cpu"))
    strides = tuple(4 * (2 ** i) for i in range(len(depths)))
    bs = [int(x) for x in str(args.batch_sizes).split(",") if x]
    return export_detector(args.out, model, cfg, strides, batch_sizes=bs,
                           quantize_frozen=args.quantize_frozen)


def _export_seg(args) -> dict:
    """export_seg: a segdet checkpoint -> a segmenter artifact at the ViT's
    bf16 compute, as the JAX CLI exports it, served through the fused APLA
    kernels (their plain versions on the CPU)."""
    from .segdet import load_checkpoint, seg_vit_config
    ckpt = load_checkpoint(args.ckpt)
    cfg = seg_vit_config(args.backbone, args.img_size, args.patch_size,
                         use_fused=True)
    model = segmenter_from_state(cfg, ckpt["trainable"], ckpt["frozen"],
                                 torch.device("cpu"))
    bs = [int(x) for x in str(args.batch_sizes).split(",") if x]
    return export_segmenter(args.out, model, cfg, batch_sizes=bs,
                            quantize_frozen=args.quantize_frozen)


def _print_results(title: str, results: dict) -> dict:
    print(title)
    width = max(len(k) for k in results)
    for k, v in results.items():
        print(f"  {k:<{width}} : {v}")
    return results


def _eval_detector(pred, args) -> dict:
    """Box mAP@50 of a detector artifact over a COCO set, decoded as
    `DetPredictor.detect` (and the detection loop) decodes; a mask export's
    mask mAP@50 beside it."""
    from .data.detection_data import CocoDetection, detection_collate
    from .data.loader import DataLoader
    from .models.detection import DetectionAP
    ds = CocoDetection(args.det_img_dir, args.det_ann,
                       img_size=pred.meta["img_size"],
                       with_masks=bool(pred.meta.get("with_masks")),
                       mask_stride=pred.meta.get("strides", [4])[0])
    bsz = max(pred.batch_sizes)
    loader = DataLoader(ds, batch_size=bsz, shuffle=False, drop_last=False,
                        num_workers=args.num_workers,
                        collate_fn=detection_collate)
    metric = DetectionAP(ds.n_classes)
    mask_metric = DetectionAP(ds.n_classes, use_masks=True) \
        if ds.with_masks else None
    n_seen = 0
    for bi, b in enumerate(loader):
        dets = pred.detect(np.asarray(b["image"], np.float32))
        labels, boxes = np.asarray(b["labels"]), np.asarray(b["boxes"])
        for j, det in enumerate(dets):
            keep = labels[j] >= 0
            metric.add_image(bi * bsz + j, *det[:3], boxes[j][keep],
                             labels[j][keep])
            if mask_metric is not None:
                mask_metric.add_image(
                    bi * bsz + j, *det[:3], boxes[j][keep], labels[j][keep],
                    pred_masks=det[3],
                    gt_masks=np.asarray(b["masks"])[j][keep])
            n_seen += 1
    results = {"val_map50": round(metric.mean_ap(), 4)}
    if mask_metric is not None:
        results["val_mask_map50"] = round(mask_metric.mean_ap(), 4)
    return _print_results(
        f"EVAL RESULTS (val, {n_seen} samples, artifact {args.artifact})",
        results)


def _eval_segmenter(pred, args, error) -> dict:
    """Dataset-level mIoU of a segmenter artifact over an ADE20K-layout
    'validation' split: at the exported crop, or with `--eval_img_size`
    through sliding windows of it (`SegPredictor.masks_slide`)."""
    from .data.loader import DataLoader
    from .data.segmentation_data import (ADE20KSegmentation,
                                         segmentation_collate)
    from .models.seg import iou_counts, mean_iou_from_counts
    img = pred.meta["img_size"]
    eval_size = int(args.eval_img_size) if args.eval_img_size else img
    if eval_size < img:
        error(f"--eval_img_size {eval_size} < exported crop {img}")
    if args.eval_stride and eval_size == img:
        error("--eval_stride needs --eval_img_size > the exported crop (no "
              "sliding at the crop size)")
    val = ADE20KSegmentation(args.seg_root, "validation",
                             img_size=eval_size)
    loader = DataLoader(val, batch_size=max(pred.batch_sizes),
                        shuffle=False, drop_last=False,
                        num_workers=args.num_workers,
                        collate_fn=segmentation_collate)
    inter = union = 0
    n_seen = 0
    for b in loader:
        im = np.asarray(b["image"], np.float32)
        masks = (pred.masks_slide(im, stride=args.eval_stride)
                 if eval_size > img else pred.masks(im))
        bi, bu = iou_counts(masks, np.asarray(b["label"]),
                            n_classes=val.n_classes)
        inter, union = inter + bi, union + bu
        n_seen += masks.shape[0]
    miou = mean_iou_from_counts(inter, union) if np.ndim(union) else 0.0
    return _print_results(
        f"EVAL RESULTS (val, {n_seen} samples, artifact {args.artifact})",
        {"val_miou": round(miou, 4)})


def _eval_classifier(pred, args) -> dict:
    """The `--test` table of a classifier artifact on a recipe's split,
    with `--knn` also the kNN vote over the served embeddings (feature
    bank: the train split through the eval transforms; k = the dataset's
    `knn_nhood`, temperature 0.07)."""
    from .train.knn import build_feature_bank, knn_predict
    from .train.metrics import ClassificationMetrics
    from .utils.config import load_merged_params
    from .wrapper import DefaultWrapper
    params = load_merged_params(args.params_path)
    params.setdefault("system_params", {})["device"] = str(pred.device)
    if args.num_workers is not None:
        for ld in params["dataloader_params"].values():
            ld["num_workers"] = args.num_workers
    wrapper = DefaultWrapper(params)
    if args.knn:        # init_dataloaders builds the bank's loader on it
        wrapper.training_params.knn_eval = True
    loaders = wrapper.init_dataloaders()
    split = args.split or "test"
    loader = loaders.testloader if split == "test" else loaders.valloader
    n_classes = pred.meta["n_classes"]
    metric = ClassificationMetrics(n_classes, mode=split)

    def embed_norm(e):
        """Served embeddings L2-normalised on the predictor's device, as
        the trainer's embed step normalises its own."""
        e = torch.from_numpy(e).to(pred.device)
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True)
                    + 1e-12)

    kmetric = None
    if args.knn:
        feats, bank = build_feature_bank(
            lambda im: embed_norm(pred.embed(
                im.cpu().numpy().astype(np.float32))),
            loaders.fbank_loader, pred.device)
        bank_labels = torch.as_tensor(bank, device=pred.device)
        knn_k = min(int(getattr(loader.dataset, "knn_nhood", 20)),
                    len(bank))
        kmetric = ClassificationMetrics(n_classes, mode=f"knn_{split}",
                                        raw=False)
    n_seen = 0
    for batch in loader:
        labels = np.asarray(batch["label"])
        logits, emb = pred.predict_and_embed(
            np.asarray(batch["image"], np.float32))
        metric.add_preds(logits, labels)
        n_seen += labels.shape[0]
        if kmetric is not None:
            scores = knn_predict(embed_norm(emb), feats, bank_labels, knn_k,
                                 0.07, n_classes)
            kmetric.add_preds(scores.cpu().numpy(), labels)
    results = metric.get_values()
    if kmetric is not None:
        results.update(kmetric.get_values())
    return _print_results(f"EVAL RESULTS ({split}, {n_seen} samples, "
                          f"artifact {args.artifact})", results)


def run_eval(args, error) -> dict:
    """`serve eval`: an artifact scored as the JAX CLI scores it
    (`apla_tpu/serve.py:660-825`); `error` reports a bad flag mix."""
    from .wrapper import resolve_device
    if args.det_img_dir or args.det_ann:
        if not (args.det_img_dir and args.det_ann):
            error("--det_img_dir and --det_ann go together")
        if args.split or args.knn or args.params_path or args.seg_root \
                or args.eval_img_size or args.eval_stride:
            error("--det_img_dir/--det_ann take no other eval flags")
        pred = load_predictor(args.artifact, resolve_device(args.device))
        if pred.meta.get("task") != "detector":
            error("--det_img_dir requires a detector artifact")
        return _eval_detector(pred, args)
    if args.seg_root:
        if args.split or args.knn or args.params_path:
            error("--seg_root evaluates the ADE validation split; "
                  "--split/--knn/--params_path do not apply")
        pred = load_predictor(args.artifact, resolve_device(args.device))
        if pred.meta.get("task") != "segmenter":
            error("--seg_root requires a segmenter artifact")
        return _eval_segmenter(pred, args, error)
    if not args.params_path:
        error("eval needs --params_path (or --seg_root for segmenter "
              "artifacts)")
    if args.eval_img_size or args.eval_stride:
        error("--eval_img_size/--eval_stride apply only with --seg_root")
    pred = load_predictor(args.artifact, resolve_device(args.device))
    if pred.meta.get("task", "classifier") != "classifier":
        error("eval supports classifier artifacts (segmenter: pass "
              "--seg_root)")
    return _eval_classifier(pred, args)


def main(argv=None):
    import argparse

    from .wrapper import set_float32_precision
    set_float32_precision()
    ap = argparse.ArgumentParser(
        prog="apla_tpu_torch.serve",
        description="Export / inspect / run classifier, segmenter and "
                    "detector serving artifacts")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="export a serving artifact")
    ex.add_argument("--params_path", required=True)
    ex.add_argument("--pretrained_path", default=None,
                    help="checkpoint dir to adopt weights from")
    ex.add_argument("--out", required=True)
    ex.add_argument("--batch_sizes", default="1,8,64")
    ex.add_argument("--n_classes", type=int, default=None,
                    help="head width (default: the recipe's dataset's)")
    ex.add_argument("--seed", type=int, default=0,
                    help="seed of the weight init")
    ex.add_argument("--quantize_frozen", action="store_true",
                    help="int8 frozen backbone kernels in the artifact "
                         "(W8A8 serve path)")
    exd = sub.add_parser("export_det",
                         help="export a detection artifact from a segdet "
                              "checkpoint (det_best.pt)")
    exd.add_argument("--ckpt", required=True)
    exd.add_argument("--img_size", type=int, default=224)
    exd.add_argument("--embed_dim", type=int, default=96)
    exd.add_argument("--depths", default="2,2,6")
    exd.add_argument("--num_heads", default="3,6,12")
    exd.add_argument("--window_size", type=int, default=7)
    exd.add_argument("--out", required=True)
    exd.add_argument("--batch_sizes", default="1,8")
    exd.add_argument("--quantize_frozen", action="store_true",
                     help="int8 frozen Swin kernels in the artifact")
    exs = sub.add_parser("export_seg",
                         help="export a segmentation artifact from a "
                              "segdet checkpoint (seg_best.pt)")
    exs.add_argument("--ckpt", required=True,
                     help="segdet seg_best.pt ({'trainable', 'frozen'})")
    exs.add_argument("--backbone", default="vit_large")
    exs.add_argument("--img_size", type=int, default=512)
    exs.add_argument("--patch_size", type=int, default=16)
    exs.add_argument("--out", required=True)
    exs.add_argument("--batch_sizes", default="1,4")
    exs.add_argument("--quantize_frozen", action="store_true",
                     help="int8 frozen backbone kernels in the artifact")
    info = sub.add_parser("info", help="print an artifact's meta")
    info.add_argument("artifact")
    ev = sub.add_parser("eval",
                        help="evaluate an artifact: a classifier on a "
                             "recipe's split (the --test table, served), a "
                             "detector's mAP@50, a segmenter's mIoU")
    ev.add_argument("artifact")
    ev.add_argument("--params_path",
                    help="recipe naming the dataset + transforms "
                         "(classifier artifacts)")
    ev.add_argument("--split", default=None, choices=("test", "val"),
                    help="classifier artifacts (default test); a "
                         "--seg_root eval always scores the ADE "
                         "'validation' split")
    ev.add_argument("--knn", action="store_true",
                    help="also kNN-classify via the served embeddings "
                         "(feature bank = train split, val transforms)")
    ev.add_argument("--seg_root", default=None,
                    help="segmenter artifacts: ADE20K-layout root to "
                         "compute val mIoU over (instead of --params_path)")
    ev.add_argument("--eval_img_size", type=int, default=None,
                    help="with --seg_root: evaluate at this size via "
                         "sliding windows of the exported crop")
    ev.add_argument("--eval_stride", type=int, default=None,
                    help="slide stride (default 2/3 of the crop)")
    ev.add_argument("--det_img_dir", default=None,
                    help="detector artifacts: COCO image dir (with "
                         "--det_ann) to compute mAP@50 over")
    ev.add_argument("--det_ann", default=None,
                    help="detector artifacts: COCO instances .json")
    ev.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    ev.add_argument("--num_workers", type=int, default=None,
                    help="loader workers (default: 2 for --det_img_dir / "
                         "--seg_root, the recipe's for a classifier)")
    pr = sub.add_parser("predict", help="run an artifact on images")
    pr.add_argument("artifact")
    pr.add_argument("inputs", nargs="+",
                    help="a .npy [n,H,W,3] float batch (already "
                         "normalized), or PNG or JPEG files (decoded by "
                         "content, resized, normalized with --mean/--std)")
    pr.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    pr.add_argument("--top_k", type=int, default=5)
    pr.add_argument("--embed", action="store_true",
                    help="print/save embeddings instead of logits")
    pr.add_argument("--score_thresh", type=float, default=0.05,
                    help="detector decode threshold")
    pr.add_argument("--max_dets", type=int, default=100,
                    help="detector NMS cap per image")
    pr.add_argument("--mean", default="0.485,0.456,0.406")
    pr.add_argument("--std", default="0.229,0.224,0.225")
    pr.add_argument("--out", default=None,
                    help="write the logits/embeddings (.npy) or the "
                         "detections (.json) to this file")
    args = ap.parse_args(argv)

    if args.cmd == "info":
        with open(os.path.join(args.artifact, _META_FILE)) as f:
            print(json.dumps(json.load(f), indent=2))
        return

    if args.cmd == "eval":
        if args.num_workers is None and (args.det_img_dir or args.seg_root):
            args.num_workers = 2
        return run_eval(args, ap.error)

    if args.cmd == "export_seg":
        meta = _export_seg(args)
        print(f"Exported segmenter (img {meta['img_size']}, "
              f"{meta['n_classes']} classes) at batch sizes "
              f"{meta['batch_sizes']} -> {args.out}")
        return

    if args.cmd == "export_det":
        meta = _export_det(args)
        print(f"Exported detector (img {meta['img_size']}, "
              f"{meta['n_classes']} classes, strides {meta['strides']}) "
              f"at batch sizes {meta['batch_sizes']} -> {args.out}")
        return

    if args.cmd == "predict":
        from .wrapper import resolve_device
        pred = load_predictor(args.artifact, resolve_device(args.device))
        x = _load_inputs(args.inputs, pred.meta["img_size"], args.mean,
                         args.std)
        if pred.meta.get("task") == "detector":
            recs = []
            for i, det in enumerate(pred.detect(
                    x, score_thresh=args.score_thresh, top_k=args.max_dets)):
                boxes, scores, labels = det[:3]
                rec = {"image": i, "boxes": np.asarray(boxes).tolist(),
                       "scores": np.round(np.asarray(scores), 4).tolist(),
                       "labels": np.asarray(labels).tolist()}
                if len(det) == 4:  # mask export: [M, Hm, Wm] 0/1 grids
                    rec["masks"] = np.asarray(det[3], np.uint8).tolist()
                recs.append(rec)
            for rec in recs:
                print(json.dumps(rec))
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(recs, f)
                print(f"detections -> {args.out}")
            return
        if pred.meta.get("task") == "segmenter":
            img = pred.meta["img_size"]
            masks = (pred.masks_slide(x) if x.shape[1] > img
                     or x.shape[2] > img else pred.masks(x))
            for i, m in enumerate(masks):
                cls, cnt = np.unique(m, return_counts=True)
                top = sorted(zip(cnt.tolist(), cls.tolist()), reverse=True)
                print(f"image {i}: mask {m.shape}, top classes "
                      + ", ".join(f"{c} ({n}px)" for n, c in top[:5]))
            if args.out:
                np.save(args.out, masks)
                print(f"masks -> {args.out}")
            return
        out = pred.embed(x) if args.embed else pred.predict(x)
        if args.embed:
            print(f"embeddings {out.shape}")
        else:
            k = min(args.top_k, out.shape[-1])
            for i, row in enumerate(out):
                top = np.argsort(row)[::-1][:k]
                print(f"image {i}: "
                      + ", ".join(f"class {c}: {row[c]:.3f}" for c in top))
        if args.out:
            np.save(args.out, out)
            print(f"output -> {args.out}")
        return

    model, vit_cfg = _build_from_params(args.params_path,
                                        args.pretrained_path, args.n_classes,
                                        args.seed)
    bs = [int(x) for x in str(args.batch_sizes).split(",") if x]
    meta = export_classifier(args.out, model, vit_cfg, batch_sizes=bs,
                             quantize_frozen=args.quantize_frozen)
    print(f"Exported {meta['vit_config']['depth']}-block classifier "
          f"(img {meta['img_size']}, {meta['n_classes']} classes) at "
          f"batch sizes {meta['batch_sizes']} -> {args.out}")


if __name__ == "__main__":
    main()
