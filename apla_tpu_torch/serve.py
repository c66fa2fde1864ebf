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
      --n_classes 1000 --out ART [--batch_sizes 1,8,64] [--seed 0] \\
      [--quantize_frozen]
  python -m apla_tpu_torch.serve export_seg --ckpt seg_best.pt --out ART \\
      [--backbone vit_large --img_size 512 --patch_size 16 --batch_sizes 1,4]
      [--quantize_frozen]
  python -m apla_tpu_torch.serve export_det --ckpt det_best.pt --out ART \\
      [--depths 2,2,6 --num_heads 3,6,12 --batch_sizes 1,8] [--quantize_frozen]
  python -m apla_tpu_torch.serve predict ART batch.npy [--device cuda]
  python -m apla_tpu_torch.serve info ART
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys

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
    the raw per-level maps; `DetPredictor.detect` decodes them per image on
    the host.  `quantize_frozen`: see `_maybe_quantize`.  Returns the meta
    dict."""
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
        "with_masks": False,
        "batch_sizes": batch_sizes,
        "quantized_frozen": is_quantized(model),
        "swin_config": _swin_echo(swin_cfg),
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class DetPredictor(Predictor):
    """Runs a detector artifact: calls return the raw per-level FCOS maps;
    `detect` decodes them per image on the host (sigmoid, score threshold,
    greedy NMS)."""

    def __init__(self, meta: dict, model, swin_cfg, device: torch.device):
        super().__init__(meta, model, None, device)
        self.swin_cfg = swin_cfg

    @torch.inference_mode()
    def _call(self, chunk: np.ndarray):
        from .models.detection import detector_forward
        x = torch.from_numpy(chunk).to(self.device)
        return detector_forward(self.model, x, self.swin_cfg)

    def _run_chunks(self, images: np.ndarray):
        chunks = []
        for _, m, chunk in self._iter_chunks(images):
            chunks.append([tuple(o[:m].float().cpu().numpy() for o in lvl)
                           for lvl in self._call(chunk)])
        if not chunks:
            # empty request: one call of the smallest batch on zeros, so
            # the per-level output shapes are still right (trimmed to 0)
            img, b = self.meta["img_size"], self.batch_sizes[0]
            chunks.append([tuple(o[:0].float().cpu().numpy() for o in lvl)
                           for lvl in self._call(
                               np.zeros((b, img, img, 3), np.float32))])
        return [tuple(np.concatenate([c[lvl][j] for c in chunks])
                      for j in range(len(chunks[0][lvl])))
                for lvl in range(len(chunks[0]))]

    def predict(self, images: np.ndarray):
        """[n, H, W, 3] -> per-level raw maps [(cls_logits [n,H_l,W_l,K],
        box [n,H_l,W_l,4], ctr [n,H_l,W_l,1])]."""
        return self._run_chunks(images)

    def predict_protos(self, images: np.ndarray):
        from .models.detection import MASKS_TODO
        raise NotImplementedError(MASKS_TODO)

    def detect(self, images: np.ndarray, score_thresh=0.05, top_k=100):
        """[n, H, W, 3] -> list of n (boxes [M,4], scores [M], labels [M])
        tuples (host-side decode + NMS per image)."""
        from .models.detection import decode_detections
        levels = self._run_chunks(images)
        strides = self.meta["strides"]
        return [decode_detections([tuple(o[j:j + 1] for o in lvl)
                                   for lvl in levels], strides,
                                  score_thresh=score_thresh, top_k=top_k)
                for j in range(images.shape[0])]

    def embed(self, images):
        raise NotImplementedError("detection artifacts have no embedding "
                                  "output")

    def predict_and_embed(self, images):
        raise NotImplementedError("detection artifacts have no embedding "
                                  "output")


def detector_from_state(swin_cfg, n_classes, trainable: dict, frozen: dict,
                        device) -> "torch.nn.Module":
    """A `Detector` holding the state maps (int8 kernels where the state
    has them), trainable flags as named."""
    from .models.detection import Detector
    from .ops.quant import quantize_like_state
    state = {**frozen, **trainable}
    model = quantize_like_state(Detector(swin_cfg, n_classes), state)
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

def _build_from_params(params_path: str, n_classes: int, seed: int):
    from .models.classifier import init_classifier
    from .utils.config import load_merged_params
    from .wrapper import build_apla_config, build_vit_config

    params = load_merged_params(params_path)
    vit_cfg = build_vit_config(params)
    if params["model_params"].get("pretrained"):
        print("note: the recipe names a pretrained checkpoint; the port has "
              "no checkpoint importer yet, weights come from --seed",
              file=sys.stderr)
    model = init_classifier(
        vit_cfg, n_classes, apla_cfg=build_apla_config(params),
        freeze_backbone=bool(params["model_params"].get("freeze_backbone",
                                                        False)),
        generator=torch.Generator().manual_seed(seed),
        device=torch.device("cpu"))
    return model, vit_cfg


def _load_inputs(inputs, img, mean, std):
    """A .npy batch, or PNG files decoded, resized as Pillow's BICUBIC
    does and normalized (the port reads images without PIL)."""
    from .data.detection_data import read_png, resize
    npys = [p for p in inputs if p.endswith(".npy")]
    if npys:
        if len(inputs) > 1:
            raise SystemExit("pass ONE .npy batch, or image files — not a "
                             "mix of several")
        return np.load(npys[0]).astype(np.float32)
    mean = np.asarray([float(v) for v in mean.split(",")], np.float32)
    std = np.asarray([float(v) for v in std.split(",")], np.float32)
    ims = [resize(read_png(p), img, img, "bicubic") for p in inputs]
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
    ex.add_argument("--out", required=True)
    ex.add_argument("--batch_sizes", default="1,8,64")
    ex.add_argument("--n_classes", type=int, required=True,
                    help="head width (the dataset registry is not ported)")
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
    pr = sub.add_parser("predict", help="run an artifact on images")
    pr.add_argument("artifact")
    pr.add_argument("inputs", nargs="+",
                    help="a .npy [n,H,W,3] float batch (already "
                         "normalized), or PNG files (decoded, resized, "
                         "normalized with --mean/--std)")
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
            recs = [{"image": i, "boxes": np.asarray(boxes).tolist(),
                     "scores": np.round(np.asarray(scores), 4).tolist(),
                     "labels": np.asarray(labels).tolist()}
                    for i, (boxes, scores, labels) in enumerate(
                        pred.detect(x, score_thresh=args.score_thresh,
                                    top_k=args.max_dets))]
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

    model, vit_cfg = _build_from_params(args.params_path, args.n_classes,
                                        args.seed)
    bs = [int(x) for x in str(args.batch_sizes).split(",") if x]
    meta = export_classifier(args.out, model, vit_cfg, batch_sizes=bs,
                             quantize_frozen=args.quantize_frozen)
    print(f"Exported {meta['vit_config']['depth']}-block classifier "
          f"(img {meta['img_size']}, {meta['n_classes']} classes) at "
          f"batch sizes {meta['batch_sizes']} -> {args.out}")


if __name__ == "__main__":
    main()
