"""Serving: export a classifier artifact and answer requests from it.

Counterpart of `apla_tpu/serve.py` (classifier only).  The JAX artifact holds
flax msgpack params and `jax.export` programs; neither can be read without
jax, so this artifact is a directory of

  meta.json    format "apla_tpu_torch.serve/1", img_size, n_classes,
               embed_dim, batch_sizes and the ViT config echoed
  params.npz   the model state as flat `trainable/<name>` and
               `frozen/<name>` arrays (float32 parameters, int64 APLA inds)

`load_predictor` rebuilds the model from `meta.json` on an explicit device
and runs it eagerly.  `Predictor` keeps the JAX predictor's request policy:
requests are cut into calls at the exported batch sizes, the tail padded to
the smallest covering batch when that wastes at most half of it.

CLI (run from a checkout):
  python -m apla_tpu_torch.serve export --params_path RECIPE.yml \\
      --n_classes 1000 --out ART [--batch_sizes 1,8,64] [--seed 0]
  python -m apla_tpu_torch.serve predict ART batch.npy [--device cuda]
  python -m apla_tpu_torch.serve info ART
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from .models.classifier import classifier_forward, classifier_from_state
from .models.vit import ViTConfig

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


def export_classifier(path: str, model, vit_cfg: ViTConfig,
                      batch_sizes=(1, 8, 64)) -> dict:
    """Write a serving artifact for `model` (a `Classifier`) served with
    `vit_cfg`.  Returns the meta dict."""
    batch_sizes = _check_batch_sizes(batch_sizes)
    os.makedirs(path, exist_ok=True)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    arrays = {f"{'trainable' if n in trainable else 'frozen'}/{n}":
              t.detach().cpu().numpy()
              for n, t in model.state_dict().items()}
    np.savez(os.path.join(path, _PARAMS_FILE), **arrays)
    meta = {
        "format": FORMAT,
        "img_size": int(vit_cfg.img_size),
        "n_classes": int(model.fc.bias.shape[0]),
        "embed_dim": int(vit_cfg.embed_dim),
        "batch_sizes": batch_sizes,
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
    npys = [p for p in inputs if p.endswith(".npy")]
    if npys:
        if len(inputs) > 1:
            raise SystemExit("pass ONE .npy batch, or image files — not a "
                             "mix of several")
        return np.load(npys[0]).astype(np.float32)
    from PIL import Image
    mean = np.asarray([float(v) for v in mean.split(",")], np.float32)
    std = np.asarray([float(v) for v in std.split(",")], np.float32)
    ims = []
    for p in inputs:
        im = Image.open(p).convert("RGB").resize((img, img), Image.BICUBIC)
        ims.append((np.asarray(im, np.float32) / 255.0 - mean) / std)
    return np.stack(ims)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="apla_tpu_torch.serve",
        description="Export / inspect / run classifier serving artifacts")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="export a serving artifact")
    ex.add_argument("--params_path", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--batch_sizes", default="1,8,64")
    ex.add_argument("--n_classes", type=int, required=True,
                    help="head width (the dataset registry is not ported)")
    ex.add_argument("--seed", type=int, default=0,
                    help="seed of the weight init")
    info = sub.add_parser("info", help="print an artifact's meta")
    info.add_argument("artifact")
    pr = sub.add_parser("predict", help="run an artifact on images")
    pr.add_argument("artifact")
    pr.add_argument("inputs", nargs="+",
                    help="a .npy [n,H,W,3] float batch (already "
                         "normalized), or image files (decoded, resized, "
                         "normalized with --mean/--std)")
    pr.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    pr.add_argument("--top_k", type=int, default=5)
    pr.add_argument("--embed", action="store_true",
                    help="print/save embeddings instead of logits")
    pr.add_argument("--mean", default="0.485,0.456,0.406")
    pr.add_argument("--std", default="0.229,0.224,0.225")
    pr.add_argument("--out", default=None,
                    help="write the logits/embeddings to this .npy file")
    args = ap.parse_args(argv)

    if args.cmd == "info":
        with open(os.path.join(args.artifact, _META_FILE)) as f:
            print(json.dumps(json.load(f), indent=2))
        return

    if args.cmd == "predict":
        from .wrapper import resolve_device
        pred = load_predictor(args.artifact, resolve_device(args.device))
        x = _load_inputs(args.inputs, pred.meta["img_size"], args.mean,
                         args.std)
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
    meta = export_classifier(args.out, model, vit_cfg, batch_sizes=bs)
    print(f"Exported {meta['vit_config']['depth']}-block classifier "
          f"(img {meta['img_size']}, {meta['n_classes']} classes) at "
          f"batch sizes {meta['batch_sizes']} -> {args.out}")


if __name__ == "__main__":
    main()
