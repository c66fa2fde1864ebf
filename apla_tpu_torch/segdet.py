"""The detection side-car's train / evaluate / checkpoint loop.

Counterpart of `apla_tpu/segdet.py`, `det` half: APLA-Swin + FCOS on a
COCO-format dataset (the reference recipe mask-rcnn_apla_swin-t ... coco.py:
a Swin backbone with only each block's attn.proj trainable), box mAP@50 on
every epoch, the best and the last checkpoint, `--resume`, `--eval_only`,
multi-scale training (`--scales`), an HF Swin checkpoint (`--swin_ckpt`)
and a separate validation set.

    python -m apla_tpu_torch.segdet det --img_dir <dir> --ann <instances.json> \\
        --depths 2,2,6,2 --num_heads 3,6,12,24 --use_fused --bf16 [--device cpu]

Checkpoints are the port's own (`torch.save` of name -> tensor maps and the
optimizer state), written atomically: `det_best.pt` (trainable and frozen,
self-contained for `serve export_det`), `det_last.pt` (trainable and the
optimizer state; the frozen backbone is stored once, in `det_frozen.pt`),
each beside a `.json` meta with the JAX loop's keys (`epoch`, `map50`,
`preempted`).

Not ported yet, each raising with its ROADMAP item: `seg` (SETR-PUP on
ViT-L), `--masks`, `--n_devices > 1` and `--param_sharding fsdp`.  The
entry point runs on the card unless asked for the CPU (`--device cpu`);
`--use_fused` on the card takes `--bf16` (the window kernel is bf16 only:
the JAX loop warns and falls back to XLA there, the port does not fall
back).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .data.detection_data import CocoDetection, detection_collate
from .data.loader import DataLoader
from .models.detection import (MASKS_TODO, DetectionAP, decode_detections,
                               default_strides, detection_optimizer,
                               detector_forward, init_detector,
                               make_detection_train_step)
from .models.swin import SwinConfig, build_apla_swin
from .utils.logging import RunLogger

SEG_TODO = ("segdet seg (SETR-PUP on ViT-L, models/seg.py, ADE20K reading) "
            "is not ported yet: ROADMAP A 1")
PARALLEL_TODO = ("--n_devices > 1 / --param_sharding fsdp are not ported "
                 "yet: ROADMAP A 9 'Parallel modes'")


def _state(model):
    """(trainable, frozen) name -> CPU tensor maps of `model`."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        (trainable if p.requires_grad else frozen)[name] = \
            p.detach().to("cpu", copy=True)
    return trainable, frozen


def _atomic(path, write):
    write(path + ".tmp")
    os.replace(path + ".tmp", path)


def _save(save_dir, name, trainable, frozen, meta, opt_state=None):
    """Atomic checkpoint write (tmp + os.replace: a preemption mid-write
    must not corrupt the file).  `frozen=None` omits the backbone (the
    per-epoch 'last' checkpoints store it once in <task>_frozen.pt)."""
    os.makedirs(save_dir, exist_ok=True)
    host = {"trainable": trainable}
    if frozen is not None:
        host["frozen"] = frozen
    if opt_state is not None:
        host["opt_state"] = opt_state
    _atomic(os.path.join(save_dir, name + ".pt"),
            lambda p: torch.save(host, p))

    def write_meta(p):
        with open(p, "w") as f:
            json.dump(meta, f)

    _atomic(os.path.join(save_dir, name + ".json"), write_meta)


def _has_ckpt(save_dir, name):
    return (os.path.exists(os.path.join(save_dir, name + ".pt"))
            and os.path.exists(os.path.join(save_dir, name + ".json")))


def load_checkpoint(path):
    """A segdet checkpoint file -> {'trainable', 'frozen'?, 'opt_state'?}."""
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def _load_into(model, trainable, frozen):
    params = dict(model.named_parameters())
    for name, t in list(trainable.items()) + list(frozen.items()):
        params[name].copy_(t)


def _try_resume(save_dir, name, model, optimizer=None):
    """Restore the model (and the optimizer state) from a `_save`d
    checkpoint if one exists; -> the next epoch (0 without one).
    Checkpoints without a frozen backbone (per-epoch 'last') pull it from
    the once-written <task>_frozen.pt."""
    if not _has_ckpt(save_dir, name):
        return 0
    host = load_checkpoint(os.path.join(save_dir, name + ".pt"))
    frozen = host.get("frozen")
    if frozen is None:
        frozen = load_checkpoint(os.path.join(
            save_dir, name.split("_")[0] + "_frozen.pt"))["frozen"]
    _load_into(model, host["trainable"], frozen)
    if optimizer is not None and "opt_state" in host:
        optimizer.load_state_dict(host["opt_state"])
    with open(os.path.join(save_dir, name + ".json")) as f:
        start_epoch = int(json.load(f).get("epoch", -1)) + 1
    print(f"Resumed {name} at epoch {start_epoch}")
    return start_epoch


def _preemption_flag():
    """SIGTERM/SIGINT sets a flag checked at step boundaries (save a
    resumable 'last' checkpoint and exit cleanly).  Returns (check,
    restore): `check()` reads the flag; `restore()` reinstates the previous
    handlers.  Installed only in the main thread; a no-op elsewhere."""
    import signal
    import threading

    flag = {"hit": False}
    if threading.current_thread() is not threading.main_thread():
        return (lambda: False), (lambda: None)

    def _handler(signum, frame):
        flag["hit"] = True

    old_term = signal.signal(signal.SIGTERM, _handler)
    old_int = signal.signal(signal.SIGINT, _handler)

    def restore():
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)

    return (lambda: flag["hit"]), restore


def _best_metric(save_dir, name, key):
    """Best-so-far metric from a best checkpoint's meta (resume must not
    reset it to -inf)."""
    meta_path = os.path.join(save_dir, name + ".json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return float(json.load(f).get(key, -1.0))
    return -1.0


def swin_config(img_size, embed_dim, depths, num_heads, window_size, bf16,
                use_fused) -> SwinConfig:
    return SwinConfig(img_size=img_size, patch_size=4, embed_dim=embed_dim,
                      depths=tuple(depths), num_heads=tuple(num_heads),
                      window_size=window_size,
                      compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                      use_fused_apla=use_fused)


def _load_swin_ckpt(path):
    """A local HF SwinModel state_dict -> (its arch, the Swin state)."""
    from .utils.pretrained import (convert_swin_hf_state_dict,
                                   swin_arch_from_hf_state_dict,
                                   swin_state_from_tree)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    arch = swin_arch_from_hf_state_dict(sd)
    tree = convert_swin_hf_state_dict(sd, depths=arch["depths"])
    return arch, swin_state_from_tree(tree)


def train_detection(img_dir, ann_file, epochs=12, img_size=224,
                    batch_size=8, lr=1e-4, weight_decay=1e-4,
                    window_size=7, embed_dim=96, depths=(2, 2, 6),
                    num_heads=(3, 6, 12), max_boxes=32,
                    save_dir="checkpoints/det", num_workers=8,
                    log_every=10, eval_batches=None, seed=0,
                    swin_ckpt=None, val_img_dir=None, val_ann=None,
                    n_devices=1, param_sharding="replicated",
                    resume=False, eval_only=False, scales=None,
                    masks=False, n_protos=32, use_fused=False, bf16=False,
                    device=None):
    """APLA-Swin + FCOS on a COCO-format dataset.  Returns {'best_map50',
    'iters', 'eval_set'} (and 'preempted' after a SIGTERM)."""
    from .wrapper import resolve_device

    del n_protos
    if masks:
        raise NotImplementedError(MASKS_TODO)
    if (n_devices or 1) > 1 or param_sharding != "replicated":
        raise NotImplementedError(PARALLEL_TODO)
    device = resolve_device(device)
    if use_fused and not bf16 and device.type == "cuda":
        raise ValueError("--use_fused on the card needs --bf16: the window "
                         "kernel takes bfloat16 only")
    ds = CocoDetection(img_dir, ann_file, img_size=img_size,
                       max_boxes=max_boxes)
    # multi-scale training (reference recipe name: mstrain_480-800): one
    # scale drawn per epoch
    scales = tuple(int(s) for s in scales) if scales else None
    swin_state = None
    if swin_ckpt:
        # the architecture comes from the checkpoint itself
        arch, swin_state = _load_swin_ckpt(swin_ckpt)
        embed_dim, depths = arch["embed_dim"], arch["depths"]
        num_heads, window_size = arch["num_heads"], arch["window_size"]
        print(f"Swin arch from checkpoint: {arch}")
    cfg = swin_config(img_size, embed_dim, depths, num_heads, window_size,
                      bf16, use_fused)
    if scales:
        # every stage's feature map must stay window-aligned through the
        # patch mergings (this Swin does not pad)
        align = cfg.patch_size * cfg.window_size * 2 ** (len(depths) - 1)
        bad = [s for s in scales if s % align]
        if bad:
            raise ValueError(f"scales {bad} not divisible by "
                             f"patch*window*2^(stages-1) = {align}")
    loader = DataLoader(ds, batch_size=batch_size, shuffle=True,
                        drop_last=True, num_workers=num_workers,
                        collate_fn=detection_collate, seed=seed)
    model = init_detector(cfg, ds.n_classes,
                          torch.Generator().manual_seed(seed))
    if swin_state is not None:
        model.backbone.load_state_dict(swin_state)
        build_apla_swin(model.backbone)
        print(f"Imported HF Swin weights from {swin_ckpt}")
    model = model.to(device)
    strides = default_strides(cfg)
    optimizer = detection_optimizer(model, lr, weight_decay)
    start_epoch = 0
    if eval_only:
        name = "det_best" if _has_ckpt(save_dir, "det_best") else "det_last"
        if not _has_ckpt(save_dir, name):
            raise FileNotFoundError(
                f"--eval_only: no checkpoint under {save_dir}")
        _try_resume(save_dir, name, model)
    elif resume:
        start_epoch = _try_resume(save_dir, "det_last", model, optimizer)
    step = make_detection_train_step(cfg, optimizer, strides=strides)

    # a real validation split when provided; otherwise eval reuses the
    # train set and is labelled as such
    val_ds = (CocoDetection(val_img_dir, val_ann, img_size=img_size,
                            max_boxes=max_boxes)
              if val_img_dir and val_ann else ds)
    eval_name = "val" if val_ds is not ds else "train"

    @torch.inference_mode()
    def evaluate():
        """Box mAP@50 over the evaluation set, at the base size."""
        metric = DetectionAP(ds.n_classes)
        prev_size = val_ds.img_size
        val_ds.img_size = img_size
        vloader = DataLoader(val_ds, batch_size=batch_size, shuffle=False,
                             drop_last=False, num_workers=num_workers,
                             collate_fn=detection_collate)
        for i, b in enumerate(vloader):
            if eval_batches is not None and i >= eval_batches:
                break
            outs = detector_forward(model, b["image"].to(device), cfg)
            outs = [tuple(o.float().cpu().numpy() for o in lvl)
                    for lvl in outs]
            labels = b["labels"].numpy()
            gt_boxes = b["boxes"].numpy()
            for j in range(labels.shape[0]):
                per_img = [tuple(o[j:j + 1] for o in lvl) for lvl in outs]
                keep = labels[j] >= 0
                boxes, scores, pred_labels = decode_detections(per_img,
                                                               strides)
                metric.add_image(i * batch_size + j, boxes, scores,
                                 pred_labels, gt_boxes[j][keep],
                                 labels[j][keep])
        val_ds.img_size = prev_size
        return metric.mean_ap()

    if eval_only:
        ap = evaluate()
        print(f"[det] eval-only: {eval_name} mAP@50 {ap:.4f}")
        return {"best_map50": ap, "iters": 0, "eval_set": eval_name}

    if not _has_ckpt(save_dir, "det_frozen"):  # store the backbone once
        _save(save_dir, "det_frozen", {}, _state(model)[1], {})
    preempted, restore_sig = _preemption_flag()
    logger = RunLogger(save_dir, run_name="det")
    it, t0 = 0, time.time()
    best_map = _best_metric(save_dir, "det_best", "map50") if resume \
        else -1.0
    for epoch in range(start_epoch, epochs):
        if scales:
            # per-epoch seed: the scale sequence is a pure function of
            # (seed, epoch), so --resume replays it exactly
            ds.img_size = int(
                np.random.default_rng((seed, epoch)).choice(scales))
            print(f"[det] epoch {epoch}: train scale {ds.img_size}")
        loader.set_epoch(epoch)
        for b in loader:
            batch = {k: b[k].to(device) for k in ("image", "boxes",
                                                  "labels")}
            m = step(model, batch)
            it += 1
            if it % log_every == 0:
                loss = float(m["total"])
                rate = it * batch_size / (time.time() - t0)
                print(f"[det] it {it} ep {epoch} loss {loss:.4f} "
                      f"({rate:.1f} img/s)")
                logger.log({"epoch": epoch, "train_loss": round(loss, 5),
                            "cls_loss": round(float(m["cls_loss"]), 5),
                            "img_s": round(rate, 1)}, it)
            if preempted():
                # mid-epoch: save resumable state marked at epoch-1 so
                # --resume replays this (partial) epoch from its start
                _save(save_dir, "det_last", _state(model)[0], None,
                      {"epoch": epoch - 1, "map50": best_map,
                       "preempted": True},
                      opt_state=optimizer.state_dict())
                print("[det] preempted - saved det_last, exiting")
                restore_sig()
                return {"best_map50": best_map, "iters": it,
                        "preempted": True, "eval_set": eval_name}
        ap = evaluate()
        print(f"[det] epoch {epoch}: {eval_name} mAP@50 {ap:.4f}")
        logger.log({"epoch": epoch, f"{eval_name}_map50": round(ap, 5)}, it)
        meta = {"epoch": epoch, "map50": ap}
        trainable, frozen = _state(model)
        if ap >= best_map:
            best_map = ap
            _save(save_dir, "det_best", trainable, frozen, meta)
        _save(save_dir, "det_last", trainable, None, meta,
              opt_state=optimizer.state_dict())
    restore_sig()
    return {"best_map50": best_map, "iters": it, "eval_set": eval_name}


def _ints(text):
    return tuple(int(v) for v in text.split(","))


def main(argv=None):
    p = argparse.ArgumentParser(prog="apla_tpu_torch.segdet")
    sub = p.add_subparsers(dest="task", required=True)
    sub.add_parser("seg", help="not ported yet (ROADMAP A 1)")
    pd = sub.add_parser("det")
    pd.add_argument("--img_dir", required=True)
    pd.add_argument("--ann", required=True)
    pd.add_argument("--epochs", type=int, default=12)
    pd.add_argument("--img_size", type=int, default=224)
    pd.add_argument("--batch_size", type=int, default=8)
    pd.add_argument("--lr", type=float, default=1e-4)
    pd.add_argument("--save_dir", default="checkpoints/det")
    pd.add_argument("--swin_ckpt", help="local HF SwinModel state_dict .pth")
    pd.add_argument("--val_img_dir")
    pd.add_argument("--val_ann")
    pd.add_argument("--n_devices", type=int, default=1,
                    help="data-parallel size (only 1 is ported)")
    pd.add_argument("--param_sharding", default="replicated",
                    choices=("replicated", "fsdp"),
                    help="frozen-backbone placement (only replicated)")
    pd.add_argument("--resume", action="store_true",
                    help="continue from <save_dir>/det_last if present")
    pd.add_argument("--eval_only", action="store_true",
                    help="restore the best checkpoint and report mAP@50")
    pd.add_argument("--embed_dim", type=int, default=96)
    pd.add_argument("--depths", default="2,2,6")
    pd.add_argument("--num_heads", default="3,6,12")
    pd.add_argument("--window_size", type=int, default=7)
    pd.add_argument("--scales", default=None,
                    help="comma list for multi-scale training (one scale "
                         "drawn per epoch); each must divide by "
                         "patch*window*2^(stages-1), e.g. 224/448 for the "
                         "4-stage w7 recipe")
    pd.add_argument("--masks", action="store_true",
                    help="instance-mask branch (not ported yet)")
    pd.add_argument("--n_protos", type=int, default=32)
    pd.add_argument("--use_fused", action="store_true",
                    help="route Swin window attention + the APLA proj "
                         "through the fused window kernels (with --bf16 "
                         "on the card)")
    pd.add_argument("--bf16", action="store_true",
                    help="bf16 backbone compute (default f32)")
    pd.add_argument("--num_workers", type=int, default=8,
                    help="loader worker processes (0: in-process)")
    pd.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    args = p.parse_args(argv)
    if args.task == "seg":
        raise NotImplementedError(SEG_TODO)
    out = train_detection(
        args.img_dir, args.ann, epochs=args.epochs, img_size=args.img_size,
        batch_size=args.batch_size, lr=args.lr, save_dir=args.save_dir,
        swin_ckpt=args.swin_ckpt, val_img_dir=args.val_img_dir,
        val_ann=args.val_ann, embed_dim=args.embed_dim,
        depths=_ints(args.depths), num_heads=_ints(args.num_heads),
        window_size=args.window_size, n_devices=args.n_devices,
        param_sharding=args.param_sharding, resume=args.resume,
        eval_only=args.eval_only,
        scales=(args.scales.split(",") if args.scales else None),
        masks=args.masks, n_protos=args.n_protos, use_fused=args.use_fused,
        bf16=args.bf16, num_workers=args.num_workers, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
