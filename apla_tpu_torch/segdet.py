"""The segmentation and detection side-cars' train / evaluate / checkpoint
loops.

Counterpart of `apla_tpu/segdet.py`:

- `seg`: APLA-SETR-PUP on an ADE20K-layout directory (the reference recipe
  apla_setr_vit-l_pup_8xb2-160k_ade20k-512x512: ViT-L/16 at 512, APLA
  "full" (every block's whole attention output projection trains), the
  PUP head, `--aux_heads`, `--head_lr_mult`), dataset-level mIoU on the
  validation split every epoch, sliding-window evaluation when
  `--eval_img_size` exceeds the training crop.  With `--use_fused` every
  block's attention and projection run through the fused APLA kernels at
  k = C (`models.seg`).
- `det`: APLA-Swin + FCOS on a COCO-format dataset (the reference recipe
  mask-rcnn_apla_swin-t ... coco.py: only each block's attn.proj trains),
  box mAP@50 every epoch, multi-scale training (`--scales`), an HF Swin
  checkpoint (`--swin_ckpt`) and a separate validation set.  `--masks`
  (the recipe's `with_mask=True`) trains the prototype-mask branch too
  (`--n_protos` prototypes) and reports mask mAP@50 beside box mAP@50; the
  best-model race then runs on mask mAP.

    python -m apla_tpu_torch.segdet seg --root <ade_root> --use_fused \\
        --aux_heads 3 --head_lr_mult 10 [--eval_img_size 640] [--device cpu]
    python -m apla_tpu_torch.segdet det --img_dir <dir> --ann <instances.json> \\
        --depths 2,2,6,2 --num_heads 3,6,12,24 --use_fused --bf16 [--device cpu]

Both keep the best and the last checkpoint, `--resume` (which goes on with
the best-model race) and `--eval_only`.  Checkpoints are the port's own
(`torch.save` of name -> tensor maps and the optimizer state), written
atomically: `<task>_best.pt` (trainable and frozen, self-contained for
`serve export_seg` / `export_det`), `<task>_last.pt` (trainable and the
optimizer state; the frozen backbone is stored once, in
`<task>_frozen.pt`), each beside a `.json` meta with the JAX loop's keys
(`epoch`, `miou` or `map50`, `preempted`).

`--n_devices N` above one trains data parallel on N ranks
(`apla_tpu/segdet.py:30-45`): the loops start them through
`parallel.launch` (or run as the ranks `torchrun` started), each rank
loads its rows of every batch (the batch size must divide by N, as in
JAX), the losses' normalisers and the metrics' counts run over the global
batch, and only rank 0 writes; `--param_sharding fsdp` shards the frozen
backbone over the ranks (`parallel.mesh.shard_params`).  The entry
points run on the card unless asked for the CPU (`--device cpu`).
`--use_fused` on the card takes bfloat16 compute (the kernels are bf16 only: the ViT's default;
`det` needs `--bf16`), and the JAX loop's process-global
`APLA_FUSED_VMEM_MB` default has no counterpart: the card has no VMEM
model to feed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .data.detection_data import CocoDetection, detection_collate
from .data.loader import DataLoader
from .models.detection import (DetectionAP, decode_detections,
                               default_strides, detection_optimizer,
                               detector_outputs, init_detector,
                               make_detection_train_step, mask_generator)
from .apla.core import AplaConfig
from .data.segmentation_data import ADE20KSegmentation, segmentation_collate
from .models.seg import (init_segmenter, iou_counts, make_seg_train_step,
                         mean_iou_from_counts, seg_optimizer,
                         segmenter_forward, segmenter_slide_forward)
from .models.swin import SwinConfig, build_apla_swin
from .models.vit import VIT_BUILDERS, ViTConfig
from .parallel import collectives
from .parallel.launch import launch, torchrun_env
from .parallel.mesh import local_state, make_mesh, shard_params, whole_state
from .utils.logging import RunLogger

def _state(model):
    """(trainable, frozen) name -> CPU tensor maps of `model`; the frozen
    map also holds rank-k APLA's `attn.inds` (APLA "full" stores none).
    FSDP's frozen shards are gathered whole: every rank calls it."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        (trainable if p.requires_grad else frozen)[name] = p.detach()
    frozen = whole_state(model, frozen)
    for name, b in model.state_dict().items():
        if name.endswith("attn.inds"):
            frozen[name] = b
    return ({n: t.to("cpu", copy=True) for n, t in trainable.items()},
            {n: t.to("cpu", copy=True) for n, t in frozen.items()})


def _place(model, mesh, policy, task):
    """The frozen backbone placed by `policy` over the mesh's ranks ("tp"
    and "pp" over this data-only mesh are "replicated", as JAX's
    `shard_params` gives them: the model axis has one rank)."""
    plan = shard_params(model, mesh, "replicated" if policy in ("tp", "pp")
                        else policy)
    if mesh.distributed:
        print(f"[{task}] {mesh.world} ranks ({mesh.backend}); frozen params "
              f"placed with policy '{policy}': {len(plan)} tensors sharded")


def _parallel_setup(n_devices, param_sharding, batch_size, device):
    """The data axis of a loop (`apla_tpu/segdet.py:_mesh_setup`): None
    when this process must first start the ranks (`n_devices` > 1 or
    torchrun, no group yet), else the mesh."""
    if param_sharding not in ("replicated", "fsdp", "tp", "pp"):
        raise ValueError(f"unknown param_sharding policy: "
                         f"{param_sharding!r}")
    n = int(n_devices or 1)
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"n_devices {n}")
    if not collectives.initialized() and (n > 1 or torchrun_env()):
        return None
    return make_mesh(n)


def _atomic(path, write):
    write(path + ".tmp")
    os.replace(path + ".tmp", path)


def _save(save_dir, name, trainable, frozen, meta, opt_state=None):
    """Atomic checkpoint write (tmp + os.replace: a preemption mid-write
    must not corrupt the file).  `frozen=None` omits the backbone (the
    per-epoch 'last' checkpoints store it once in <task>_frozen.pt)."""
    if not collectives.is_rank0():
        return
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
    params = {**dict(model.named_buffers()), **dict(model.named_parameters())}
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
    _load_into(model, host["trainable"], local_state(model, frozen))
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


def seg_vit_config(backbone="vit_large", img_size=512, patch_size=16,
                   use_fused=False) -> ViTConfig:
    """The segmenter's ViT: a `VIT_BUILDERS` width at the crop size, bf16
    compute (the ViTConfig default, as in JAX)."""
    return VIT_BUILDERS[backbone](img_size=img_size, patch_size=patch_size,
                                  use_fused_apla=use_fused)


def train_segmentation(root, epochs=8, img_size=512, batch_size=8, lr=1e-4,
                       weight_decay=1e-4, backbone="vit_large",
                       patch_size=16, partial_size="full", channels=256,
                       save_dir="checkpoints/seg", num_workers=8,
                       log_every=10, eval_batches=None, seed=0,
                       vit_cfg=None, n_devices=1,
                       param_sharding="replicated", resume=False,
                       eval_only=False, eval_img_size=None,
                       eval_stride=None, aux_heads=0, head_lr_mult=1.0,
                       use_fused=False, device=None):
    """APLA-SETR-PUP on an ADE20K-layout directory.  Returns {'best_miou',
    'iters'} (and 'preempted' after a SIGTERM)."""
    call = dict(locals())
    from .wrapper import resolve_device

    mesh = _parallel_setup(n_devices, param_sharding, batch_size, device)
    if mesh is None:
        return launch(train_segmentation, n_devices, kwargs=call,
                      device=device or "cuda")
    device = resolve_device(device)
    if vit_cfg is not None:
        # an explicit config still honours --use_fused
        cfg = (dataclasses.replace(vit_cfg, use_fused_apla=True)
               if use_fused and not vit_cfg.use_fused_apla else vit_cfg)
    else:
        cfg = seg_vit_config(backbone, img_size, patch_size, use_fused)
    if (cfg.use_fused_apla and device.type == "cuda"
            and cfg.compute_dtype != torch.bfloat16):
        raise ValueError("--use_fused on the card needs bfloat16 compute: "
                         "the fused APLA kernels take bfloat16 only")
    train_ds = ADE20KSegmentation(root, "training", img_size=img_size)
    # eval_img_size > img_size: sliding-window evaluation (the reference
    # recipe's test_cfg mode='slide': train at the crop, evaluate larger)
    eval_size = int(eval_img_size) if eval_img_size else img_size
    if eval_size < img_size:
        raise ValueError(f"eval_img_size {eval_size} < crop {img_size}")
    val_ds = ADE20KSegmentation(root, "validation", img_size=eval_size)
    loader = DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                        drop_last=True, num_workers=num_workers,
                        collate_fn=segmentation_collate, seed=seed
                        ).shard(mesh)
    model = init_segmenter(cfg, train_ds.n_classes,
                           AplaConfig(partial_size=partial_size),
                           channels=channels, n_aux_heads=aux_heads,
                           generator=torch.Generator().manual_seed(seed),
                           device=device)
    _place(model, mesh, param_sharding, "seg")
    # the reference recipe: the decoder heads at lr x head_lr_mult
    optimizer = seg_optimizer(model, lr, weight_decay, head_lr_mult)
    start_epoch = 0
    if eval_only:
        # restore the best (else the last) checkpoint and report val mIoU
        name = "seg_best" if _has_ckpt(save_dir, "seg_best") else "seg_last"
        if not _has_ckpt(save_dir, name):
            raise FileNotFoundError(
                f"--eval_only: no checkpoint under {save_dir}")
        _try_resume(save_dir, name, model)
    elif resume:
        start_epoch = _try_resume(save_dir, "seg_last", model, optimizer)
    step = make_seg_train_step(cfg, optimizer)

    @torch.inference_mode()
    def evaluate():
        """Dataset-level mIoU over the validation split: pixel counts
        summed over batches, divided once."""
        inter = union = 0
        vloader = DataLoader(val_ds, batch_size=batch_size, shuffle=False,
                             drop_last=False, num_workers=num_workers,
                             collate_fn=segmentation_collate).shard(mesh)
        for i, b in enumerate(vloader):
            if eval_batches is not None and i >= eval_batches:
                break
            im = b["image"].to(device)
            logits = (segmenter_slide_forward(model, im, cfg,
                                              stride=eval_stride)
                      if eval_size > img_size
                      else segmenter_forward(model, im, cfg))
            keep = b["valid"].numpy() if "valid" in b else slice(None)
            bi, bu = iou_counts(logits.argmax(-1).cpu().numpy()[keep],
                                b["label"].numpy()[keep],
                                n_classes=train_ds.n_classes)
            inter, union = inter + bi, union + bu
        if mesh.distributed:      # the counts of every rank's rows
            inter, union = (collectives.psum(torch.as_tensor(
                np.asarray(c), device=device)).cpu().numpy()
                for c in (inter, union))
        return mean_iou_from_counts(inter, union) if np.ndim(union) else 0.0

    if eval_only:
        miou = evaluate()
        print(f"[seg] eval-only: val mIoU {miou:.4f}")
        return {"best_miou": miou, "iters": 0}

    # store the backbone once
    if not collectives.broadcast_object(_has_ckpt(save_dir, "seg_frozen")):
        _save(save_dir, "seg_frozen", {}, _state(model)[1], {})
    preempted, restore_sig = _preemption_flag()
    logger = RunLogger(save_dir, run_name="seg") \
        if collectives.is_rank0() else None
    it, t0 = 0, time.time()
    # under --resume the best-model race goes on from the saved best
    best_miou = _best_metric(save_dir, "seg_best", "miou") if resume \
        else -1.0
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        for b in loader:
            m = step(model, {"image": b["image"].to(device),
                             "label": b["label"].to(device)})
            it += 1
            if it % log_every == 0:
                loss = float(m["loss"])
                rate = it * batch_size / (time.time() - t0)
                print(f"[seg] it {it} ep {epoch} loss {loss:.4f} "
                      f"({rate:.1f} img/s)")
                if logger:
                    logger.log({"epoch": epoch, "train_loss": round(loss, 5),
                                "grad_norm": round(float(m["grad_norm"]), 4),
                                "img_s": round(rate, 1)}, it)
            if collectives.any_rank(preempted(), device):
                # mid-epoch: save resumable state marked at epoch-1 so
                # --resume replays this (partial) epoch from its start
                _save(save_dir, "seg_last", _state(model)[0], None,
                      {"epoch": epoch - 1, "miou": best_miou,
                       "preempted": True},
                      opt_state=optimizer.state_dict())
                print("[seg] preempted - saved seg_last, exiting")
                restore_sig()
                return {"best_miou": best_miou, "iters": it,
                        "preempted": True}
        miou = evaluate()
        print(f"[seg] epoch {epoch}: val mIoU {miou:.4f}")
        if logger:
            logger.log({"epoch": epoch, "val_miou": round(miou, 5)}, it)
        trainable, frozen = _state(model)
        if miou >= best_miou:
            best_miou = miou
            _save(save_dir, "seg_best", trainable, frozen,
                  {"epoch": epoch, "miou": miou})
        _save(save_dir, "seg_last", trainable, None,
              {"epoch": epoch, "miou": miou},
              opt_state=optimizer.state_dict())
    restore_sig()
    return {"best_miou": best_miou, "iters": it}


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
    'iters', 'eval_set'} (and 'preempted' after a SIGTERM); `masks=True`
    trains the instance-mask branch (`n_protos` prototypes) and adds
    'best_mask_map50'."""
    call = dict(locals())
    from .wrapper import resolve_device

    mesh = _parallel_setup(n_devices, param_sharding, batch_size, device)
    if mesh is None:
        return launch(train_detection, n_devices, kwargs=call,
                      device=device or "cuda")
    device = resolve_device(device)
    if use_fused and not bf16 and device.type == "cuda":
        raise ValueError("--use_fused on the card needs --bf16: the window "
                         "kernel takes bfloat16 only")
    ds = CocoDetection(img_dir, ann_file, img_size=img_size,
                       max_boxes=max_boxes, with_masks=masks)
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
                        collate_fn=detection_collate, seed=seed).shard(mesh)
    model = init_detector(cfg, ds.n_classes,
                          torch.Generator().manual_seed(seed),
                          n_protos=n_protos if masks else 0,
                          mask_generator=mask_generator(seed))
    if swin_state is not None:
        model.backbone.load_state_dict(swin_state)
        build_apla_swin(model.backbone)
        print(f"Imported HF Swin weights from {swin_ckpt}")
    model = model.to(device)
    _place(model, mesh, param_sharding, "det")
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
    step = make_detection_train_step(cfg, optimizer, strides=strides,
                                     with_mask=masks)

    # a real validation split when provided; otherwise eval reuses the
    # train set and is labelled as such
    val_ds = (CocoDetection(val_img_dir, val_ann, img_size=img_size,
                            max_boxes=max_boxes, with_masks=masks)
              if val_img_dir and val_ann else ds)
    eval_name = "val" if val_ds is not ds else "train"

    @torch.inference_mode()
    def evaluate():
        """(box mAP@50, mask mAP@50 or None) over the evaluation set, at
        the base size: the metric pair of the reference's Mask R-CNN
        recipe."""
        metric = DetectionAP(ds.n_classes)
        mask_metric = DetectionAP(ds.n_classes, use_masks=True) \
            if masks else None
        prev_size = val_ds.img_size
        val_ds.img_size = img_size
        vloader = DataLoader(val_ds, batch_size=batch_size, shuffle=False,
                             drop_last=False, num_workers=num_workers,
                             collate_fn=detection_collate).shard(mesh)
        for i, b in enumerate(vloader):
            if eval_batches is not None and i >= eval_batches:
                break
            outs, protos = detector_outputs(model, b["image"].to(device),
                                            cfg)
            outs = [tuple(o.float() for o in lvl) for lvl in outs]
            truth = [b["labels"], b["boxes"]] + ([b["masks"]] if masks
                                                 else [])
            if "valid" in b:     # the global batch, in order, unpadded
                flat = collectives.gather_rows(
                    b["valid"], *[o for lvl in outs for o in lvl],
                    *([protos] if masks else []), *truth)
                k = len(outs[0])
                outs = [tuple(flat[j * k:(j + 1) * k])
                        for j in range(len(outs))]
                rest = flat[len(outs) * k:]
                if masks:
                    protos, rest = rest[0], rest[1:]
                truth = rest
            outs = [tuple(o.cpu().numpy() for o in lvl) for lvl in outs]
            labels = truth[0].numpy()
            gt_boxes = truth[1].numpy()
            gt_masks = truth[2].numpy() if masks else None
            for j in range(labels.shape[0]):
                per_img = [tuple(o[j:j + 1] for o in lvl) for lvl in outs]
                keep = labels[j] >= 0
                if masks:
                    boxes, scores, pred_labels, pmasks = decode_detections(
                        per_img, strides, protos=protos[j:j + 1],
                        mask_stride=strides[0])
                    mask_metric.add_image(
                        i * batch_size + j, boxes, scores, pred_labels,
                        gt_boxes[j][keep], labels[j][keep],
                        pred_masks=pmasks, gt_masks=gt_masks[j][keep])
                else:
                    boxes, scores, pred_labels = decode_detections(per_img,
                                                                   strides)
                metric.add_image(i * batch_size + j, boxes, scores,
                                 pred_labels, gt_boxes[j][keep],
                                 labels[j][keep])
        val_ds.img_size = prev_size
        return metric.mean_ap(), (mask_metric.mean_ap() if masks else None)

    if eval_only:
        ap, mask_ap = evaluate()
        msg = f"[det] eval-only: {eval_name} mAP@50 {ap:.4f}"
        out = {"best_map50": ap, "iters": 0, "eval_set": eval_name}
        if masks:
            msg += f" mask mAP@50 {mask_ap:.4f}"
            out["best_mask_map50"] = mask_ap
        print(msg)
        return out

    # store the backbone once
    if not collectives.broadcast_object(_has_ckpt(save_dir, "det_frozen")):
        _save(save_dir, "det_frozen", {}, _state(model)[1], {})
    preempted, restore_sig = _preemption_flag()
    logger = RunLogger(save_dir, run_name="det") \
        if collectives.is_rank0() else None
    it, t0 = 0, time.time()
    # with masks on, the best-model race runs on mask mAP (the recipe's
    # instance-segmentation target); box mAP is reported beside it, on
    # resume from the best checkpoint's meta
    best_key = "mask_map50" if masks else "map50"
    best_map = _best_metric(save_dir, "det_best", best_key) if resume \
        else -1.0
    best_box = _best_metric(save_dir, "det_best", "map50") if resume \
        else -1.0

    def result(**extra):
        out = {"best_map50": best_box if masks else best_map, "iters": it,
               **extra, "eval_set": eval_name}
        if masks:
            out["best_mask_map50"] = best_map
        return out

    for epoch in range(start_epoch, epochs):
        if scales:
            # per-epoch seed: the scale sequence is a pure function of
            # (seed, epoch), so --resume replays it exactly
            ds.img_size = int(
                np.random.default_rng((seed, epoch)).choice(scales))
            print(f"[det] epoch {epoch}: train scale {ds.img_size}")
        loader.set_epoch(epoch)
        for b in loader:
            keys = ("image", "boxes", "labels") + (("masks",) if masks
                                                   else ())
            m = step(model, {k: b[k].to(device) for k in keys})
            it += 1
            if it % log_every == 0:
                loss = float(m["total"])
                rate = it * batch_size / (time.time() - t0)
                extra = (f" mask {float(m['mask_loss']):.4f}"
                         if masks else "")
                print(f"[det] it {it} ep {epoch} loss {loss:.4f}{extra} "
                      f"({rate:.1f} img/s)")
                rec = {"epoch": epoch, "train_loss": round(loss, 5),
                       "cls_loss": round(float(m["cls_loss"]), 5),
                       "img_s": round(rate, 1)}
                if masks:
                    rec["mask_loss"] = round(float(m["mask_loss"]), 5)
                if logger:
                    logger.log(rec, it)
            if collectives.any_rank(preempted(), device):
                # mid-epoch: save resumable state marked at epoch-1 so
                # --resume replays this (partial) epoch from its start
                _save(save_dir, "det_last", _state(model)[0], None,
                      {"epoch": epoch - 1, best_key: best_map,
                       "preempted": True},
                      opt_state=optimizer.state_dict())
                print("[det] preempted - saved det_last, exiting")
                restore_sig()
                return result(preempted=True)
        ap, mask_ap = evaluate()
        msg = f"[det] epoch {epoch}: {eval_name} mAP@50 {ap:.4f}"
        rec = {"epoch": epoch, f"{eval_name}_map50": round(ap, 5)}
        meta = {"epoch": epoch, "map50": ap}
        if masks:
            msg += f" mask mAP@50 {mask_ap:.4f}"
            rec[f"{eval_name}_mask_map50"] = round(mask_ap, 5)
            meta["mask_map50"] = mask_ap
        print(msg)
        if logger:
            logger.log(rec, it)
        trainable, frozen = _state(model)
        sel = mask_ap if masks else ap
        if sel >= best_map:
            best_map, best_box = sel, ap
            _save(save_dir, "det_best", trainable, frozen, meta)
        _save(save_dir, "det_last", trainable, None, meta,
              opt_state=optimizer.state_dict())
    restore_sig()
    return result()


def _ints(text):
    return tuple(int(v) for v in text.split(","))


def main(argv=None):
    from .wrapper import set_float32_precision
    set_float32_precision()
    p = argparse.ArgumentParser(prog="apla_tpu_torch.segdet")
    sub = p.add_subparsers(dest="task", required=True)
    ps = sub.add_parser("seg")
    ps.add_argument("--root", required=True)
    ps.add_argument("--epochs", type=int, default=8)
    ps.add_argument("--img_size", type=int, default=512)
    ps.add_argument("--batch_size", type=int, default=8)
    ps.add_argument("--lr", type=float, default=1e-4)
    ps.add_argument("--backbone", default="vit_large")
    ps.add_argument("--patch_size", type=int, default=16)
    ps.add_argument("--save_dir", default="checkpoints/seg")
    ps.add_argument("--n_devices", type=int, default=1,
                    help="data-parallel ranks (the batch size divides)")
    ps.add_argument("--param_sharding", default="replicated",
                    choices=("replicated", "fsdp"),
                    help="frozen-backbone placement over the ranks")
    ps.add_argument("--resume", action="store_true",
                    help="continue from <save_dir>/seg_last if present")
    ps.add_argument("--eval_only", action="store_true",
                    help="restore the best checkpoint and report val mIoU")
    ps.add_argument("--eval_img_size", type=int, default=None,
                    help="evaluate at this size with sliding windows of "
                         "the training crop (reference test_cfg "
                         "mode='slide')")
    ps.add_argument("--eval_stride", type=int, default=None,
                    help="slide stride (default 2/3 of the crop)")
    ps.add_argument("--aux_heads", type=int, default=0,
                    help="auxiliary SETR-UP decoders on intermediate "
                         "layers (reference recipe: 3, loss weight 0.4)")
    ps.add_argument("--use_fused", action="store_true",
                    help="route every block's attention and its whole "
                         "projection through the fused APLA kernels "
                         "(k = C under APLA 'full')")
    ps.add_argument("--head_lr_mult", type=float, default=1.0,
                    help="decoder-head lr multiplier (reference: 10)")
    ps.add_argument("--num_workers", type=int, default=8,
                    help="loader worker processes (0: in-process)")
    ps.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
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
                    help="data-parallel ranks (the batch size divides)")
    pd.add_argument("--param_sharding", default="replicated",
                    choices=("replicated", "fsdp"),
                    help="frozen-backbone placement over the ranks")
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
                    help="train the instance-mask branch and report mask "
                         "mAP@50 (reference recipe with_mask=True)")
    pd.add_argument("--n_protos", type=int, default=32,
                    help="prototype-mask channels for --masks")
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
        print(json.dumps(train_segmentation(
            args.root, epochs=args.epochs, img_size=args.img_size,
            batch_size=args.batch_size, lr=args.lr, backbone=args.backbone,
            patch_size=args.patch_size, save_dir=args.save_dir,
            n_devices=args.n_devices, param_sharding=args.param_sharding,
            resume=args.resume, eval_only=args.eval_only,
            eval_img_size=args.eval_img_size, eval_stride=args.eval_stride,
            aux_heads=args.aux_heads, head_lr_mult=args.head_lr_mult,
            use_fused=args.use_fused, num_workers=args.num_workers,
            device=args.device)))
        return
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
