#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`apla_tpu_torch`).

Drives the port's serving path, its supervised training path, its
DINOv2, BYOL, SimSiam and DINO v1 self-supervised paths, its
full-projection path, its Swin detection side-car, its ViT-L segmentation
side-car, its W8A8 serving and training paths, and the checkpoint import,
transfer, export and evaluation paths once on one CUDA card, in phases that
each print a line and raise on failure:

  1. build   — compile the hand-written kernels from `apla_tpu_torch/csrc`
               (eight sources), one nvcc per source, all started together.
  2. kernel  — the fused APLA attention forward (two launches: the
               attention kernel, then the projection GEMM) against its
               plain PyTorch version on the card, bf16, at the served
               length (N=257), the SSL local crops (N=50), the 518-crop
               length (N=1370) and a segmented case; the GEMM alone against
               its plain version at ragged row counts with three fault
               controls, and its registers; timed at b64, b1, b8, [512,
               50] and [2, 1370] (launched one by one, from a CUDA graph,
               the host's time per call, each launch apart) beside its
               bound and a two-call library yardstick.
  3. slice   — the ViT-B/14 APLA-128 ImageNet classifier (random weights from
               a seed, the shipped rank-128 index file) exported at batch
               sizes 1/8/64, reloaded, and asked for 1, 9 and 100 images.
               Every block of every call must have run the kernel; outputs
               must be finite and agree with the same model on the plain
               attention path; b64 throughput of both arms is timed.
  4. bwd     — the backward kernels against their plain version, dq, dk,
               dv and dW_t each, at the training shapes, N=1370, a
               segmented case and the shipped block-0 indices, with five
               fault controls (two aimed at the tiling: a tile left out of
               one product, where the other side is resident and where it
               is streamed); timed at b64, [512, 50] and [2, 1370] (events,
               a CUDA graph, each of the five launches apart) beside the
               bound, the launch plans and the two-call yardstick; the
               kernels' registers, spills and shared memory.
  5. train   — the recipe's supervised fine-tune (ViT-B/14 APLA-128, AdamW,
               warmup + cosine, clip 1.0, accum 8, device augmentation,
               mixup/cutmix) on the hermetic Synthetic dataset through
               DefaultWrapper -> Trainer.train() -> Trainer.test(): both
               kernels in every block of every micro-step, finite losses,
               frozen weights unchanged bit for bit, every trainable tensor
               moved, a checkpoint that reloads; the first step's loss and
               gradients of the fused arm against the plain arm; train-step
               img/s and peak memory of both arms at accum 8 and 1.
  6a. proto_ce — the three prototype cross-entropy kernels (forward, dxs,
               dws) against their plain versions at the DINOv2 recipe's
               sites (iBOT R=16384, DINO global R=128, pair-expanded local
               R=1024; K=65536), a ragged case, and the iBOT site at the
               collate's layout (g = 0 past the masked patches), at two
               teacher temperatures, with six fault controls (one drops a
               streamed tile from the forward); the launch plans; timed at
               the iBOT site (events and a CUDA graph), at both layouts,
               each kernel also with one and two consumer warpgroups a
               block (the forward's L2 -> SM rate from its bytes), beside
               the bound and, for the forward, a multi-call PyTorch
               yardstick (two bf16 matmuls, logsumexp and the
               softmax-weighted sum in f32).
  6b. ssl    — the ISIC2019 DINOv2 recipe (ViT-B/14 APLA-128, DINO + iBOT
               heads over 65536 prototypes, KoLeo, device multi-crop) on
               Synthetic data through DINOv2Wrapper -> Dinov2Trainer.train()
               -> test(): the fused APLA kernels on every crop and the
               prototype-CE kernels at the iBOT site in every step, finite
               loss terms, frozen weights unchanged, a teacher and centers
               that moved, a checkpoint that reloads; the first step's loss
               terms and gradients of the fused arm against the plain arm;
               train-step img/s and peak memory of both arms; a profile.
  7a. mha    — the memory-efficient attention kernels (forward, backward)
               against their plain versions at N=257 (b1, b8, b64), N=50
               (b512), N=1370, a segmented and two ragged cases, and the
               launch-plan boundaries (N=320, 321, 768, 769: the forward's,
               and the backward's at 320/321); the forward and the backward
               timed (launched one by one and from a CUDA graph; the
               backward's two launches apart too) beside the bound and
               F.scaled_dot_product_attention (its autograd for the
               backward) at every shape the port's paths give them, with
               their launch plans.
  7b. full   — the ImageNet recipe at `partial_size: "full"` (FULL_RECIPE:
               the whole projection of every block trainable, the recipe's
               `is_memory_efficient: true`) served as in phase 3 and trained
               as in phase 5, through the memory-efficient attention
               kernels in every block; a profile of the kernel arm's step.
  8a. swin   — the Swin window kernels (rows 3, 4: attention with the
               relative-position bias and the shift mask, the whole
               projection, and its backward) against their plain versions
               at the four stage shapes of the b16 detector (shifted and
               not) and at b1, six fault controls; timed at each stage
               beside the bound and a two-call yardstick.
  8b. det    — the APLA-Swin-T FCOS detector (`segdet det --use_fused
               --bf16`, DET_RECIPE) on a synthetic COCO-format set through
               `segdet.train_detection`: the first step's loss, gradients
               and pyramid of the kernel arm against the plain arm (two
               backward faults), one epoch trained, evaluated and
               checkpointed with the window kernels in every block of every
               step and eval call, --resume, --eval_only, the plain arm,
               the best checkpoint exported and served (`DetPredictor.
               detect`, raw maps against the in-process forward), and
               exported again through `serve export_det --quantize_frozen`
               (W8A8, f32) and served with the int8 kernel in each qkv, fc1
               and fc2 of every call; train and serve img/s, peak memory
               and a profile.

  9a. seg_kernels — the fused APLA kernels (rows 1, 2) at the shape the
               segmentation side-car gives them, where JAX names the q-strip
               long kernels (TPU rows 5-7): ViT-L/16 at 512, qkv
               [8, 1025, 3072] and [1, 1025, 3072], every one of the 1024
               projection columns trainable; the forward and backward fault
               controls, shared memory, registers and the launch plans at
               C = 1024, times at b8 (the forward's two launches and the
               backward's five apart too, events and CUDA graphs) beside the
               bound and the two-call yardstick.
  9b. seg    — the APLA SETR-PUP segmenter on ViT-L/16 at 512 (`segdet seg
               --use_fused --aux_heads 3 --head_lr_mult 10`, SEG_RECIPE) on
               a synthetic ADE20K-layout set through
               `segdet.train_segmentation`: the first step's loss and
               gradients of the kernel arm against the plain arm (two
               backward and three forward faults), one epoch trained,
               evaluated (mIoU) and
               checkpointed with the fused kernels in all 24 blocks of every
               step and eval call, --resume, --eval_only, a sliding-window
               evaluation at 640, the best checkpoint exported and served
               (`SegPredictor.predict` / `predict_slide` at 1 and 9 images
               against the in-process module through the same calls), and
               exported again through `serve export_seg --quantize_frozen`
               and served with the int8 kernel in each qkv, fc1 and fc2;
               train and serve img/s of
               both arms, peak memory and a profile.
  10a. int8  — the int8 GEMM (TPU row 13; with one group over K the W8A8
               path's qkv / fc1 / fc2) against its plain version at the
               classifier's three products at b64 and b1, the segmenter's
               fc2 at b8, the Swin-T stage-0 qkv in f32, and row 13's own
               groups of 256 with a ragged M; five fault controls;
               registers and spills; times beside the bound, the bf16
               torch.matmul and torch._int_mm.
  10b. w8a8  — the phase-3 classifier exported float and with
               `quantize_frozen=True`, reloaded and asked for 1, 9 and 100
               images: 36 int8 and 12 attention launches per call, served
               outputs equal to the in-process quantized module, the kernel
               arm against the int8 kernel's plain version (codes that
               differ counted, a fault control) and against the plain arm,
               the W8A8 artifact's cosine to the float one, params.npz
               bytes, b64 img/s of the W8A8 kernel, plain and float arms
               and their memory.
  11. ssl_v1 — rows 1, 2 against their plain versions at DINO v1's local
               crops ([512, 37, 2304]: 37 of a 64-key tile live), timed
               beside the bound and the two-call yardstick; then phase
               6b's ViT-B/14 APLA-128 backbone under BYOL and SimSiam
               (BYOL_RECIPE, 2 x 224 crops) and DINO v1 (DINO_RECIPE, 2 x
               224 + 8 x 96) on Synthetic data through the wrappers ->
               trainer.train() -> test(checkpoint): the first step's
               loss, every backbone call's embeddings and the backbone's
               gradients under the plain arm's head cotangent, kernel arm
               against plain arm, with three faults per objective (the
               target branch's or teacher's forward halved; dW_t zeroed,
               or DINO's local-crop backward zeroed; dW_t scaled by
               0.95), the fused kernels in every block of every call (4
               forwards and 2 backwards a step, 3 and 2 for DINO, 12
               forwards per kNN embed call), finite losses, frozen weights
               kept, the trainables, the teacher (not SimSiam's) and the BN
               running stats or the center moved, the checkpoint reloaded
               by test() with the kNN table; train-step img/s and peak
               memory of both arms, a profile of DINO's step.
  12. import — the shipped recipes from real weights: a seeded ViT-B/14
               state dict (518 grid, LayerScale, a mask token) written in
               the torch.hub, chunked and HF `Dinov2Model` layouts.  12a:
               the ImageNet recipe as shipped (`pretrained: true`, the
               checkpoint path pointed at the file) through `python -m
               apla_tpu_torch.main`: every imported tensor bit-equal to the
               file's, the APLA-128 columns the projection's, the three
               layouts giving bit-equal models, two accum-8 updates
               through rows 1 and 2.  12b: phase 6b's DINOv2 checkpoint
               adopted by a supervised fine-tune (`--pretrained_path`,
               backbone-only, bit-equal), one update, `serve export
               --pretrained_path`, b64 served at 518 against the in-process
               module.  12c: W8A8 training (`quantize_frozen`) through
               DefaultWrapper -> Trainer: row 13 in every frozen qkv, fc1
               and fc2 of every micro-step and eval call, rows 1 and 2 in
               every block, the kernel arm against the plain arm with
               three faults, the int8 codes kept, the checkpoint, img/s and
               peak memory beside phase 5's float step.  12d: `serve eval`
               of 12b's classifier (with `--knn`), 8b's detector (mAP@50)
               and 9b's segmenter (mIoU, plain and sliding), each reading
               what its loop's own evaluation of the same weights reads.

Phases 2-12 also run negative controls: the kernels made to compute what
broken ones would (output zeroed or halved, uniform attention, half the
heads dropped, padding columns left unmasked; dqkv halved, dq zeroed, dW_t
from the wrong columns or zeroed, rowsum(dp * p) dropped from ds, a key
tile left out of dq, a query tile left out of dk; the
teacher temperature taken as 1, dws zeroed, dxs halved, p_t dropped from
ds; the SSL target branch's forward halved, a local-crop backward
zeroed; the projection GEMM's output halved, its last row unwritten, its last
contraction step skipped; the Swin bias or mask dropped, the mask read at
the wrong window, dW zeroed; the int8 weight scales dropped, one
activation scale for the whole tensor, codes truncated, the last K group
skipped, the ragged tail rows unwritten; in W8A8 training the codes
truncated, the int8 product scaled by 0.9, dW_t zeroed).  Each must fail
the phase's bound, so the bounds are shown to catch a broken kernel in
every run.

Then it prints the card's name and power limit, a JSON line describing the
kernels, and the contract line `{"ok": true, "device": {...}}` last.

Run from the repository root:  python3 chip_smoke.py
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# params/finetune/dinov2/ImageNet/vit_b/apla.yml merged over its
# __common__.yml, every field the port reads (the card's machine has no
# PyYAML; a CPU test holds this dict against the YAML: every value here is
# the YAML's).  Left out: the dinov2 checkpoint (`pretrained`, not in the
# repository; the weights are random from a seed) and the host-side
# transforms that raw mode never runs.  The pos-embed grid is the recipe's
# 518; the model is served and trained at the 224 crop.  `SMOKE_CUTS` below
# says what the training phase changes.
_EVAL_TRANSFORMS = {"Resize": {"apply": True, "height": 256, "width": 256},
                    "CenterCrop": {"apply": True, "height": 224,
                                   "width": 224},
                    "Normalize": True}
_LOADER = {"batch_size": 64, "num_workers": 8, "prefetch_factor": 4}
RECIPE = {
    "dataset_params": {
        "dataset": "ImageNet",
        "device_augment": True,
        "train_transforms": {
            "Resize": {"apply": True, "height": 256, "width": 256},
            "HorizontalFlip": {"apply": True, "p": 0.5},
            "ColorJitter": {"apply": False, "brightness": 0.2,
                            "contrast": 0.2, "saturation": 0.1, "hue": 0.1,
                            "p": 0.8},
            "RandomResizedCrop": {"apply": True, "size": 224,
                                  "scale": [0.8, 1.2]},
            "RandomGrayscale": {"apply": False},
            "Normalize": True,
            "advanced_aug": True,
            "advanced_aug_params": {"mixup_alpha": 0.8, "cutmix_alpha": 1,
                                    "prob": 0.4, "label_smoothing": 0.1},
        },
        "val_transforms": _EVAL_TRANSFORMS,
        "test_transforms": _EVAL_TRANSFORMS,
    },
    "dataloader_params": {
        "trainloader": {**_LOADER, "shuffle": True, "drop_last": True},
        "valloader": {**_LOADER, "shuffle": False, "drop_last": False},
        "testloader": {**_LOADER, "shuffle": False, "drop_last": False},
    },
    "optimization_params": {"default": {
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 1e-4, "weight_decay": 1e-5}},
        "scheduler": {
            "type": ["LinearWarmup", "CosineAnnealingLR"],
            "params": {
                "ReduceLROnPlateau": {"mode": "max", "factor": 0.1,
                                      "patience": 2},
                "OneCycleLR": {"anneal_strategy": "linear",
                               "final_div_factor": 1e-4},
                "MultiStepLR": {"milestones": [], "gamma": 0.1},
                "CosineAnnealingLR": {"eta_min": 1e-6},
                "LinearWarmup": {"warmup_epochs": 0, "warmup_iters": 500},
            }},
    }},
    "model_params": {
        "backbone_type": "vit_base",
        "transformers_params": {
            "img_size": [518],
            "patch_size": 14,
            "is_memory_efficient": True,
            "gelu_tanh": True,
            "use_fused_apla": True,
            "block_conf": {"has_layerscale": True,
                           "layerscale_init_values": 1.0},
        },
        "adaptation": {
            "mode": "apla",
            "params": {
                "partial_size": 128,
                "inds_path": "params/finetune/dinov2/ImageNet/vit_b/"
                             "inds-vit_b-rand_128.json",
            },
        },
    },
    "training_params": {
        "accum_steps": 8,
        "model_name": "imagenet_vitb_apla",
        "epochs": 100,
        "val_every": 0.2,
        "log_every": 25,
        "save_best_model": True,
        "knn_eval": False,
        "grad_clipping": 1.0,
        "use_mixed_precision": True,
    },
}
# What the training phase changes, and why: the dataset (ImageNet is not in
# the repository) becomes the hermetic Synthetic set at the recipe's raw
# 256 and 1000 classes, a few hundred images; one short epoch with one
# validation; every step logged (each loss is checked).
TRAIN_IMAGES = 256
SMOKE_CUTS = {
    "dataset_params": {"dataset": "Synthetic", "synthetic_classes": 1000,
                       "synthetic_size": TRAIN_IMAGES,
                       "synthetic_img_size": 256},
    "training_params": {"epochs": 1, "val_every": 1.0, "log_every": 1},
}

# params/pretrain/dinov2/ISIC2019/vit_b/apla.yml merged over its
# __common__.yml, every field the port reads (a CPU test holds it against
# the YAML, value by value).  `SSL_CUTS` says what phase 6b changes.
_SSL_EVAL = {"Resize": {"apply": True, "height": 256, "width": 256},
             "CenterCrop": {"apply": True, "height": 224, "width": 224},
             "Normalize": True}
_SSL_HEAD = {"head_n_prototypes": 65536, "head_bottleneck_dim": 256,
             "head_nlayers": 3, "head_hidden_dim": 2048}
SSL_RECIPE = {
    "dataset_params": {
        "dataset": "ISIC2019",
        "train_transforms": {"Resize": {"apply": True, "height": 256,
                                        "width": 256},
                             "Normalize": True},
        "val_transforms": _SSL_EVAL,
        "test_transforms": _SSL_EVAL,
    },
    "dataloader_params": {
        "trainloader": {**_LOADER, "shuffle": True, "drop_last": True},
        "valloader": {**_LOADER, "shuffle": False, "drop_last": True},
        "testloader": {**_LOADER, "shuffle": False, "drop_last": False},
    },
    "model_params": {
        "backbone_type": "vit_base",
        "transformers_params": {
            "student": {"pre_img_size": 518, "patch_size": 14,
                        "drop_path_rate": 0, "layerscale": 1.0e-5,
                        "ffn_layer": "mlp", "gelu_tanh": True,
                        "use_fused_apla": True, "num_register_tokens": 0},
            "teacher": {"momentum_teacher": 0.994,
                        "final_momentum_teacher": 1,
                        "warmup_teacher_temp": 0.04, "teacher_temp": 0.07,
                        "warmup_teacher_temp_epochs": 30},
        },
        "pretrained": True,
        "freeze_backbone": False,
        "adaptation": {
            "mode": "apla",
            "params": {"partial_size": "full",
                       "inds_path": "params/pretrain/dinov2/ISIC2019/vit_b/"
                                    "inds-vit_b-rand_128.json"},
        },
        "dinov2": {
            "fused_proto_ce": "ibot",
            "dino": {"loss_weight": 1.0, **_SSL_HEAD,
                     "koleo_loss_weight": 0.1},
            "ibot": {"loss_weight": 1.0, "mask_sample_probability": 0.5,
                     "mask_ratio_min_max": [0.1, 0.5],
                     "separate_head": False, **_SSL_HEAD},
            "centering": "centering",
        },
    },
    "optimization_params": {"default": {
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 0.001, "weight_decay": 1.0e-5}},
        "scheduler": {
            "type": ["LinearWarmup", "CosineAnnealingLR"],
            "params": {"CosineAnnealingLR": {"eta_min": 1.0e-6},
                       "LinearWarmup": {"warmup_epochs": 10,
                                        "warmup_iters": 0,
                                        "eta_min": 1.0e-8}}},
    }},
    "training_params": {
        "model_name": "isic2019_dinov2_apla",
        "epochs": 100,
        "val_every": 1.0,
        "log_every": 25,
        "save_best_model": True,
        "knn_eval": True,
        "grad_clipping": 3.0,
        "restore_session": False,
        "use_mixed_precision": True,
        "freeze_last_layer_epochs": 1,
    },
    "system_params": {},
}
# What phase 6b changes, and why: the data (ISIC2019 is not in the
# repository) is the hermetic Synthetic set with ISIC2019's 8 classes at the
# raw 256 that device multi-crop cuts its 224 and 98 crops from, made on the
# device (the card's machine has no Pillow); the dinov2 checkpoint is not in
# the repository, so the weights are random from a seed; APLA rank 128 from
# the shipped index file, the variant the recipe's header documents ("full"
# mode runs no fused APLA kernel); one epoch of 4 steps, every step logged.
SSL_CUTS = {
    "dataset_params": {"dataset": "Synthetic", "synthetic_classes": 8,
                       "synthetic_size": 256, "synthetic_img_size": 256,
                       "device_augment": True},
    "model_params": {"pretrained": False,
                     "adaptation": {"params": {
                         "partial_size": 128,
                         "inds_path": "params/pretrain/dinov2/ISIC2019/"
                                      "vit_b/inds-vit_b-rand_128.json"}}},
    "training_params": {"epochs": 1, "log_every": 1},
}
# Phase 6a: (R, K) of the recipe's prototype-CE sites at b64 (iBOT: 2 x 64
# x 128 masked-patch rows; DINO global: 2 x 64; the local pairs: 8 x 2 x 64)
# and a ragged case; each at two teacher temperatures.  Kernel vs plain:
# the same bf16 inputs and f32 logits, sums in another order and exp2 for
# exp; ds is rounded to bf16 on both sides.  Bound per output: 2e-2 of the
# reference's largest magnitude for dxs and dws, as the other phases; 1e-3
# for ce, lse_s and lse_t, f32 values near log K on both sides (read on an
# H100: 2.4e-7 of max|ref|), where 2e-2 of log K would pass a teacher
# temperature taken as 1 (4.4e-3 of max|ref| at the iBOT site).
PROTO_CASES = ((16384, 65536), (128, 65536), (1024, 65536), (1000, 1000))
# The iBOT site as the collate fills it: the buffer holds 2 x 64 x 128 rows,
# the masked patches of the 64 masked global crops first (each crop masks
# U(0.1, 0.5) of its 256 patches, ssl/dinov2.py), zeros after them; drawn
# from the seed, ~30% of the rows.
PROTO_COLLATE = (16384, 65536)
# The forward's own fault control (a streamed tile of 32 prototype columns
# left out of the statistics) runs at the ragged case, where one tile holds
# ~3% of a row's softmax mass: lse moves by ~3e-2 against a bound of ~7e-3.
PROTO_FWD_CONTROL = (1000, 1000)
PROTO_FWD_REL_TOL = 1e-3
PROTO_TEMPS = (0.04, 0.07)
STUDENT_TEMP = 0.1
# Phase 6b, fused arm vs plain arm on the first step (b64, bf16 through 12
# blocks forward and back, the iBOT loss through the kernels or the dense
# [16384, 65536] logits): per loss term |delta| / |term|, and the worst
# per-tensor ||g_fused - g_plain|| / ||g_plain||.  Both arms run with the
# KoLeo weight at 0: at the seeded random init with LayerScale 1e-5 the
# images' cls tokens are a few bf16 roundings apart (the training run's
# koleo_loss of ~1.0 is 0.1 x -log of nearest-neighbour distances near
# 4e-5 of the unit norm), and KoLeo's gradient, diff / dist^2, then follows
# where the roundings fall; with it on, the arms read 2.15 at
# blocks.5.attn.proj_bt on an H100 whatever the kernels do.  Without it the fused arm reads 8.6e-7
# (ibot_loss) and 1.4e-3 (dino_head.mlp.1.bias); the bounds sit about 5x
# above, and two backward faults at the iBOT site (dws zeroed, dxs halved)
# must fail them in every run.  The training run keeps KoLeo on.
SSL_LOSS_REL_TOL = 5e-6
SSL_GRAD_REL_TOL = 7.5e-3
SSL_LOSS_TERMS = ("dino_local_crops_loss", "dino_global_crops_loss",
                  "koleo_loss", "ibot_loss")
SSL_AGREE_TERMS = ("dino_local_crops_loss", "dino_global_crops_loss",
                   "ibot_loss")

def _v1_recipe(**model_params):
    """SSL_RECIPE's backbone, data, loaders, optimizer and training fields
    in the schema BYOL, SimSiam and DINO v1 read (the supervised
    `transformers_params`, not DINOv2's `student` / `teacher`), with
    `model_params` added; the DINOv2 heads and knobs left out."""
    recipe = copy.deepcopy(SSL_RECIPE)
    mp = recipe["model_params"]
    student = mp["transformers_params"]["student"]
    mp["transformers_params"] = {
        "img_size": [student["pre_img_size"]],
        "patch_size": student["patch_size"],
        "drop_path_rate": student["drop_path_rate"],
        "gelu_tanh": student["gelu_tanh"],
        "use_fused_apla": student["use_fused_apla"],
        "num_register_tokens": student["num_register_tokens"],
        "block_conf": {"has_layerscale": True,
                       "layerscale_init_values": student["layerscale"]}}
    del mp["dinov2"]
    del recipe["training_params"]["freeze_last_layer_epochs"]
    mp.update(copy.deepcopy(model_params))
    return recipe


# Phase 11: the ViT-B/14 APLA-128 backbone of phase 6b under BYOL and
# SimSiam (`--byol`, `--simsiam`: BYOL_RECIPE; the heads at the JAX
# package's defaults, 256 / 4096 / 2 layers / predictor 4096 and 2048 /
# 2048 / 3 / 512) and DINO v1 (`--dino`: DINO_RECIPE, the JAX DINOWrapper's
# defaults written out).  Crops follow the strategies: 2 x 224 (257
# tokens), and for DINO 8 x 96 more (37 tokens).
BYOL_RECIPE = _v1_recipe()
DINO_RECIPE = _v1_recipe(DINO={"projection_size": 4096,
                               "moving_average_decay": 0.99,
                               "warmup_teacher_temp": 0.04,
                               "teacher_temp": 0.07})
# What phase 11 changes, and why: SSL_CUTS's data, weights and rank, at 128
# images (two steps of b64, one epoch, every step logged); the loaders run
# in-process (three objectives would each start 32 spawned workers).
V1_CUTS = {**copy.deepcopy(SSL_CUTS), "dataloader_params": {
    name: {"num_workers": 0}
    for name in ("trainloader", "valloader", "testloader")}}
V1_CUTS["dataset_params"]["synthetic_size"] = 128
V1_OBJECTIVES = ("byol", "simsiam", "dino")
# Rows 1 and 2 at DINO v1's local crops: 8 x 64 crops of 96 px.
V1_KERNEL_SHAPE = (512, 37, 2304)
# Phase 11, kernel arm vs plain arm on the first step (b64, bf16 through
# 12 blocks forward and back, crops from one seed, the recipe's LayerScale
# 1e-5): |delta loss|, the worst ||e_kernel - e_plain|| / ||e_plain|| over
# the cls embeddings of every backbone call of the step, and the worst
# per-tensor ||g_kernel - g_plain|| / ||g_plain|| over the backbone's
# trainables (the APLA columns) with the heads' cotangent at the
# backbone's output pinned to the plain arm's in the kernel arm.  The
# kernels are in the backbone; the heads are plain PyTorch in both arms
# and are printed, not held: BYOL and SimSiam's BatchNorm over b64
# near-equal embeddings of a random ViT-B divides by their spread, so the
# heads turn the arms' bf16 rounding into a cotangent 33-41% apart, and
# backbone gradients taken under each arm's own cotangent read 1.4-1.6
# apart at LayerScale 1e-5 (0.20-0.26 at 1.0, against 0.84-0.90 with the
# target's forward halved): no bound there tells a broken kernel.  With
# the cotangent pinned, on an H100 80GB HBM3 at 700 W, the kernel arm
# reads |dloss| 0.00795 / 2.49e-4 / 2.38e-6 (each arm's loss comes from
# its own heads), the embeddings 2.01e-6 / 2.01e-6 / 3.46e-6 and the
# backbone's gradients 0.00193 / 0.00242 / 6.6e-5 (BYOL / SimSiam /
# DINO).  The bounds sit 2.4-4.2x above those.  The controls:
# the target's or teacher's forward halved reads 5.4e-5 / 5.4e-5 / 5.3e-5
# in the embeddings; dW_t zeroed 1.0, DINO's local-crop backward zeroed
# 0.89, and dW_t scaled by 0.95 0.050 in the gradients.
V1_TOLS = {"byol": (2e-2, 5e-6, 5e-3), "simsiam": (6e-4, 5e-6, 6e-3),
           "dino": (1e-5, 1e-5, 2e-4)}
SERVE_IMG = 224
N_CLASSES = 1000
SEED = 0
BATCH_SIZES = (1, 8, 64)
REQUESTS = (1, 9, 100)
# (qkv shape, segment_len) for the kernel-vs-plain phase: the served calls
# at b1, b8 and b64, the 518-crop length, and packed segments
KERNEL_CASES = (((1, 257, 2304), 0), ((8, 257, 2304), 0),
                ((64, 257, 2304), 0), ((2, 1370, 2304), 0),
                ((8, 200, 2304), 50), ((512, 50, 2304), 0))
# (batch, tokens) at which the backward is timed: the served and trained
# b64 global crops, the SSL step's 8 x 64 local crops (one ragged 64-row
# tile per image), and the 518-crop length of TPU kernel rows 5-7
TIMED_SHAPES = ((64, 257), (512, 50), (2, 1370))
# The forward is timed at those and at the b1 and b8 calls (a served
# request, the accum-8 micro-batch), where it is host-bound when launched
# one by one; the first is the kernels line's.
FWD_TIMED = ((64, 257), (1, 257), (8, 257), (512, 50), (2, 1370))
# Phase 2: the projection GEMM (csrc/apla_proj_gemm.cu) against its plain
# version on the rows the fused forward gives it: B x N at N = 257 (b1, b8,
# b64: ragged in its 128-row tiles), the 518 crop, the segmenter's b8 and
# b1 at C = 1024, and one row.  (rows, C).  Kernel and plain version sum
# the same exact products in f32 in other orders and round once to bf16,
# so they differ by a bf16 ulp here and there: 0.0034 of max|ref| at most
# on an H100 80GB HBM3 at 700 W (this phase).  Bound: GEMM_REL_TOL of
# max|ref|, about 3x above; the three fault controls (output halved, last
# row unwritten, the last 64-deep step of the contraction skipped) read
# 0.3 of max|ref| and more.
GEMM_CASES = ((257, 768), (8 * 257, 768), (64 * 257, 768), (2 * 1370, 768),
              (8 * 1025, 1024), (1025, 1024), (1, 768))
GEMM_REL_TOL = 1e-2
# Published dense peaks of one H100 SXM (NVIDIA data sheet): the bf16 tensor
# cores and HBM3.  A kernel's bound is the larger of its operations over the
# first and its bytes (each input read once, each output written once) over
# the second.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_S = 3.35e12
# Kernel vs plain, both bf16 out: they differ by the order of f32 sums and
# the online max/sum of the softmax, i.e. by a bf16 rounding of p, o or the
# output here and there.  Bound: 2e-2 of the reference's largest magnitude.
KERNEL_REL_TOL = 2e-2
# (qkv shape, segment_len, trainable columns) for the backward phase: the
# training micro-batch (b8) and others; "block0" takes the shipped block-0
# indices.  Same bound, per output (dq, dk, dv, dW_t).
BWD_CASES = (((1, 257, 2304), 0, 128), ((8, 257, 2304), 0, 128),
             ((64, 257, 2304), 0, 128), ((2, 1370, 2304), 0, 128),
             ((8, 200, 2304), 50, 128), ((512, 50, 2304), 0, 128),
             ((8, 257, 2304), 0, "block0"))
# Served model, fused arm vs plain arm (bf16 end to end through 12 blocks;
# the plain arm also rounds its attention logits to bf16): per-image
# embedding cosine, and max |delta logits| relative to max |logits|.  On an
# H100 the fused arm reads cosine 0.999908 and 1.2% of max |logits|; the
# mildest of the faults in `_faults` (uniform p) reads 0.9844 and 16%.
# The bounds sit about 5x above the first and 5x below the second, and the
# script checks every run that each fault still fails them.
MIN_COSINE = 0.9995
LOGITS_REL_TOL = 3e-2
# Training phases, kernel arm vs plain arm on the first step (8
# micro-batches of 8 images, bf16 through 12 blocks forward and back):
# |delta loss| and the worst per-tensor ||g_kernel - g_plain|| / ||g_plain||
# over every trainable tensor.  On an H100 phase 5's fused arm reads 8.3e-6
# and 0.0103 (fc.kernel), and phase 7b's kernel arm the same two numbers:
# the plain arm's bf16 logits set both.  The bounds sit about 5x above, and
# the backward faults of phase 5 (dW_t zeroed, dqkv halved) and of phase 7b
# (dv zeroed, dqkv halved) must fail them in every run.
LOSS_TOL = 5e-5
GRAD_REL_TOL = 0.05
# Phase 7b: the ImageNet recipe above at APLA's headline mode, the whole
# output projection of every block trainable: `partial_size: "full"`, the
# value of params/pretrain/dinov2/ISIC2019/vit_b/apla.yml:9 (no index
# file).  Everything else is RECIPE's, `is_memory_efficient: true` and
# `use_fused_apla: true` included: the fused kernel serves rank-k blocks
# only (as in JAX), so every block's attention runs the memory-efficient
# attention kernels (TPU rows 8, 9).  Trained with SMOKE_CUTS; a CPU test
# holds this dict against the two YAMLs, value by value.
FULL_RECIPE = copy.deepcopy(RECIPE)
FULL_RECIPE["model_params"]["adaptation"]["params"] = {"partial_size": "full"}
# What phase 7b's training changes beyond SMOKE_CUTS: the loaders run in
# the trainer's process (num_workers 0).  Phase 5 drives the recipe's
# spawned workers on the same data; here their start-up, most of the
# phase's time on the card's 8-core host, would time the host again and
# nothing the kernels see.
FULL_CUTS = {**copy.deepcopy(SMOKE_CUTS), "dataloader_params": {
    name: {"num_workers": 0}
    for name in ("trainloader", "valloader", "testloader")}}
# Phase 7a: (batch, tokens, segment_len) of the memory-efficient attention
# kernels against their plain versions: b1 and b64 served calls and the b8
# training micro-batch at N=257, the SSL local crops (N=50), the 518-crop
# length (keys over 22 tiles), packed segments, a ragged N, N below one
# tile, and the forward's launch-plan boundaries (ops/mha.py fwd_plan):
# N=320, the longest the row kernel holds (five whole key tiles), N=321 the
# two-pass kernel's first with K/V resident, N=768 its longest resident (12
# whole tiles), N=769 its first streamed.  Bound per output (o; dq, dk,
# dv): KERNEL_REL_TOL of the reference's largest magnitude.  The controls
# run at the b8 case, the unmasked-padding control at MHA_PAD_CASES.
MHA_CASES = ((1, 257, 0), (8, 257, 0), (64, 257, 0), (512, 50, 0),
             (2, 1370, 0), (8, 200, 50), (3, 100, 0), (3, 17, 0),
             (2, 320, 0), (2, 321, 0), (2, 768, 0), (2, 769, 0))
# The forward timed at every shape the port's paths give it (b1, b8, b64 at
# N=257, the local crops, the 518 crop); the first is the kernels line's.
MHA_TIMED = ((64, 257), (1, 257), (8, 257), (512, 50), (2, 1370))
# Where a forward that forgot the column mask would weigh the zero-filled
# padding of its last key tile: N=17 (the row kernel multiplies 32 keys)
# and N=321 (the two-pass kernel, 384).  At N=257 the row kernel pads only
# to 272, and 15 zero keys among 257 move the output by about the bound.
MHA_PAD_CASES = ((3, 17, 0), (2, 321, 0))
# Phase 8a: the Swin window kernels (TPU rows 3, 4) at the window batches
# of the APLA-Swin-T detector below: at b16 and 224, stage s holds
# (56 >> s)^2 / 49 windows of 49 tokens per image, C = 96 << s and
# 3 << s heads of 32; every stage but the last has shifted blocks (the
# classic shift mask), the last one window per image and no shift.  Also
# stage 0 at b1, a served request.  (images, stage, shifted); the first case
# is the one timed for the kernels line and the one the controls run at.
SWIN_CASES = ((16, 0, True), (16, 0, False), (16, 1, True), (16, 1, False),
              (16, 2, True), (16, 2, False), (16, 3, False), (1, 0, True))
# Also Swin-B's windows at 384 (window 12: N = 144 tokens, C = 128, 4
# heads; a 96 x 96 feature map, 64 windows an image, shifted by 6), one
# image: past one 64-row tile, the forward's two-pass kernel and the
# backward's tiles kernel.  (images, side, window, C)
SWIN_WIDE_CASE = (1, 96, 12, 128)
# Phase 8b: the detection side-car's recipe, `python -m apla_tpu.segdet det
# --use_fused --bf16` with the four-stage Swin-T passed explicitly
# (`--depths 2,2,6,2 --num_heads 3,6,12,24`; the SwinConfig defaults,
# apla_tpu/models/swin.py:30-53: patch 4, embed 96, window 7, MLP 4, exact
# GELU, patch norm, LayerNorm eps 1e-5; the FCOS head, laterals and level
# scales, strides 4/8/16/32; AdamW lr 1e-4, weight decay 1e-4,
# apla_tpu/segdet.py:385-405; batch 16, max_boxes 32, no masks), through
# `segdet.train_detection`, the function behind the CLI.
DET_RECIPE = dict(img_size=224, embed_dim=96, depths=(2, 2, 6, 2),
                  num_heads=(3, 6, 12, 24), window_size=7, batch_size=16,
                  lr=1e-4, weight_decay=1e-4, max_boxes=32, use_fused=True,
                  bf16=True)
# What phase 8b changes, and why: COCO is not in the repository, so the data
# is a COCO-format set this script writes (DET_IMAGES PNGs, mostly 224^2 and
# every eighth 256 x 192 so the resize runs; COCO's 80 categories; 1-8
# filled rectangles per image, one colour per category); the weights are
# random from SEED (no Swin checkpoint in the repository); one epoch of 4
# steps, evaluated on the train set (labelled `train`, as the JAX loop does
# without a validation split); the loaders in-process (spawned workers'
# start-up would time the host, as in phase 7b).
DET_CUTS = dict(epochs=1, num_workers=0, log_every=1)
DET_IMAGES = 64
DET_CLASSES = 80
# Phase 8b, kernel arm vs plain arm (bf16 through 12 Swin blocks and the
# head): the first step's |delta loss| relative to the loss, the worst
# per-tensor ||g_kernel - g_plain|| / ||g_plain||, the cosine of each
# pyramid level, and the served raw maps against the in-process forward
# (max |delta| relative to the largest magnitude).  Readings and the
# bounds' margins are in PERF.md; the backward faults (dW zeroed, dqkv
# halved) must fail the gradient bound in every run.
DET_LOSS_REL_TOL = 1e-2
DET_GRAD_REL_TOL = 0.05
DET_MIN_COSINE = 0.99985
DET_SERVE_REL_TOL = 1e-3
# Phase 9a: the fused APLA kernels (rows 1, 2) at the shape the
# segmentation side-car gives them, where JAX's dispatch names the q-strip
# long kernels (TPU rows 5-7): ViT-L/16 at 512, qkv [b, 1025, 3072], 16
# heads of 64, APLA "full" as k = C = 1024 trainable columns.  b8 is the
# recipe's batch (timed, the controls run there), b1 a served request.
# Same bounds as phases 2 and 4.
SEG_KERNEL_CASES = ((8, 1025, 1024), (1, 1025, 1024))
SEG_HEADS = 16
# Phase 9b: the segmentation side-car's recipe, `python -m apla_tpu.segdet
# seg --backbone vit_large --patch_size 16 --img_size 512 --use_fused
# --aux_heads 3 --head_lr_mult 10` (the reference's
# apla_setr_vit-l_pup_8xb2-160k_ade20k-512x512: ViT-L/16 at 512, 24 blocks
# of 16 heads, bf16, APLA partial_size "full", the PUP head of 256
# channels, 3 auxiliary heads at blocks 9, 14, 19 with loss weight 0.4,
# head lr x10; AdamW lr 1e-4, weight decay 1e-4 and batch 8, the JAX loop's
# defaults, apla_tpu/segdet.py:145-150, :580-612), through
# `segdet.train_segmentation`, the function behind the CLI.  A CPU test
# holds this dict against the JAX CLI's defaults and flags.
SEG_RECIPE = dict(backbone="vit_large", patch_size=16, img_size=512,
                  batch_size=8, lr=1e-4, weight_decay=1e-4,
                  partial_size="full", channels=256, aux_heads=3,
                  head_lr_mult=10.0, use_fused=True)
# What phase 9b changes, and why: ADE20K is not in the repository, so the
# data is an ADE20K-layout set this script writes (SEG_TRAIN + SEG_VAL
# images, most 512 x 683 or 683 x 512 as ADE20K's are, every fourth
# 512 x 512; regions filled with one colour per class, with unlabelled (0)
# and raw-255 pixels; PNG content under ADE20K's `.jpg` names, since JPEG
# decoding is not ported); the weights are random from SEED (no ViT-L
# checkpoint in the repository); one epoch of SEG_TRAIN / 8 steps; the
# loaders in-process (as in phases 7b and 8b).  The sliding-window
# evaluation runs at SEG_SLIDE_SIZE with the default stride 341 (2 x 2
# windows of 512).
SEG_CUTS = dict(epochs=1, num_workers=0, log_every=1)
SEG_TRAIN = 32
SEG_VAL = 16
SEG_SLIDE_SIZE = 640
# Phase 9b bounds, kernel arm vs plain arm on the first step (bf16 through
# 24 blocks and the heads): |delta loss| relative to the loss, set about 5x
# above the kernel arm's reading (1.5e-6 of the loss, PERF.md), and the
# detector phase's gradient bound.  The two backward faults (dW_t zeroed,
# dqkv halved) and three forward faults must fail the bounds in every run.  The served logits are held against the in-process module of the
# same checkpoint served through the same calls (a `SegPredictor` over it:
# the same batches, padded alike), at 1e-3 of the largest logit.
SEG_LOSS_REL_TOL = 7.5e-6
SEG_GRAD_REL_TOL = DET_GRAD_REL_TOL
SEG_SERVE_REL_TOL = DET_SERVE_REL_TOL
# Phase 10a: the int8 GEMM (TPU row 13; with one group over K, the W8A8
# serving path's frozen qkv / fc1 / fc2) against its plain version on the
# same tensors in the working dtype: the classifier's three products at b64
# (M = 64 x 257) and b1, the segmenter's fc2 at b8 (M = 8 x 1025), the
# Swin-T detector's stage-0 qkv at b16 (M = 16 x 56^2 tokens, K = 96; f32,
# the detector serves in f32), row 13's own function (groups of 256) at the
# fc2 shape with a ragged M, and fc1 b64 with its bias (f32, as the served
# model keeps it), which the kernel adds after the rounding, as the served
# path runs every frozen product.  W8A8 training (phase 12c) runs the b64
# products at accum 1 and the b8 micro-batch's (M = 8 x 257) at the
# recipe's accum 8.  (name, M, K, N, group, dtype, bias).
INT8_CASES = (
    ("qkv b64", 64 * 257, 768, 2304, 768, torch.bfloat16, False),
    ("fc1 b64", 64 * 257, 768, 3072, 768, torch.bfloat16, False),
    ("fc2 b64", 64 * 257, 3072, 768, 3072, torch.bfloat16, False),
    ("qkv b1", 257, 768, 2304, 768, torch.bfloat16, False),
    ("fc1 b1", 257, 768, 3072, 768, torch.bfloat16, False),
    ("fc2 b1", 257, 3072, 768, 3072, torch.bfloat16, False),
    ("qkv b8", 8 * 257, 768, 2304, 768, torch.bfloat16, False),
    ("fc1 b8", 8 * 257, 768, 3072, 768, torch.bfloat16, False),
    ("fc2 b8", 8 * 257, 3072, 768, 3072, torch.bfloat16, False),
    ("seg fc2 b8", 8 * 1025, 4096, 1024, 4096, torch.bfloat16, False),
    ("swin stage-0 qkv b16", 16 * 56 * 56, 96, 288, 96, torch.float32,
     False),
    ("row 13 fc2, groups of 256, M ragged", 64 * 257 - 5, 3072, 768, 256,
     torch.bfloat16, False),
    ("fc1 b64 + bias", 64 * 257, 768, 3072, 768, torch.bfloat16, True),
)
INT8_MAIN = "fc1 b64"            # the kernels line's times
INT8_ROW13 = INT8_CASES[-2][0]
# Kernel vs plain: the same codes, exact int32 sums and the same f32
# roundings, so equal.  Bound: 1e-6 of max|ref| (8 f32 ulps), below a bf16
# output moved by one ulp (2^-8) and far below one flipped code or a scale
# off by an ulp; each fault control must exceed it.
INT8_REL_TOL = 1e-6
# Phase 10b: the ImageNet classifier of phase 3 (RECIPE served at 224, the
# random weights from SEED) exported with quantize_frozen=True and served.
# The W8A8 artifact against the float one: per-image embedding cosine at
# least the bound of tests/test_quant.py; the kernel arm against the plain
# arm (the attention and int8 kernels' plain versions) within phase 3's
# bounds; served outputs within SERVE_REL_TOL of the in-process quantized
# module through the same calls.
W8A8_MIN_COSINE = 0.99
W8A8_SERVE_REL_TOL = DET_SERVE_REL_TOL

# Phase 12: the shipped recipes from real weights.  IMPORT_RECIPE is
# params/finetune/dinov2/ImageNet/vit_b/apla.yml as shipped: RECIPE with the
# fields RECIPE leaves out, `pretrained: true`, the checkpoint path and the
# empty transfer path (a CPU test holds it against the YAML).  No
# checkpoint is in the repository and none may be fetched: the phase
# writes a seeded ViT-B/14 state dict in the public DINOv2 layouts
# (torch.hub, chunked blocks, HF `Dinov2Model`) and points the path at it.
# W8A8_RECIPE adds W8A8 training (`quantize_frozen`, a knob no shipped
# recipe sets).
IMPORT_RECIPE = copy.deepcopy(RECIPE)
IMPORT_RECIPE["model_params"].update(
    pretrained=True,
    pretrained_checkpoint="/data/checkpoints/dinov2_vitb14_pretrain.pth")
IMPORT_RECIPE["transfer_learning_params"] = {"pretrained_path": ""}
W8A8_RECIPE = copy.deepcopy(IMPORT_RECIPE)
W8A8_RECIPE["model_params"]["quantize_frozen"] = True
# What phase 12 changes, and why: phase 5's data (the Synthetic set at the
# recipe's raw 256 and 1000 classes) at 128 images, two accum-8 updates of
# b64 (12b's fine-tune takes 64, one update); the loaders in-process.
IMPORT_CUTS = {**copy.deepcopy(SMOKE_CUTS), "dataloader_params": {
    name: {"num_workers": 0}
    for name in ("trainloader", "valloader", "testloader")}}
IMPORT_CUTS["dataset_params"]["synthetic_size"] = 128
# 12d's classifier split: `serve export` builds the recipe's config, so the
# artifact answers at the 518 grid; the split is stored at 518 and read
# through an identity resize (64 test images, and 64 train images for the
# kNN bank).
EVAL_CUTS = copy.deepcopy(IMPORT_CUTS)
EVAL_CUTS["dataset_params"].update(synthetic_size=64, synthetic_img_size=518)
EVAL_CUTS["dataset_params"].update({split: {
    "Resize": {"apply": True, "height": 518, "width": 518},
    "CenterCrop": {"apply": False}, "Normalize": True}
    for split in ("val_transforms", "test_transforms")})
# 12c, W8A8 kernel arm (row 13 and rows 1, 2) against the plain arm (the
# int8 product's and the attention's plain versions) on the first step:
# |dloss| and the worst per-tensor ||dg|| / ||g||.  The int8 kernel is
# its plain version bit for bit on the same x (10a), but the arms' bf16
# attention outputs part by a rounding, and each activation code that a
# rounding moves moves an output by ~1% of a typical one: on an H100 80GB
# HBM3 at 700 W the kernel arm reads |dloss| 5.52e-4 and 0.0196 (at
# fc.kernel), against phase 5's float 8.3e-6 and 0.0103.  The bounds sit
# 2.7x and 2.5x above; the controls read: codes truncated 3.05e-3 and
# 0.083, the product scaled by 0.9 3.38e-3 and 0.77, dW_t zeroed 1.0.
W8A8_LOSS_TOL = 1.5e-3
W8A8_GRAD_REL_TOL = 0.05


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _template_args(mangled: str) -> str:
    """'<a, b, ...>' of a mangled template argument list 'I...E' (integer
    and bool literals, named types, float), or ''."""
    if not mangled.startswith("I"):
        return ""
    args, i = [], 1
    while i < len(mangled) and mangled[i] != "E":
        lit = re.match(r"L[ib](\d+)E", mangled[i:])
        named = re.match(r"(\d+)", mangled[i:])
        if lit:
            args.append(lit.group(1))
            i += lit.end()
        elif named:
            j = i + named.end() + int(named.group(1))
            args.append(mangled[i + named.end():j])
            i = j
        elif mangled[i] in "fi":
            args.append({"f": "float", "i": "int"}[mangled[i]])
            i += 1
        else:
            return ""
    return "<" + ", ".join(args) + ">"


def _resources(report: str) -> list[str]:
    """'kernel: N registers, S bytes spilled, M bytes smem' per kernel of a
    `-Xptxas=-v` report."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            # _ZN<len><namespace><len><name>[I<template args>E]...: the
            # kernel's name
            name = line.split("'")[1]
            m = re.match(r"_ZN(\d+)", name)
            if m:
                i = m.end() + int(m.group(1))
                n = re.match(r"\d+", name[i:])
                if n:
                    j = i + n.end() + int(n.group())
                    name = name[i + n.end():j] + _template_args(name[j:])
        elif "spill stores" in line and name:
            spill = line.split(",")[1].split()[0]
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split()[0]
            smem = line.split("bytes smem")[0].split(",")[-1].strip() \
                if "smem" in line else "0"
            out.append(f"{name}: {regs} registers, {spill} bytes spilled, "
                       f"{smem} bytes static smem")
            name = None
    return out


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from apla_tpu_torch.ops import apla_proj_gemm, cuda_build
    from apla_tpu_torch.ops import fused_swin_attn, int8_matmul, mha, \
        proto_ce
    from apla_tpu_torch.ops.fused_apla_attn import _BWD_SOURCE
    sources = (mha.FWD_SOURCE, apla_proj_gemm.SOURCE, _BWD_SOURCE,
               fused_swin_attn._SOURCE, fused_swin_attn._BWD_SOURCE,
               proto_ce.FWD_SOURCE, proto_ce.BWD_SOURCE, mha.BWD_SOURCE,
               int8_matmul.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build_library, sources))
    for src in sources:
        cuda_build.load_library(src)
    secs = time.perf_counter() - t0
    for src in sources:
        print(f"[1 build] {src} -> "
              f"{cuda_build.library_path(src).relative_to(ROOT)}")
        for line in _resources(cuda_build.resource_report(src)):
            print(f"[1 build]   {line}")
    print(f"[1 build] {len(sources)} kernels built (in parallel) and loaded "
          f"in {secs:.2f} s")
    return secs


def _bound(flops, nbytes):
    """(least ms the card could take, what bounds it) for work of `flops`
    bf16 tensor-core operations moving `nbytes` bytes."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _attn_fwd_bound(b, n, c):
    """Fused forward of [b, n, 3c] bf16 qkv and a [c, c] bf16 W: per image
    q k^T and p v over all heads (2 n^2 c each) and the projection
    (2 n c^2); reads qkv and W, writes [b, n, c] bf16."""
    return _bound(b * (4 * n * n * c + 2 * n * c * c),
                  2 * (3 * b * n * c + c * c + b * n * c))


def _attn_bwd_bound(b, n, c, k):
    """Its backward: dO = g W^T (2 n c^2), the scores and o recomputed, dv,
    dp, dq, dk (six 2 n^2 c products: the kernels run eleven, as the
    scores and dp are recomputed on each side and in each pass) and dW_t =
    o^T g_t (2 n c k); reads qkv, W and g, writes dqkv bf16 and dW_t f32."""
    return _bound(b * (12 * n * n * c + 2 * n * c * c + 2 * n * c * k),
                  2 * (3 * b * n * c + c * c + b * n * c + 3 * b * n * c)
                  + 4 * c * k)


def _bwd_launch_bounds(b, n, c, k=None):
    """(least ms, what bounds it) of each launch of the backward, for the
    function that launch computes: the dO GEMM (2 n c^2 per image; reads g
    and W, writes dO), the query side (q k^T, dO v^T, dq = ds k and, fused,
    o = p v: 2 n^2 c each; reads qkv and dO, writes dq, the statistics and,
    fused, o_cat), the key side (k q^T, v dO^T, dv, dk; reads qkv, dO and
    the statistics, writes dk, dv), the dW_t partials and their sum (2 n c k;
    reads o_cat and g_t, writes dW_t f32).  k None: the memory-efficient
    attention backward, the two sides alone, without o."""
    bnc, prod, stat = b * n * c, 2 * b * n * n * c, 3 * b * n * (c // 64) * 4
    fused = k is not None
    out = {"query side": _bound((4 if fused else 3) * prod,
                                2 * (4 + 1 + fused) * bnc + stat),
           "key side": _bound(4 * prod, 2 * 6 * bnc + stat)}
    if fused:
        out["dO GEMM"] = _bound(2 * bnc * c, 2 * (2 * bnc + c * c))
        out["dW partials + reduce"] = _bound(2 * bnc * k,
                                             2 * (bnc + b * n * k) + 4 * c * k)
    return out


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bwd_parts(call, bounds):
    """Each launch of a backward call apart: `call(parts)` queues the
    launches `parts` names (`ops/mha.py` PART_* bits); CUDA events over
    calls launched one by one and a CUDA graph of 20, beside the launch's
    bound.  "wrapper alone" (parts = 0): what the fused wrapper does around
    the launches (the g_t gather, the allocations), inside every time."""
    from apla_tpu_torch.ops import mha as tmha
    bits = {"dO GEMM": tmha.PART_DO, "query side": tmha.PART_QUERY,
            "key side": tmha.PART_KEY,
            "dW partials + reduce": tmha.PART_DW}
    names = list(bounds) + (["wrapper alone"] if "dO GEMM" in bounds
                            else [])
    out = {}
    for name in names:
        fn = functools.partial(call, bits.get(name, 0))
        out[name] = {"ms": _time_ms(fn), "graph_ms": _graph_ms(fn)}
        if name in bounds:
            out[name]["bound_ms"], out[name]["bound_by"] = bounds[name]
    return out


def _print_parts(tag, parts):
    print(f"[{tag}]   launches apart (events / CUDA graph ms, bound): "
          + "; ".join(f"{name} {t['ms']:.4f} / {t['graph_ms']:.4f}"
                      + (f" (bound {t['bound_ms']:.4f}, {t['bound_by']}, "
                         f"{t['bound_ms'] / t['graph_ms']:.1%})"
                         if "bound_ms" in t else "")
                      for name, t in parts.items()))


def _library_attn(qkv, w, heads, scale):
    """The yardstick: F.scaled_dot_product_attention and one torch.matmul
    (and the head-merge copy between them).  No single PyTorch call
    computes the fused function; the port never calls these."""
    b, n, c3 = qkv.shape
    q, k, v = qkv.unflatten(-1, (3, heads, c3 // (3 * heads))) \
        .permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         scale=scale)
    return torch.matmul(o.transpose(1, 2).reshape(b, n, c3 // 3), w)


def _host_ms(fn, calls=100) -> float:
    """The host's ms to launch one call of `fn`: `calls` calls queued with
    no wait between them (the wrapper, its checks and plans, the
    launches), after a few that warm the allocator's cache."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _fused_fwd_times(qkv, w, heads, scale, plain_iters=5):
    """The fused forward on (qkv, w), timed: the call by events, from a CUDA
    graph and as the host's time per call; its two launches apart (the
    attention kernel, then the GEMM on its output), by events and from
    graphs; the plain version; torch.matmul on the GEMM's operands (one
    call that computes the GEMM's function) and the two-call yardstick
    (SDPA + matmul); the bounds of the call and of the GEMM."""
    from apla_tpu_torch.ops import apla_proj_gemm as pg
    from apla_tpu_torch.ops import fused_apla_attn as fa
    from apla_tpu_torch.ops import mha as tmha
    from apla_tpu_torch.ops.cuda_build import launch_context
    b, n, c3 = qkv.shape
    c = c3 // 3
    fused = lambda: fa.fused_apla_attn_fwd(qkv, w, heads, scale)  # noqa: E731
    attention = lambda: tmha.mha_fwd(qkv, heads, scale)  # noqa: E731
    o = attention()
    gemm = lambda: pg.apla_proj_gemm(o, w)  # noqa: E731
    library = lambda: _library_attn(qkv, w, heads, scale)  # noqa: E731
    t = {"host_ms": _host_ms(fused), "ms": _time_ms(fused),
         "graph_ms": _graph_ms(fused),
         "attention_ms": _time_ms(attention),
         "attention_graph_ms": _graph_ms(attention),
         "gemm_ms": _time_ms(gemm), "gemm_graph_ms": _graph_ms(gemm),
         "gemm_library_ms": _time_ms(lambda: torch.matmul(o, w)),
         "plain_ms": _time_ms(lambda: fa.fused_apla_attn_fwd_reference(
             qkv, w, heads, scale), iters=plain_iters),
         "library_two_calls_ms": _time_ms(library),
         "library_two_calls_graph_ms": _graph_ms(library)}
    t["bound_ms"], t["bound_by"] = _attn_fwd_bound(b, n, c)
    t["gemm_bound_ms"], t["gemm_bound_by"] = _bound(
        2 * b * n * c * c, 2 * (2 * b * n * c + c * c))
    # the GEMM's two tile shapes (gemm_plan picks one from the shape)
    def gemm_with(plan):
        with launch_context(o) as stream:   # the graph's stream in capture
            return pg.launch(o, w, stream, plan)

    t["gemm_plans_graph_ms"] = {
        f"{bn} x {stages}": _graph_ms(functools.partial(
            gemm_with, pg.gemm_plan(b * n, c, bn, stages)))
        for bn, stages in ((128, 3), (256, 4))}
    return t


def _print_fwd_times(tag, b, n, c, t):
    print(f"[{tag}] fwd b{b} N={n} C={c}: kernels {t['ms']:.4f} ms "
          f"({t['graph_ms']:.4f} from a CUDA graph; the host takes "
          f"{t['host_ms']:.4f} to launch one call) = attention "
          f"{t['attention_ms']:.4f} ({t['attention_graph_ms']:.4f}) + GEMM "
          f"{t['gemm_ms']:.4f} ({t['gemm_graph_ms']:.4f}; torch.matmul "
          f"{t['gemm_library_ms']:.4f}; bound {t['gemm_bound_ms']:.4f}, "
          f"{t['gemm_bound_by']}); plain {t['plain_ms']:.4f}; two library "
          f"calls (SDPA + matmul) {t['library_two_calls_ms']:.4f} "
          f"({t['library_two_calls_graph_ms']:.4f}); bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
          f"{t['bound_ms'] / t['graph_ms']:.1%} of it reached); the GEMM "
          f"from a CUDA graph at 128-row tiles of columns x stages "
          + ", ".join(f"{k} {v:.4f}"
                      for k, v in t["gemm_plans_graph_ms"].items()))


def _gemm_check(device, gen):
    """Phase 2's GEMM part: the projection GEMM against its plain version at
    GEMM_CASES, three fault controls at each, and its resources; returns
    the worst max|err|."""
    from apla_tpu_torch.ops import apla_proj_gemm as pg
    from apla_tpu_torch.ops import cuda_build
    worst = 0.0
    for m, c in GEMM_CASES:
        o = torch.randn((m, c), generator=gen).to(device, torch.bfloat16)
        w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(
            device, torch.bfloat16)
        out = pg.apla_proj_gemm(o, w)
        torch.cuda.synchronize()
        ref = pg.apla_proj_gemm_reference(o, w).float()
        bound = GEMM_REL_TOL * ref.abs().max().item()

        def err(x):
            return ((x.float() - ref).abs().max().item()
                    if torch.isfinite(x).all() else float("inf"))

        e = err(out)
        worst = max(worst, e)
        w_short = w.clone()
        w_short[-64:] = 0
        controls = {
            "output halved": out * 0.5,
            "last row unwritten": out.index_fill(
                0, torch.tensor([m - 1], device=device), 0),
            "last 64-deep step of the contraction skipped":
                pg.apla_proj_gemm(o, w_short)}
        caught = {name: err(x) for name, x in controls.items()}
        plan = pg.gemm_plan(m, c)
        print(f"[2 kernel] GEMM [{m}, {c}] @ [{c}, {c}] ({plan.describe()}):"
              f" max|err| {e:.6g} bound {bound:.6g} -> "
              f"{'ok' if e <= bound else 'FAIL'}; controls " + ", ".join(
                  f"{name} {x:.6g}" for name, x in caught.items()) + " -> "
              + ("caught" if min(caught.values()) > bound else "NOT CAUGHT"))
        if e > bound:
            raise SystemExit(f"the GEMM disagrees with its plain version at "
                             f"[{m}, {c}]")
        if min(caught.values()) <= bound:
            raise SystemExit(f"the GEMM bound misses a broken kernel at "
                             f"[{m}, {c}]")
    for line in _resources(cuda_build.resource_report(pg.SOURCE)):
        print(f"[2 kernel]   {pg.SOURCE}: {line}")
    return worst


def phase_kernel(device):
    """2: the fused forward (the attention kernel, then the projection
    GEMM) against its plain version at KERNEL_CASES with four fault
    controls; the GEMM alone at GEMM_CASES with three; times at
    FWD_TIMED."""
    from apla_tpu_torch.ops.fused_apla_attn import (
        fused_apla_attn_fwd, fused_apla_attn_fwd_reference)
    from apla_tpu_torch.ops import apla_proj_gemm as pg
    from apla_tpu_torch.ops import mha as tmha
    gen = torch.Generator().manual_seed(SEED)
    heads, scale = 12, 64 ** -0.5
    worst = 0.0
    for shape, seg in KERNEL_CASES:
        c = shape[-1] // 3
        qkv = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
        w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(
            device, torch.bfloat16)
        out = fused_apla_attn_fwd(qkv, w, heads, scale, seg)
        torch.cuda.synchronize()
        ref = fused_apla_attn_fwd_reference(qkv, w, heads, scale, seg)
        err = (out.float() - ref.float()).abs().max().item()
        bound = KERNEL_REL_TOL * ref.float().abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= bound
        print(f"[2 kernel] qkv {list(shape)} seg={seg}: max|err| {err:.6g} "
              f"bound {bound:.6g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel disagrees with its plain version at "
                             f"{shape} seg={seg}")
        worst = max(worst, err)
        if shape == KERNEL_CASES[0][0]:
            for name, fault in _faults().items():
                f_qkv, f, f_scale = fault(qkv, scale)
                b_err = (fused_apla_attn_fwd(f_qkv, w * f, heads, f_scale,
                                             seg).float()
                         - ref.float()).abs().max().item()
                print(f"[2 kernel] control {name} at {list(shape)}: "
                      f"max|err| {b_err:.6g} bound {bound:.6g} -> "
                      f"{'caught' if b_err > bound else 'NOT CAUGHT'}")
                if b_err <= bound:
                    raise SystemExit(f"the kernel bound misses a broken "
                                     f"kernel ({name})")
    gemm_err = _gemm_check(device, gen)
    times = {}
    for b, n in FWD_TIMED:
        qkv = torch.randn((b, n, 2304), generator=gen).to(device,
                                                          torch.bfloat16)
        w = (torch.randn((768, 768), generator=gen) * 768 ** -0.5).to(
            device, torch.bfloat16)
        t = times[(b, n)] = _fused_fwd_times(qkv, w, heads, scale)
        _print_fwd_times("2 kernel", b, n, 768, t)
        print(f"[2 kernel]   plans: attention "
              f"{tmha.fwd_plan(b, n, heads).describe()}; GEMM "
              f"{pg.gemm_plan(b * n, 768).describe()}")
    return worst, gemm_err, times


def _agrees(tag, name, outs, ref_outs) -> bool:
    """Prints and checks `outs` against `ref_outs`, per request (logits,
    embedding) pairs: per-image embedding cosine and max |delta logits|."""
    worst_cos, worst_dl, max_l = 1.0, 0.0, 0.0
    for (logits, emb), (r_logits, r_emb) in zip(outs, ref_outs):
        cos = np.sum(emb * r_emb, -1) / (np.linalg.norm(emb, axis=-1)
                                         * np.linalg.norm(r_emb, axis=-1))
        worst_cos = min(worst_cos, float(cos.min()))
        worst_dl = max(worst_dl, float(np.abs(logits - r_logits).max()))
        max_l = max(max_l, float(np.abs(r_logits).max()))
    ok = worst_cos >= MIN_COSINE and worst_dl <= LOGITS_REL_TOL * max_l
    print(f"[{tag}] {name} vs plain arm: min embedding cosine "
          f"{worst_cos:.6f} (bound {MIN_COSINE}), max|dlogits| "
          f"{worst_dl:.6g} (bound {LOGITS_REL_TOL * max_l:.6g}) -> "
          f"{'within' if ok else 'outside'} the bounds")
    return ok


def _faults():
    """Kernel faults the bounds must catch.  Each maps the kernel's (qkv,
    scale) to (qkv, factor on w, scale) such that the working kernel then
    computes what a kernel with that fault would."""
    def odd_heads_dropped(qkv, scale):
        c = qkv.shape[-1] // 3
        v = qkv[..., 2 * c:].unflatten(-1, (-1, 64)).clone()
        v[..., 1::2, :] = 0
        return torch.cat([qkv[..., :2 * c], v.flatten(-2)], -1), 1.0, scale

    return {
        "output zeroed": lambda qkv, scale: (qkv, 0.0, scale),
        "output halved": lambda qkv, scale: (qkv, 0.5, scale),
        "uniform p (scale 0)": lambda qkv, scale: (qkv, 1.0, 0.0),
        "odd heads dropped": odd_heads_dropped,
    }


def _with_patch(module, name, replacement, fn):
    """fn() with `module.name` replaced by `replacement`."""
    real = getattr(module, name)
    setattr(module, name, replacement)
    try:
        return fn()
    finally:
        setattr(module, name, real)


def _with_fused_fault(fault, fn):
    """fn() with `fault` applied to every block's fused kernel call."""
    from apla_tpu_torch.ops import attention
    real = attention.fused_apla_attention

    def faulty(qkv, w_t, b_t, w_frozen, b_frozen, inds, num_heads, scale,
               segment_len=0):
        qkv, f, scale = fault(qkv, scale)
        return real(qkv, w_t * f, b_t, w_frozen * f, b_frozen, inds,
                    num_heads, scale, segment_len)

    return _with_patch(attention, "fused_apla_attention", faulty, fn)


def phase_slice(device):
    from apla_tpu_torch.ops.fused_apla_attn import fused_apla_attn_fwd
    faults = {name: functools.partial(_with_fused_fault, fault)
              for name, fault in _faults().items()}
    return _serve_phase(device, RECIPE, "3 slice", fused_apla_attn_fwd,
                        faults)


def _serve_phase(device, recipe, tag, counter, faults):
    """`recipe`'s classifier (random weights from SEED) exported at
    BATCH_SIZES, reloaded, and asked for REQUESTS: every block of every
    call launches the kernel that `counter` (a wrapper) counts; finite
    outputs of the expected shapes that agree with the plain arm (the
    kernels' paths off); each of `faults` (name -> fn(run), running `run()`
    with a kernel fault) fails those bounds; b64 img/s of both arms."""
    from apla_tpu_torch.models.classifier import (classifier_forward,
                                                  init_classifier)
    from apla_tpu_torch.serve import Predictor, export_classifier, \
        load_predictor
    from apla_tpu_torch.wrapper import build_apla_config, build_vit_config

    grid_cfg = build_vit_config(recipe)
    apla_cfg = build_apla_config(recipe)
    if apla_cfg.inds_path:
        apla_cfg = dataclasses.replace(
            apla_cfg, inds_path=os.path.join(ROOT, apla_cfg.inds_path))
    t0 = time.perf_counter()
    model = init_classifier(grid_cfg, N_CLASSES, apla_cfg,
                            generator=torch.Generator().manual_seed(SEED),
                            device=device)
    serve_cfg = dataclasses.replace(grid_cfg, img_size=SERVE_IMG)
    depth = serve_cfg.depth
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"[{tag}] {recipe['model_params']['backbone_type']}/"
          f"{serve_cfg.patch_size} APLA-{apla_cfg.partial_size} classifier "
          f"({depth} blocks, {n_train:,} trainable, use_flash "
          f"{serve_cfg.use_flash}) built on {device} in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((n, SERVE_IMG, SERVE_IMG, 3),
                                    dtype=np.float32) for n in REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        export_classifier(tmp, model, serve_cfg, batch_sizes=BATCH_SIZES)
        pred = load_predictor(tmp, device)
    del model
    if pred.vit_cfg != serve_cfg:
        raise SystemExit(f"the artifact reloads another config: "
                         f"{pred.vit_cfg}")
    n_calls = sum(1 for x in requests for _ in pred._iter_chunks(x))

    counter.launches = 0
    outs = [pred.predict_and_embed(x) for x in requests]
    _sync(device)
    launches = counter.launches
    print(f"[{tag}] answered {list(REQUESTS)} images in {n_calls} calls; "
          f"kernel launches {launches} (expected {depth} x {n_calls})")
    if launches != depth * n_calls:
        raise SystemExit("the served path did not run the kernel in every "
                         "block of every call")
    for x, (logits, emb) in zip(requests, outs):
        if logits.shape != (len(x), N_CLASSES) \
                or emb.shape != (len(x), serve_cfg.embed_dim) \
                or not (np.isfinite(logits).all() and np.isfinite(emb).all()):
            raise SystemExit(f"bad output for a request of {len(x)}: "
                             f"{logits.shape} {emb.shape}")

    plain_cfg = dataclasses.replace(serve_cfg, use_fused_apla=False,
                                    use_flash=False)
    plain = Predictor(pred.meta, pred.model, plain_cfg, device)
    plain_outs = [plain.predict_and_embed(x) for x in requests]
    ok = _agrees(tag, "kernel arm", outs, plain_outs)
    # Negative controls: the kernel arm with a kernel fault made on purpose.
    # Each must fail the bounds, or the bounds could not tell a broken
    # kernel from a working one.
    caught = all([not _agrees(tag, f"control: {name}", run(
        lambda: [pred.predict_and_embed(x) for x in requests]), plain_outs)
        for name, run in faults.items()])
    if not ok:
        raise SystemExit("kernel arm disagrees with the plain arm")
    if not caught:
        raise SystemExit("a broken kernel passes the slice's bounds")

    x64 = torch.from_numpy(requests[-1][:64]).to(device)
    rates = {}
    with torch.inference_mode():
        for name, cfg in (("plain", plain_cfg), ("kernel", serve_cfg),
                          ("kernel", serve_cfg), ("plain", plain_cfg)):
            ms = _time_ms(lambda: classifier_forward(pred.model, x64, cfg),
                          iters=10)
            rates.setdefault(name, []).append(64 * 1000.0 / ms)
    kernel_rate = max(rates["kernel"])
    plain_rate = max(rates["plain"])
    print(f"[{tag}] b64 forward: kernel arm {kernel_rate:.1f} img/s, plain "
          f"{plain_rate:.1f} img/s (best of 2 turns each: kernel "
          f"{rates['kernel']}, plain {rates['plain']})")
    return launches, kernel_rate, plain_rate


def _bwd_errors(got, ref):
    """{output: (max|err|, bound)} for dq, dk, dv (slices of dqkv) and
    dW_t of a backward call against the plain version's."""
    (dqkv, dwt), (r_dqkv, r_dwt) = got, ref
    c = dqkv.shape[-1] // 3
    out = {}
    for name, a, r in (("dq", dqkv[..., :c], r_dqkv[..., :c]),
                       ("dk", dqkv[..., c:2 * c], r_dqkv[..., c:2 * c]),
                       ("dv", dqkv[..., 2 * c:], r_dqkv[..., 2 * c:]),
                       ("dW_t", dwt, r_dwt)):
        a, r = a.float(), r.float()
        ok = bool(torch.isfinite(a).all())
        err = (a - r).abs().max().item() if ok else float("inf")
        out[name] = (err, KERNEL_REL_TOL * r.abs().max().item())
    return out


def _bwd_controls():
    """Input changes under which the working backward computes what a
    broken one would, and the outputs each must break: (qkv, w, inds,
    scale) -> the same four."""
    return {
        # dO = g w^T halves, so dq, dk, dv halve; dW_t = o^T g_t is right
        "dqkv halved (w x 0.5)": (
            lambda qkv, w, inds, sc: (qkv, w * 0.5, inds, sc),
            ("dq", "dk", "dv"), ("dW_t",)),
        # g_t gathered from the neighbouring columns: dW_t wrong, dqkv right
        "dW_t from the wrong columns (inds + 1)": (
            lambda qkv, w, inds, sc: (qkv, w, (inds + 1) % w.shape[0], sc),
            ("dW_t",), ("dq", "dk", "dv")),
        "uniform p (scale 0)": (
            lambda qkv, w, inds, sc: (qkv, w, inds, 0.0),
            ("dq", "dk", "dv", "dW_t"), ()),
    }


def _plain_ds(qkv, d_o, heads, scale, seg):
    """(q, k, ds) per head in f32, ds = bf16((p * (dp - rowsum(dp * p))) *
    scale) from the plain pieces, as the kernels round it."""
    from apla_tpu_torch.ops import mha as tmha
    q, k, v = (tmha.split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    d = tmha.split_heads(d_o, heads)
    p = tmha.softmax_f32(q, k, scale, seg)
    dp = torch.matmul(d, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))) * scale
    return q, k, ds.to(torch.bfloat16).float()


def _tile_skipped(dqkv, qkv, d_o, heads, scale, seg, tile, side):
    """dqkv as a backward that skipped one 64-row tile in one product would
    return it: the working kernel's dqkv less that tile's share, computed in
    f32 from the plain pieces.  side "query": key tile `tile` left out of
    the query side's dq = ds k; "key": query tile `tile` left out of the key
    side's dk = ds^T q."""
    from apla_tpu_torch.ops import mha as tmha
    q, k, ds = _plain_ds(qkv, d_o, heads, scale, seg)
    rows = slice(64 * tile, 64 * (tile + 1))
    c = d_o.shape[-1]
    out = dqkv.float()
    if side == "query":
        out[..., :c] -= tmha.merge_heads(torch.matmul(ds[..., rows],
                                                      k[:, :, rows]))
    else:
        out[..., c:2 * c] -= tmha.merge_heads(torch.matmul(
            ds[:, :, rows].transpose(-1, -2), q[:, :, rows]))
    return out.to(dqkv.dtype)


# Phase 4's controls aimed at the redesigned kernels' tiling, each at a
# case of BWD_CASES: (qkv shape, segment_len, tile, side) -> a 64-row tile
# left out of one product, where the plan holds the other side's tiles
# resident (N = 257: key tile 1 of five in dq) and where it streams them
# through its ring (N = 1370: query tile 11 of 22 in dk).
TILE_CONTROLS = (((8, 257, 2304), 0, 1, "query"),
                 ((2, 1370, 2304), 0, 11, "key"))


def _bwd_times(tag, qkv, w, g, inds, heads, scale):
    """The fused backward on (qkv, w, g, inds), timed: by events, from a
    CUDA graph, each launch apart; the plain version; autograd through the
    two-call yardstick; the bound; printed with the launch plans."""
    from apla_tpu_torch.ops.fused_apla_attn import (
        bwd_plans, dw_chunks, fused_apla_attn_bwd, fused_apla_attn_bwd_part,
        fused_apla_attn_bwd_reference)
    b, n, c3 = qkv.shape
    c, k = c3 // 3, len(inds)
    # the yardstick's backward: autograd through its two calls
    lq, lw = qkv.clone().requires_grad_(), w.clone().requires_grad_()
    lout = _library_attn(lq, lw, heads, scale)
    kernel = lambda: fused_apla_attn_bwd(qkv, w, g, inds,  # noqa: E731
                                         heads, scale)
    t = {"ms": _time_ms(kernel), "graph_ms": _graph_ms(kernel),
         "plain_ms": _time_ms(lambda: fused_apla_attn_bwd_reference(
             qkv, w, g, inds, heads, scale)),
         "library_two_calls_ms": _time_ms(lambda: torch.autograd.grad(
             lout, (lq, lw), g, retain_graph=True))}
    del lq, lw, lout
    t["bound_ms"], t["bound_by"] = _attn_bwd_bound(b, n, c, k)
    t["parts"] = _bwd_parts(
        lambda bits: fused_apla_attn_bwd_part(qkv, w, g, inds, heads, scale,
                                              bits),
        _bwd_launch_bounds(b, n, c, k))
    attn, do_gemm, dw_gemm = bwd_plans(b, n, c, heads, k)
    chunks = dw_chunks(b * n, c, k, _sm_count(qkv.device))[1]
    print(f"[{tag}] b{b} N={n} C={c} k={k}: kernel "
          f"{t['ms']:.4f} ms ({t['graph_ms']:.4f} from a CUDA graph), "
          f"plain {t['plain_ms']:.4f} ms, autograd of the two library "
          f"calls {t['library_two_calls_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
          f"{t['bound_ms'] / t['graph_ms']:.1%} of it reached); plans: "
          f"attention {attn.describe()}; dO GEMM {do_gemm.describe()}; "
          f"dW GEMM {dw_gemm.describe()}, for each of {chunks} chunks "
          f"of rows")
    _print_parts(tag, t["parts"])
    return t


def phase_bwd(device):
    from apla_tpu_torch.apla.core import load_indices
    from apla_tpu_torch.ops import cuda_build
    from apla_tpu_torch.ops.fused_apla_attn import (
        _BWD_SOURCE, fused_apla_attn_bwd, fused_apla_attn_bwd_reference)
    from apla_tpu_torch.ops.mha import bwd_plan
    gen = torch.Generator().manual_seed(SEED + 1)
    heads, scale = 12, 64 ** -0.5
    worst = 0.0
    block0 = load_indices(os.path.join(ROOT, RECIPE["model_params"][
        "adaptation"]["params"]["inds_path"]), 12, 768)[0]
    for shape, seg, k in BWD_CASES:
        c = shape[-1] // 3
        qkv = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
        w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(
            device, torch.bfloat16)
        g = torch.randn(shape[:2] + (c,), generator=gen).to(device,
                                                            torch.bfloat16)
        inds = (torch.as_tensor(block0, dtype=torch.int64) if k == "block0"
                else torch.randperm(c, generator=gen)[:k]).to(device)
        got = fused_apla_attn_bwd(qkv, w, g, inds, heads, scale, seg)
        torch.cuda.synchronize()
        ref = fused_apla_attn_bwd_reference(qkv, w, g, inds, heads, scale,
                                            seg)
        errs = _bwd_errors(got, ref)
        ok = all(e <= b for e, b in errs.values())
        print(f"[4 bwd] qkv {list(shape)} seg={seg} k={k}: " + ", ".join(
            f"{n} max|err| {e:.6g} (bound {b:.6g})"
            for n, (e, b) in errs.items()) + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"backward kernel disagrees with its plain "
                             f"version at {shape} seg={seg} k={k}")
        worst = max(worst, max(e for e, _ in errs.values()))
        for c_shape, c_seg, tile, side in TILE_CONTROLS:
            if (c_shape, c_seg) != (shape, seg) or k == "block0":
                continue
            d_o = torch.matmul(g.float(), w.float().t()).to(torch.bfloat16)
            out = _tile_skipped(got[0], qkv, d_o, heads, scale, seg, tile,
                                side)
            c_errs = _bwd_errors((out, got[1]), ref)
            name = "dq" if side == "query" else "dk"
            caught = c_errs[name][0] > c_errs[name][1]
            where = ("resident" if bwd_plan(*shape[:2], heads).resident
                     else "ring")
            print(f"[4 bwd] control {'key' if side == 'query' else 'query'}"
                  f" tile {tile} left out of {name} ({where} at "
                  f"N={shape[1]}): " + ", ".join(
                      f"{n} {e:.6g}" for n, (e, _) in c_errs.items())
                  + f" -> {'caught' if caught else 'NOT CAUGHT'} in "
                  f"['{name}']")
            if not caught:
                raise SystemExit(f"the backward bound misses a skipped tile "
                                 f"at {shape}")
        if k != "block0":
            continue
        for name, (change, broken, intact) in _bwd_controls().items():
            f_qkv, f_w, f_inds, f_scale = change(qkv, w, inds, scale)
            c_errs = _bwd_errors(
                fused_apla_attn_bwd(f_qkv, f_w, g, f_inds, heads, f_scale,
                                    seg), ref)
            caught = all(c_errs[n][0] > c_errs[n][1] for n in broken)
            specific = all(c_errs[n][0] <= c_errs[n][1] for n in intact)
            print(f"[4 bwd] control {name}: " + ", ".join(
                f"{n} {e:.6g}" for n, (e, _) in c_errs.items())
                + f" -> {'caught' if caught else 'NOT CAUGHT'} in "
                f"{list(broken)}"
                + (f", {list(intact)} within the bound" if intact and specific
                   else ""))
            if not caught:
                raise SystemExit(f"the backward bound misses a broken "
                                 f"kernel ({name})")
            if not specific:
                raise SystemExit(f"control {name} broke {list(intact)} too")
    inds = torch.as_tensor(block0, dtype=torch.int64).to(device)
    times = {}
    for b, n in TIMED_SHAPES:
        qkv = torch.randn((b, n, 2304), generator=gen).to(device,
                                                          torch.bfloat16)
        w = (torch.randn((768, 768), generator=gen) * 768 ** -0.5).to(
            device, torch.bfloat16)
        g = torch.randn((b, n, 768), generator=gen).to(device, torch.bfloat16)
        times[(b, n)] = _bwd_times("4 bwd", qkv, w, g, inds, heads, scale)
    for line in _resources(cuda_build.resource_report(_BWD_SOURCE)):
        if line.startswith(("bwd_query_kernel<1>", "bwd_key_kernel",
                            "gemm_kernel")):
            print(f"[4 bwd]   {_BWD_SOURCE}: {line}")
    return worst, times


def _mha_errors(got, ref):
    """{output: (max|err|, bound)} for o and dq, dk, dv (slices of dqkv)
    of an (o, dqkv) pair against the plain versions'."""
    (out, dqkv), (r_out, r_dqkv) = got, ref
    c = out.shape[-1]
    pairs = {"o": (out, r_out)}
    for i, name in enumerate(("dq", "dk", "dv")):
        pairs[name] = (dqkv[..., i * c:(i + 1) * c],
                       r_dqkv[..., i * c:(i + 1) * c])
    errs = {}
    for name, (a, r) in pairs.items():
        a, r = a.float(), r.float()
        ok = bool(torch.isfinite(a).all())
        errs[name] = ((a - r).abs().max().item() if ok else float("inf"),
                      KERNEL_REL_TOL * r.abs().max().item())
    return errs


def _zero_third(dqkv, i):
    """dqkv [..., 3C] with its i-th third (0 dq, 1 dk, 2 dv) zeroed."""
    out = dqkv.clone()
    c = dqkv.shape[-1] // 3
    out[..., i * c:(i + 1) * c] = 0
    return out


def _rowsum_dropped(qkv, d_o, dqkv, heads, scale, seg):
    """dqkv as a backward that drops rowsum(dp * p) from ds would return
    it: the working kernel's dqkv plus that term's share of dq and dk
    (ds gains p * rowsum(dp * p)), computed in f32 from the plain pieces."""
    from apla_tpu_torch.ops import mha as tmha
    q, k, v = (tmha.split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    d = tmha.split_heads(d_o, heads)
    p = tmha.softmax_f32(q, k, scale, seg)
    pd = p * (torch.matmul(d, v.transpose(-1, -2)) * p).sum(-1, keepdim=True)
    extra = torch.cat([tmha.merge_heads(torch.matmul(pd, k) * scale),
                       tmha.merge_heads(torch.matmul(pd.transpose(-1, -2), q)
                                        * scale),
                       torch.zeros_like(d_o, dtype=torch.float32)], dim=-1)
    return (dqkv.float() + extra).to(dqkv.dtype)


def _fwd_key_extent(n):
    """The keys the forward kernel multiplies at length n: the row kernel
    takes its last tile as wide as n needs, rounded up to 16; the two-pass
    kernel whole 64-row tiles."""
    from apla_tpu_torch.ops import mha as tmha
    plan = tmha.fwd_plan(1, n, 12)
    if plan.kind == "row":
        return 64 * (plan.n_tiles - 1) + 16 * -(-(n - 64 * (plan.n_tiles - 1))
                                                // 16)
    return 64 * plan.n_tiles


def _graph_ms(fn, calls=20, iters=10) -> float:
    """Device ms per call of `fn`, from a CUDA graph of `calls` calls (no
    host time between launches; the small shapes are host-bound when
    launched one by one)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(graph.replay, iters=iters, warmup=2) / calls


def phase_mha(device):
    """7a: the memory-efficient attention kernels against their plain
    versions at MHA_CASES, five fault controls, and times at MHA_TIMED."""
    from apla_tpu_torch.ops import mha as tmha
    gen = torch.Generator().manual_seed(SEED + 3)
    heads, c, scale = 12, 768, 64 ** -0.5
    worst = {"fwd": 0.0, "bwd": 0.0}

    def inputs(b, n):
        return (torch.randn((b, n, 3 * c), generator=gen).to(device,
                                                            torch.bfloat16),
                torch.randn((b, n, c), generator=gen).to(device,
                                                         torch.bfloat16))

    def both(fwd, bwd, qkv, d_o, sc, seg):
        return fwd(qkv, heads, sc, seg), bwd(qkv, d_o, heads, sc, seg)

    def run_controls(controls, ref):
        for name, (fault, broken) in controls.items():
            c_errs = _mha_errors(fault(), ref)
            caught = all(c_errs[k][0] > c_errs[k][1] for k in broken)
            print(f"[7a mha] control {name}: " + ", ".join(
                f"{k} {e:.6g}" for k, (e, _) in c_errs.items())
                + f" -> {'caught' if caught else 'NOT CAUGHT'} in "
                f"{list(broken)}")
            if not caught:
                raise SystemExit(f"the mha bound misses a broken kernel "
                                 f"({name})")

    for b, n, seg in MHA_CASES:
        qkv, d_o = inputs(b, n)
        got = both(tmha.mha_fwd, tmha.mha_bwd, qkv, d_o, scale, seg)
        torch.cuda.synchronize()
        ref = both(tmha.mha_fwd_reference, tmha.mha_bwd_reference, qkv, d_o,
                   scale, seg)
        errs = _mha_errors(got, ref)
        ok = all(e <= bd for e, bd in errs.values())
        print(f"[7a mha] qkv [{b}, {n}, {3 * c}] seg={seg}: " + ", ".join(
            f"{name} max|err| {e:.6g} (bound {bd:.6g})"
            for name, (e, bd) in errs.items()) + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"mha kernels disagree with their plain versions "
                             f"at [{b}, {n}] seg={seg}")
        worst["fwd"] = max(worst["fwd"], errs["o"][0])
        worst["bwd"] = max(worst["bwd"], *(errs[k][0] for k in
                                           ("dq", "dk", "dv")))
        out, dqkv = got
        if (b, n, seg) in MHA_PAD_CASES:
            # the zero-filled keys of the kernel's last tile counted as keys,
            # as a kernel that forgot the column mask would
            pad = _fwd_key_extent(n) - n
            run_controls({
                f"padding columns left unmasked (N {n} -> {n + pad})": (
                    lambda: (tmha.mha_fwd(torch.nn.functional.pad(
                        qkv, (0, 0, 0, pad)), heads, scale, seg)[:, :n],
                        dqkv), ("o",))}, ref)
        if (b, n, seg) != (8, 257, 0):
            continue
        # Fault controls: the working kernels made to compute what broken
        # ones would, each against this case's plain versions.
        run_controls({
            "output halved": (lambda: (out * 0.5, dqkv), ("o",)),
            "uniform p (scale 0)": (
                lambda: both(tmha.mha_fwd, tmha.mha_bwd, qkv, d_o, 0.0, seg),
                ("o", "dq", "dk", "dv")),
            "dq zeroed": (lambda: (out, _zero_third(dqkv, 0)), ("dq",)),
            "rowsum(dp * p) dropped from ds": (
                lambda: (out, _rowsum_dropped(qkv, d_o, dqkv, heads, scale,
                                              seg)), ("dq", "dk")),
        }, ref)

    # the forward at every timed shape: kernel (launched one by one, from a
    # CUDA graph, and the host's time per launch: its checks, its launch
    # plan, the two tensor maps it encodes), SDPA (both ways), bound, launch
    # plan; the backward,
    # the plain versions and SDPA's autograd at the served b64 shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for b, n in MHA_TIMED:
        qkv, d_o = inputs(b, n)
        q, k, v = qkv.unflatten(-1, (3, heads, 64)).permute(2, 0, 3, 1, 4)
        kernel = lambda: tmha.mha_fwd(qkv, heads, scale)  # noqa: E731
        library = lambda: sdpa(q, k, v, scale=scale)  # noqa: E731
        t = {"host_ms": _host_ms(kernel), "ms": _time_ms(kernel),
             "graph_ms": _graph_ms(kernel),
             "library_ms": _time_ms(library),
             "library_graph_ms": _graph_ms(library),
             "max_abs_err": worst["fwd"]}
        t["bound_ms"], t["bound_by"] = _bound(4 * b * n * n * c,
                                              2 * 4 * b * n * c)
        if (b, n) == MHA_TIMED[0]:
            t["plain_ms"] = _time_ms(
                lambda: tmha.mha_fwd_reference(qkv, heads, scale), iters=5)
        times[("fwd", b, n)] = t
        plan = tmha.fwd_plan(b, n, heads)
        print(f"[7a mha] fwd b{b} N={n} C={c}: kernel {t['ms']:.4f} ms "
              f"({t['graph_ms']:.4f} from a CUDA graph; the host takes "
              f"{t['host_ms']:.4f} to launch one), SDPA "
              f"{t['library_ms']:.4f} ({t['library_graph_ms']:.4f}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{t['bound_ms'] / t['graph_ms']:.1%} of it reached); plan: "
              + plan.describe())
    # the backward at every timed shape: kernel (by events and from a CUDA
    # graph, its two launches apart), SDPA's autograd, bound, launch plan;
    # the plain version at the first
    for b, n in MHA_TIMED:
        qkv, d_o = inputs(b, n)
        lq = qkv.clone().requires_grad_()
        lout = sdpa(*lq.unflatten(-1, (3, heads, 64)).permute(2, 0, 3, 1, 4),
                    scale=scale)
        lg = d_o.unflatten(-1, (heads, 64)).transpose(1, 2)
        kernel = lambda: tmha.mha_bwd(qkv, d_o, heads, scale)  # noqa: E731
        t = {"ms": _time_ms(kernel), "graph_ms": _graph_ms(kernel),
             "library_ms": _time_ms(lambda: torch.autograd.grad(
                 lout, lq, lg, retain_graph=True)),
             "max_abs_err": worst["bwd"]}
        del lq, lout
        t["bound_ms"], t["bound_by"] = _bound(10 * b * n * n * c,
                                              2 * 7 * b * n * c)
        if (b, n) == MHA_TIMED[0]:
            t["plain_ms"] = _time_ms(lambda: tmha.mha_bwd_reference(
                qkv, d_o, heads, scale), iters=5)
        t["parts"] = _bwd_parts(
            lambda bits: tmha.mha_bwd_part(qkv, d_o, heads, scale, bits),
            _bwd_launch_bounds(b, n, c))
        times[("bwd", b, n)] = t
        print(f"[7a mha] bwd b{b} N={n} C={c}: kernel {t['ms']:.4f} ms "
              f"({t['graph_ms']:.4f} from a CUDA graph), SDPA's autograd "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['bound_ms'] / t['graph_ms']:.1%} of it "
              f"reached); plan: {tmha.bwd_plan(b, n, heads).describe()}")
        _print_parts("7a mha", t["parts"])
    b, n = MHA_TIMED[0]
    t = times[("bwd", b, n)]
    print(f"[7a mha] bwd b{b} N={n}: plain {t['plain_ms']:.4f} ms")
    fwd = times[("fwd", b, n)]
    print(f"[7a mha] fwd b{b} N={n}: plain {fwd['plain_ms']:.4f} ms")
    return {"fwd": fwd, "bwd": t, "fwd_by_shape": {
                key: v for key, v in times.items() if key[0] == "fwd"},
            "bwd_by_shape": {key: v for key, v in times.items()
                             if key[0] == "bwd"}}


def phase_full(device):
    """7b: FULL_RECIPE served (as phase 3) and trained (as phase 5) through
    the memory-efficient attention kernels."""
    from apla_tpu_torch.ops import attention
    from apla_tpu_torch.ops import mha as tmha
    real = attention.mha
    faults = {
        "output halved": lambda run: _with_output_fault(
            attention, "mha", lambda o: o * 0.5, run),
        "uniform p (scale 0)": lambda run: _with_patch(
            attention, "mha", lambda qkv, h, sc, seg=0: real(qkv, h, 0.0, seg),
            run),
    }
    serve = _serve_phase(device, FULL_RECIPE, "7b full serve", tmha.mha_fwd,
                         faults)
    # on the backward's dqkv; dq zeroed is no control here: at this random
    # init p is near uniform and the loss barely feels q (phase 7a holds dq)
    controls = {
        "dv zeroed": (tmha, "mha_bwd", lambda d: _zero_third(d, 2)),
        "dqkv halved": (tmha, "mha_bwd", lambda d: d * 0.5),
    }
    # blocks_without_bwd=1: block 0's attention sees the frozen patch
    # embedding through the frozen qkv, so nothing upstream of it needs a
    # gradient, and autograd (as XLA in JAX) runs no attention backward there
    with tempfile.TemporaryDirectory(prefix="chip_smoke_full_") as tmp:
        train = _train_phase(
            device, tmp, FULL_RECIPE, FULL_CUTS, "7b full train", "kernel",
            (tmha.mha_fwd, tmha.mha_bwd), 1, controls,
            (LOSS_TOL, GRAD_REL_TOL), profile=True)
    return serve, train


def _swin_case(images, stage, shifted, gen, device):
    """Phase 8a's inputs at one stage: bf16 qkv [B, 49, 3C], w [C, C],
    g [B, 49, C]; the f32 relative-position bias [H, 49, 49] (N(0, 1), so
    that a kernel that drops it shows) and the stage's shift mask or None."""
    from apla_tpu_torch.models.swin import _shift_mask
    side = 56 >> stage
    c, heads = 96 << stage, 3 << stage
    n_w = (side // 7) ** 2
    b = images * n_w
    qkv = torch.randn((b, 49, 3 * c), generator=gen).to(device,
                                                        torch.bfloat16)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(device,
                                                            torch.bfloat16)
    g = torch.randn((b, 49, c), generator=gen).to(device, torch.bfloat16)
    bias = torch.randn((heads, 49, 49), generator=gen).to(device)
    mask = torch.from_numpy(_shift_mask(side, side, 7, 3)).to(device) \
        if shifted else None
    return qkv, w, g, bias, mask, heads


def _swin_bounds(b, c, heads, n_w, n=49):
    """(forward, backward) bounds of the window kernels on b windows of n
    tokens: the forward's q k^T and p v over all heads (2 N^2 C each) and
    the projection (2 N C^2), reading qkv, w, the bias and the mask (n_w
    planes, 0 without one) and writing out; the backward's dO (2 N C^2),
    the scores and o recomputed, dv, dp, dq, dk (six 2 N^2 C products) and
    dW (2 N C^2), reading qkv, w, g, bias, mask, writing dqkv and dW f32."""
    planes = 4 * (heads + n_w) * n * n
    return (_bound(b * (4 * n * n * c + 2 * n * c * c),
                   2 * (3 * b * n * c + c * c + b * n * c) + planes),
            _bound(b * (12 * n * n * c + 4 * n * c * c),
                   2 * (3 * b * n * c + c * c + b * n * c + 3 * b * n * c)
                   + planes + 4 * c * c))


def _swin_launch_bounds(b, c, n_w):
    """(attention, projection) bounds of the forward's two launches on b
    windows of 49 tokens: q k^T and p v (2 N^2 C each) reading qkv, the
    bias and the mask and writing o; o @ w (2 N C^2) reading o and w and
    writing out."""
    n, heads = 49, c // 32
    planes = 4 * (heads + n_w) * n * n
    return (_bound(4 * b * n * n * c, 2 * 4 * b * n * c + planes),
            _bound(2 * b * n * c * c, 2 * (2 * b * n * c + c * c)))


def _swin_bwd_launch_bounds(b, c, n_w):
    """Bounds of the backward's three launches on b windows of 49 tokens:
    the dO GEMM (2 N C^2; reads g and w, writes dO), the attention (s, dp,
    o, dq, dk, dv: six 2 N^2 C products; reads qkv, dO, the bias and the
    mask, writes dqkv and o_cat), the dW partials and their sum (2 N C^2;
    reads o_cat and g, writes dW f32)."""
    n, heads = 49, c // 32
    bnc, planes = b * n * c, 4 * (heads + n_w) * n * n
    return {"dO GEMM": _bound(2 * bnc * c, 2 * (2 * bnc + c * c)),
            "attention": _bound(12 * b * n * n * c,
                                2 * (4 * bnc + 4 * bnc) + planes),
            "dW partials + reduce": _bound(2 * bnc * c,
                                           2 * 2 * bnc + 4 * c * c)}


def _swin_bwd_times(qkv, w, g, bias, mask, heads, scale):
    """The window backward timed: the call from a CUDA graph and as the
    host's time per call; its three launches apart
    (`fused_swin_attn_bwd_part`, each on the buffers of a whole call), by
    events and from graphs, beside their bounds."""
    from apla_tpu_torch.ops import fused_swin_attn as fs
    call = lambda: fs.fused_swin_attn_bwd(qkv, w, g, bias,  # noqa: E731
                                          mask, heads, scale)
    bufs = fs.fused_swin_attn_bwd_part(qkv, w, g, bias, mask, heads, scale,
                                       fs.BWD_PARTS_ALL)
    bounds = _swin_bwd_launch_bounds(qkv.shape[0], w.shape[0],
                                     0 if mask is None else mask.shape[0])
    parts = {}
    for name, bit in (("dO GEMM", fs.BWD_DO), ("attention", fs.BWD_ATTN),
                      ("dW partials + reduce", fs.BWD_DW)):
        fn = functools.partial(fs.fused_swin_attn_bwd_part, qkv, w, g, bias,
                               mask, heads, scale, bit, bufs)
        parts[name] = {"ms": _time_ms(fn), "graph_ms": _graph_ms(fn)}
        parts[name]["bound_ms"], parts[name]["bound_by"] = bounds[name]
    return {"host_ms": _host_ms(call), "graph_ms": _graph_ms(call),
            "parts": parts}


def _swin_fwd_times(qkv, w, bias, mask, heads, scale, library):
    """The window forward timed: the call by events, from a CUDA graph and
    as the host's time per call; its two launches apart (the attention
    into o, the projection of o), by events and from graphs, beside their
    bounds; the two-call yardstick from a graph."""
    from apla_tpu_torch.ops import fused_swin_attn as fs
    call = lambda: fs.fused_swin_attn_fwd(qkv, w, bias, mask,  # noqa: E731
                                          heads, scale)
    attention = functools.partial(fs.fused_swin_attn_fwd_part, qkv, w, bias,
                                  mask, heads, scale, fs.PART_ATTN)
    o = attention()
    projection = functools.partial(fs.fused_swin_attn_fwd_part, qkv, w, bias,
                                   mask, heads, scale, fs.PART_PROJ, o)
    t = {"host_ms": _host_ms(call), "graph_ms": _graph_ms(call),
         "attention_ms": _time_ms(attention),
         "attention_graph_ms": _graph_ms(attention),
         "projection_ms": _time_ms(projection),
         "projection_graph_ms": _graph_ms(projection),
         "library_two_calls_graph_ms": _graph_ms(library)}
    (t["attention_bound_ms"], _), (t["projection_bound_ms"], _) = \
        _swin_launch_bounds(qkv.shape[0], w.shape[0],
                            0 if mask is None else mask.shape[0])
    return t


def _swin_library(qkv, w, heads, scale, attn_mask):
    """The window kernels' two-call yardstick: F.scaled_dot_product_attention
    with the additive mask bias + mask, then one torch.matmul (and the head
    merge between them).  The port never calls these."""
    b, n, c3 = qkv.shape
    q, k, v = qkv.unflatten(-1, (3, heads, c3 // (3 * heads))) \
        .permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, scale=scale)
    return torch.matmul(o.transpose(1, 2).reshape(b, n, c3 // 3), w)


def _swin_errors(got, ref):
    """{output: (max|err|, bound)} for out, dqkv and dW."""
    errs = {}
    for name, a, r in zip(("out", "dqkv", "dW"), got, ref):
        a, r = a.float(), r.float()
        ok = bool(torch.isfinite(a).all())
        errs[name] = ((a - r).abs().max().item() if ok else float("inf"),
                      KERNEL_REL_TOL * r.abs().max().item())
    return errs


def phase_swin(device):
    """8a: the Swin window kernels (rows 3, 4) against their plain versions
    at SWIN_CASES (and the forward's attention launch alone against its
    plain version), seven fault controls at the first case, and times at
    every stage's b16 windows beside the bounds and the two-call yardstick
    (the forward also from CUDA graphs, host ms per call and each launch
    apart), and the served b1 windows from a graph."""
    from apla_tpu_torch.ops import cuda_build
    from apla_tpu_torch.ops import fused_swin_attn as fs
    gen = torch.Generator().manual_seed(SEED + 4)
    scale = 32 ** -0.5
    worst = {"fwd": 0.0, "attention": 0.0, "bwd": 0.0}
    times = {}

    def kernels(qkv, w, g, bias, mask, heads, sc=scale):
        return (fs.fused_swin_attn_fwd(qkv, w, bias, mask, heads, sc),
                *fs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads, sc))

    def plain(qkv, w, g, bias, mask, heads, sc=scale):
        return (fs.fused_swin_attn_fwd_reference(qkv, w, bias, mask, heads,
                                                 sc),
                *fs.fused_swin_attn_bwd_reference(qkv, w, g, bias, mask,
                                                  heads, sc))

    for images, stage, shifted in SWIN_CASES:
        qkv, w, g, bias, mask, heads = _swin_case(images, stage, shifted,
                                                  gen, device)
        b, c = qkv.shape[0], w.shape[0]
        got = kernels(qkv, w, g, bias, mask, heads)
        torch.cuda.synchronize()
        ref = plain(qkv, w, g, bias, mask, heads)
        errs = _swin_errors(got, ref)
        ok = all(e <= bd for e, bd in errs.values())
        tag = (f"b{images} stage {stage} qkv [{b}, 49, {3 * c}] "
               f"{'shifted' if shifted else 'unshifted'}")
        print(f"[8a swin] {tag}: " + ", ".join(
            f"{n} max|err| {e:.6g} (bound {bd:.6g})"
            for n, (e, bd) in errs.items()) + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"Swin window kernels disagree with their plain "
                             f"versions at {tag}")
        # the forward's attention launch alone against its plain version
        o = fs.fused_swin_attn_fwd_part(qkv, w, bias, mask, heads, scale,
                                        fs.PART_ATTN)
        o_ref = fs.swin_attn_reference(qkv, bias, mask, heads, scale).float()
        o_err = (o.float() - o_ref).abs().max().item() \
            if bool(torch.isfinite(o).all()) else float("inf")
        o_bound = KERNEL_REL_TOL * o_ref.abs().max().item()
        print(f"[8a swin] {tag}: the attention launch alone (o) max|err| "
              f"{o_err:.6g} (bound {o_bound:.6g}) -> "
              f"{'ok' if o_err <= o_bound else 'FAIL'}")
        if o_err > o_bound:
            raise SystemExit(f"the Swin attention launch disagrees with its "
                             f"plain version at {tag}")
        worst["fwd"] = max(worst["fwd"], errs["out"][0])
        worst["attention"] = max(worst["attention"], o_err)
        worst["bwd"] = max(worst["bwd"], errs["dqkv"][0], errs["dW"][0])
        if (images, stage, shifted) == SWIN_CASES[0]:
            n_w = mask.shape[0]
            pad = 15
            # fault controls: the working kernels made to compute what broken
            # ones would, each against this case's plain versions
            first_image = torch.cat([mask, torch.zeros(
                (b - n_w,) + mask.shape[1:], device=device)])
            controls = {
                "bias dropped": (
                    lambda: kernels(qkv, w, g, bias * 0, mask, heads),
                    ("out", "dqkv", "dW")),
                "mask dropped (shifted block)": (
                    lambda: kernels(qkv, w, g, bias, None, heads),
                    ("out", "dqkv", "dW")),
                # the mask read at plane b, not b mod nW: the planes past nW
                # (here zeros) reach every image after the first
                "mask indexed by b, not b mod nW": (
                    lambda: kernels(qkv, w, g, bias, first_image, heads),
                    ("out", "dqkv", "dW")),
                # the 15 zero-filled rows of the 64-row key tile counted as
                # keys, as a kernel that forgot the column mask would
                "padded keys left unmasked (N 49 -> 64)": (
                    lambda: (fs.fused_swin_attn_fwd(
                        torch.nn.functional.pad(qkv, (0, 0, 0, pad)), w,
                        torch.nn.functional.pad(bias, (0, pad, 0, pad)),
                        torch.nn.functional.pad(mask, (0, pad, 0, pad)),
                        heads, scale)[:, :49], got[1], got[2]), ("out",)),
                # the attention launch writing head h at head h+1's
                # columns (mod H), then the projection reading that o
                "heads at the wrong columns of o": (
                    lambda: (fs.fused_swin_attn_fwd_part(
                        qkv, w, bias, mask, heads, scale, fs.PART_PROJ,
                        o.unflatten(-1, (heads, 32)).roll(1, dims=2)
                        .flatten(-2).contiguous()), got[1], got[2]),
                    ("out",)),
                # the backward writing head h's dk and dv at head h+1's
                # columns (mod H): its items' outputs stored one head over
                "dk, dv at the next head's columns": (
                    lambda: (got[0], torch.cat(
                        [got[1][..., :c], got[1][..., c:].unflatten(
                            -1, (2, heads, 32)).roll(1, dims=-2).flatten(-3)],
                        dim=-1), got[2]), ("dqkv",)),
                "dW zeroed": (lambda: (got[0], got[1], got[2] * 0), ("dW",)),
                "dqkv halved": (lambda: (got[0], got[1] * 0.5, got[2]),
                                ("dqkv",)),
            }
            for name, (fault, broken) in controls.items():
                c_errs = _swin_errors(fault(), ref)
                caught = all(c_errs[k][0] > c_errs[k][1] for k in broken)
                print(f"[8a swin] control {name}: " + ", ".join(
                    f"{k} {e:.6g}" for k, (e, _) in c_errs.items())
                    + f" -> {'caught' if caught else 'NOT CAUGHT'} in "
                    f"{list(broken)}")
                if not caught:
                    raise SystemExit(f"the Swin kernel bound misses a broken "
                                     f"kernel ({name})")
        if images != 16 or (shifted != (stage < 3)):
            continue
        # times at this stage's b16 windows: kernels, plain versions, the
        # two-call yardstick (autograd through it for the backward)
        idx = torch.arange(b, device=device) % (mask.shape[0] if shifted
                                                else 1)
        attn_mask = (bias[None] + (mask[idx][:, None] if shifted else 0.0)
                     ).to(torch.bfloat16)
        lq, lw = qkv.clone().requires_grad_(), w.clone().requires_grad_()
        lout = _swin_library(lq, lw, heads, scale, attn_mask)
        n_w = mask.shape[0] if shifted else 0
        bounds = _swin_bounds(b, c, heads, n_w)
        calls = {
            "fwd": (lambda: fs.fused_swin_attn_fwd(qkv, w, bias, mask, heads,
                                                   scale),
                    lambda: fs.fused_swin_attn_fwd_reference(
                        qkv, w, bias, mask, heads, scale),
                    lambda: _swin_library(qkv, w, heads, scale, attn_mask)),
            "bwd": (lambda: fs.fused_swin_attn_bwd(qkv, w, g, bias, mask,
                                                   heads, scale),
                    lambda: fs.fused_swin_attn_bwd_reference(
                        qkv, w, g, bias, mask, heads, scale),
                    lambda: torch.autograd.grad(lout, (lq, lw), g,
                                                retain_graph=True)),
        }
        for i, (name, (kernel, plain_fn, library)) in enumerate(
                calls.items()):
            t = {"ms": _time_ms(kernel), "plain_ms": _time_ms(plain_fn,
                                                              iters=5),
                 "library_two_calls_ms": _time_ms(library)}
            t["bound_ms"], t["bound_by"] = bounds[i]
            times[(stage, name)] = t
            print(f"[8a swin] {name} b16 stage {stage} [{b}, 49, {3 * c}]: "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"two library calls (SDPA + matmul"
                  f"{', autograd' if name == 'bwd' else ''}) "
                  f"{t['library_two_calls_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
                  f"{t['bound_ms'] / t['ms']:.1%} of it reached)")
            if name == "bwd":
                t.update(_swin_bwd_times(qkv, w, g, bias, mask, heads,
                                         scale))
                _print_parts("8a swin", t["parts"])
                print(f"[8a swin]   bwd from a CUDA graph {t['graph_ms']:.4f}"
                      f" ms (the host takes {t['host_ms']:.4f} to launch one"
                      f" call), bound {t['bound_ms'] / t['graph_ms']:.1%} of "
                      f"the graph time; attention plan "
                      f"{fs.swin_bwd_plan(b, 49, heads).describe()}")
            if name == "fwd":
                t.update(_swin_fwd_times(qkv, w, bias, mask, heads, scale,
                                         library))
                print(f"[8a swin]   fwd from a CUDA graph {t['graph_ms']:.4f}"
                      f" ms (the host takes {t['host_ms']:.4f} to launch one"
                      f" call) = attention {t['attention_ms']:.4f} "
                      f"({t['attention_graph_ms']:.4f}; bound "
                      f"{t['attention_bound_ms']:.4f}) + projection "
                      f"{t['projection_ms']:.4f} "
                      f"({t['projection_graph_ms']:.4f}; bound "
                      f"{t['projection_bound_ms']:.4f}); two library calls "
                      f"from a graph {t['library_two_calls_graph_ms']:.4f}; "
                      f"bound {t['bound_ms'] / t['graph_ms']:.1%} of the "
                      f"graph time; plans: attention "
                      f"{fs.swin_plan(b, 49, heads).describe()}; projection "
                      f"{fs.proj_plan(b * 49, c).describe()}")
        del lq, lw, lout
    # Swin-B's windows at 384, past one tile: both kernels against their
    # plain versions
    images, side, win, c = SWIN_WIDE_CASE
    from apla_tpu_torch.models.swin import _shift_mask
    n, heads = win * win, c // 32
    b = images * (side // win) ** 2
    qkv = torch.randn((b, n, 3 * c), generator=gen).to(device,
                                                      torch.bfloat16)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(device,
                                                            torch.bfloat16)
    g = torch.randn((b, n, c), generator=gen).to(device, torch.bfloat16)
    bias = torch.randn((heads, n, n), generator=gen).to(device)
    mask = torch.from_numpy(_shift_mask(side, side, win, win // 2)).to(device)
    got = kernels(qkv, w, g, bias, mask, heads)
    torch.cuda.synchronize()
    errs = _swin_errors(got, plain(qkv, w, g, bias, mask, heads))
    ok = all(e <= bd for e, bd in errs.values())
    print(f"[8a swin] b{images} Swin-B window {win} (N = {n}) qkv [{b}, {n}, "
          f"{3 * c}] shifted: " + ", ".join(
              f"{k} max|err| {e:.6g} (bound {bd:.6g})"
              for k, (e, bd) in errs.items())
          + f" -> {'ok' if ok else 'FAIL'}; backward plan "
          f"{fs.swin_bwd_plan(b, n, heads).describe()}")
    # the bounds there and at the other windows `tools/compare_mha_fwd.py
    # --kernel swin` times: (windows, N, C, mask planes)
    for wb, wn, wc, planes in ((b, n, c, (side // win) ** 2),
                               (1024, 49, 96, 0), (64, 49, 96, 64),
                               (512, 49, 96, 64), (256, 64, 96, 4)):
        (f_ms, f_by), (b_ms, b_by) = _swin_bounds(wb, wc, wc // 32, planes,
                                                  wn)
        print(f"[8a swin] bounds at [{wb}, {wn}, {3 * wc}], {planes} mask "
              f"planes: forward {f_ms:.4f} ms ({f_by}), backward "
              f"{b_ms:.4f} ms ({b_by})")
    if not ok:
        raise SystemExit(f"Swin window kernels disagree with their plain "
                         f"versions at N = {n}")
    worst["fwd"] = max(worst["fwd"], errs["out"][0])
    worst["bwd"] = max(worst["bwd"], errs["dqkv"][0], errs["dW"][0])
    # the served windows (b1, stage 0, shifted) from a graph: the forward
    # and the two-call yardstick
    qkv, w, g, bias, mask, heads = _swin_case(1, 0, True, gen, device)
    idx = torch.arange(qkv.shape[0], device=device) % mask.shape[0]
    attn_mask = (bias[None] + mask[idx][:, None]).to(torch.bfloat16)
    call = lambda: fs.fused_swin_attn_fwd(qkv, w, bias, mask,  # noqa: E731
                                          heads, scale)
    served = {"graph_ms": _graph_ms(call), "host_ms": _host_ms(call),
              "library_two_calls_graph_ms": _graph_ms(
                  lambda: _swin_library(qkv, w, heads, scale, attn_mask))}
    print(f"[8a swin] fwd b1 stage 0 [{qkv.shape[0]}, 49, 288] (served): "
          f"from a CUDA graph {served['graph_ms']:.4f} ms (host "
          f"{served['host_ms']:.4f} ms a call), two library calls from a "
          f"graph {served['library_two_calls_graph_ms']:.4f} ms")
    for src in (fs._SOURCE, fs._BWD_SOURCE):
        for line in _resources(cuda_build.resource_report(src)):
            print(f"[8a swin]   {src}: {line}")
    for name in ("fwd", "bwd"):
        times[name] = {**times[(0, name)], "max_abs_err": worst[name]}
    times["fwd"]["attention_max_abs_err"] = worst["attention"]
    times["fwd_served"] = served
    return times


def _write_coco(root):
    """The synthetic COCO-format set of phase 8b under `root`: DET_IMAGES
    PNGs (224^2, every eighth 256 x 192) of dark noise with 1-8 filled
    rectangles, one colour per category of DET_CLASSES, and an
    instances.json in COCO layout.  -> (image dir, annotation file)."""
    from apla_tpu_torch.data.detection_data import write_png
    rng = np.random.default_rng(SEED)
    colours = rng.integers(64, 256, (DET_CLASSES, 3))
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, anns = [], []
    for i in range(DET_IMAGES):
        w, h = (256, 192) if i % 8 == 7 else (224, 224)
        img = rng.integers(0, 48, (h, w, 3)).astype(np.uint8)
        for _ in range(int(rng.integers(1, 9))):
            cat = int(rng.integers(DET_CLASSES))
            bw, bh = int(rng.integers(16, w // 2)), int(rng.integers(16,
                                                                     h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0,
                                                                    h - bh))
            img[y0:y0 + bh, x0:x0 + bw] = colours[cat]
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": cat + 1, "bbox": [x0, y0, bw, bh],
                         "area": bw * bh, "iscrowd": 0})
        name = f"{i:012d}.png"
        write_png(os.path.join(img_dir, name), img)
        images.append({"id": i, "file_name": name, "width": w, "height": h})
    ann_file = os.path.join(root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c + 1, "name": f"category_{c + 1}"}
                                  for c in range(DET_CLASSES)]}, f)
    return img_dir, ann_file


def phase_det(device, keep=None):
    """8b; with `keep` (as phase 6b's), its artifact, data and
    `--eval_only` mAP@50 stay for phase 12d: `keep["det"]`."""
    if keep is not None:
        return _phase_det(device, _subdir(keep["dir"], "det"), keep)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_det_") as tmp:
        return _phase_det(device, tmp)


def _det_grads(model, cfg, batch, strides):
    """Loss and f32 gradients of one detection step (no update)."""
    from apla_tpu_torch.models.detection import (detector_forward,
                                                 fcos_loss_batch)
    params = _trainables(model)
    for p in params.values():
        p.grad = None
    loss = fcos_loss_batch(detector_forward(model, batch["image"], cfg),
                           strides, batch["boxes"], batch["labels"])["total"]
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in params.items()}


def _det_agreement(name, got, ref):
    """The first step's relative |delta loss| and worst per-tensor gradient
    deviation against DET_LOSS_REL_TOL and DET_GRAD_REL_TOL."""
    loss_tol = DET_LOSS_REL_TOL * abs(ref[0])
    return _grad_agreement("8b det", name, got, ref, loss_tol,
                           DET_GRAD_REL_TOL)


def _phase_det(device, tmp, keep=None):
    from apla_tpu_torch import segdet
    from apla_tpu_torch.data.detection_data import (CocoDetection,
                                                    detection_collate)
    from apla_tpu_torch.data.loader import DataLoader
    from apla_tpu_torch.models.detection import (default_strides,
                                                 detection_optimizer,
                                                 detector_forward,
                                                 init_detector,
                                                 make_detection_train_step)
    from apla_tpu_torch.models.swin import swin_features
    from apla_tpu_torch.ops import fused_swin_attn as fs
    from apla_tpu_torch.ops.quant import quantize_frozen_backbone
    from apla_tpu_torch.serve import (DetPredictor, detector_from_state,
                                      export_detector, load_predictor)

    t0 = time.perf_counter()
    img_dir, ann = _write_coco(tmp)
    r = DET_RECIPE
    cfg = segdet.swin_config(r["img_size"], r["embed_dim"], r["depths"],
                             r["num_heads"], r["window_size"], r["bf16"],
                             r["use_fused"])
    plain_cfg = dataclasses.replace(cfg, use_fused_apla=False)
    strides = default_strides(cfg)
    depth = sum(cfg.depths)
    bsz = r["batch_size"]
    steps, evals = DET_IMAGES // bsz, -(-DET_IMAGES // bsz)
    ds = CocoDetection(img_dir, ann, img_size=r["img_size"],
                       max_boxes=r["max_boxes"])
    print(f"[8b det] wrote {DET_IMAGES} PNGs, {ds.n_classes} categories, "
          f"{sum(len(a) for a in ds.anns_by_image.values())} boxes in "
          f"{time.perf_counter() - t0:.1f} s")

    # the kernel arm against the plain arm: the loop's first batch, the same
    # weights (the loop's init from SEED)
    loader = DataLoader(ds, batch_size=bsz, shuffle=True, drop_last=True,
                        num_workers=0, collate_fn=detection_collate,
                        seed=SEED)
    batch = {k: v.to(device) for k, v in next(iter(loader)).items()}
    model = init_detector(cfg, ds.n_classes,
                          torch.Generator().manual_seed(SEED), device)
    n_train = sum(p.numel() for p in _trainables(model).values())
    n_proj = sum(p.numel() for n, p in _trainables(model).items()
                 if ".attn.proj." in n)
    print(f"[8b det] APLA-Swin-T FCOS detector: {n_train:,} trainable in "
          f"{len(_trainables(model))} tensors ({n_proj:,} in the {depth} attn.proj"
          f"), {sum(p.numel() for p in model.parameters()):,} in all")
    ref = _det_grads(model, plain_cfg, batch, strides)
    ok = _det_agreement("kernel arm", _det_grads(model, cfg, batch, strides),
                        ref)
    controls = {"dW zeroed": lambda out: (out[0], out[1] * 0),
                "dqkv halved": lambda out: (out[0] * 0.5, out[1])}
    caught = all([not _det_agreement(f"control: {name}", _with_output_fault(
        fs, "fused_swin_attn_bwd", fault,
        lambda: _det_grads(model, cfg, batch, strides)), ref)
        for name, fault in controls.items()])
    with torch.no_grad():
        feats = [swin_features(model.backbone, batch["image"], c)
                 for c in (cfg, plain_cfg)]
    cosines = [torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()
        for a, b in zip(*feats)]
    print(f"[8b det] pyramid features kernel vs plain arm, cosine per level "
          f"{[round(x, 6) for x in cosines]} (bound {DET_MIN_COSINE})")
    del feats
    if not ok or min(cosines) < DET_MIN_COSINE:
        raise SystemExit("the detector's kernel arm disagrees with its "
                         "plain arm")
    if not caught:
        raise SystemExit("a broken window backward passes the gradient "
                         "bounds")
    for p in model.parameters():
        p.grad = None

    # train, evaluate, checkpoint through the loop; then --resume and
    # --eval_only, and the plain arm
    init_t, init_f = segdet._state(init_detector(
        cfg, ds.n_classes, torch.Generator().manual_seed(SEED)))
    kw = {k: v for k, v in r.items()}
    kw.update(DET_CUTS, seed=SEED, device=str(device))
    kdir = os.path.join(tmp, "kernel")
    counters = (fs.fused_swin_attn_fwd, fs.fused_swin_attn_bwd)
    launches = [0, 0]

    def run(expect, what, **extra):
        for c in counters:
            c.launches = 0
        t = time.perf_counter()
        out = segdet.train_detection(img_dir, ann, **{**kw, **extra})
        _sync(device)
        got = tuple(c.launches for c in counters)
        print(f"[8b det] {what}: {out} in {time.perf_counter() - t:.1f} s; "
              f"window kernel launches forward {got[0]}, backward {got[1]} "
              f"(expected {expect[0]}, {expect[1]})")
        if got != expect:
            raise SystemExit(f"{what} did not run the window kernels in "
                             "every block of every step and eval call")
        return out, got

    per_epoch = (depth * (steps + evals), depth * steps)
    out, got = run(per_epoch, "train 1 epoch (kernel arm)", save_dir=kdir)
    launches = [a + b for a, b in zip(launches, got)]
    with open(os.path.join(kdir, "det.metrics.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f
                  if "train_loss" in line]
    print(f"[8b det] losses {losses}")
    if (out["iters"] != steps or len(losses) != steps
            or not np.isfinite(losses).all()):
        raise SystemExit(f"missing or non-finite detection losses {losses}")
    if not all(segdet._has_ckpt(kdir, n) for n in ("det_best", "det_last",
                                                   "det_frozen")):
        raise SystemExit(f"checkpoints missing: {sorted(os.listdir(kdir))}")
    best = segdet.load_checkpoint(os.path.join(kdir, "det_best.pt"))
    last = segdet.load_checkpoint(os.path.join(kdir, "det_last.pt"))
    kept = all(torch.equal(best["frozen"][n], t) for n, t in init_f.items())
    moved = {n: not torch.equal(last["trainable"][n], t)
             for n, t in init_t.items()}
    print(f"[8b det] {sum(moved.values())}/{len(moved)} trainable tensors "
          f"moved, {len(init_f)} frozen tensors "
          f"{'unchanged bit for bit' if kept else 'CHANGED'}; checkpoints "
          f"{sorted(os.listdir(kdir))}")
    if not kept or not all(moved.values()):
        raise SystemExit(f"trainable not moved "
                         f"{[n for n, m in moved.items() if not m]} or "
                         "frozen changed")
    out2, got = run(per_epoch, "--resume to 2 epochs", save_dir=kdir,
                    epochs=2, resume=True)
    launches = [a + b for a, b in zip(launches, got)]
    if out2["iters"] != steps:
        raise SystemExit("--resume did not continue at the second epoch")
    with open(os.path.join(kdir, "det_best.json")) as f:
        best_map = json.load(f)["map50"]
    out3, got = run((depth * evals, 0), "--eval_only", save_dir=kdir,
                    eval_only=True)
    launches = [a + b for a, b in zip(launches, got)]
    print(f"[8b det] --eval_only mAP@50 {out3['best_map50']!r}, det_best's "
          f"{best_map!r}")
    if out3["iters"] != 0 or out3["best_map50"] != best_map:
        raise SystemExit("--eval_only does not report the best checkpoint's "
                         "mAP@50")
    run((0, 0), "train 1 epoch (plain arm)", save_dir=os.path.join(
        tmp, "plain"), use_fused=False)

    # export the best checkpoint with the fused bf16 config and serve it
    best = segdet.load_checkpoint(os.path.join(kdir, "det_best.pt"))
    served = detector_from_state(cfg, ds.n_classes, best["trainable"],
                                 best["frozen"], device)
    art = os.path.join(tmp, "artifact")
    export_detector(art, served, cfg, strides, batch_sizes=(1, 8, 16))
    if keep is not None:
        keep["det"] = {"artifact": art, "img_dir": img_dir, "ann": ann,
                       "map50": best_map, "depth": depth}
    pred = load_predictor(art, device)
    x = np.stack([ds[i]["image"] for i in range(8)])
    for c in counters:
        c.launches = 0
    dets = [pred.detect(x[:1]), pred.detect(x)]
    _sync(device)
    got = tuple(c.launches for c in counters)
    launches = [a + b for a, b in zip(launches, got)]
    print(f"[8b det] served detect b1 and b8: {[len(d) for d in dets]} "
          f"images, {sum(len(d[0]) for d in dets[1])} boxes at b8; window "
          f"kernel launches {got} (expected ({2 * depth}, 0))")
    if got != (2 * depth, 0) or len(dets[1]) != 8 or not all(
            np.isfinite(d[0]).all() and np.isfinite(d[1]).all()
            for d in dets[0] + dets[1]):
        raise SystemExit("the served detector did not run the window kernel "
                         "in every block, or returned bad detections")
    raw = pred.predict(x)
    with torch.inference_mode():
        ref_maps = detector_forward(served, torch.from_numpy(x).to(device),
                                    cfg)
    dev_max = max(float(np.abs(a - b.float().cpu().numpy()).max()
                        / max(float(b.abs().max()), 1e-12))
                  for lvl, r_lvl in zip(raw, ref_maps)
                  for a, b in zip(lvl, r_lvl))
    print(f"[8b det] served raw maps vs the in-process forward: worst max|d| "
          f"/ max|ref| {dev_max:.3g} (bound {DET_SERVE_REL_TOL})")
    if dev_max > DET_SERVE_REL_TOL:
        raise SystemExit("the served maps differ from the in-process forward")
    # W8A8: the best checkpoint through the CLI with --quantize_frozen (f32
    # on the plain window attention, as export_det exports), served: the
    # int8 kernel in each qkv, fc1 and fc2 of every block of every call
    launches.append(_w8a8_served(
        "8b det", ["export_det", "--ckpt", os.path.join(kdir, "det_best.pt"),
                   "--img_size", str(r["img_size"]), "--embed_dim",
                   str(r["embed_dim"]), "--depths",
                   ",".join(map(str, r["depths"])), "--num_heads",
                   ",".join(map(str, r["num_heads"])), "--window_size",
                   str(r["window_size"])],
        os.path.join(tmp, "w8a8"), device, [x[:1], x],
        lambda p: DetPredictor(p.meta, quantize_frozen_backbone(
            detector_from_state(p.swin_cfg, ds.n_classes, best["trainable"],
                                best["frozen"], device)), p.swin_cfg,
            device),
        per_call=(3 * depth, 0))[0])
    cfg32 = segdet.swin_config(r["img_size"], r["embed_dim"], r["depths"],
                               r["num_heads"], r["window_size"], bf16=False,
                               use_fused=False)
    _tf32_readings(model, cfg32, batch, strides,
                   load_predictor(os.path.join(tmp, "w8a8"), device), x)

    rates = _det_rates(model, pred.model, batch, cfg, plain_cfg, strides)
    for (what, name), (rate, peak) in sorted(rates.items()):
        print(f"[8b det] {what} {name} arm: {rate:.1f} img/s"
              + (f", peak {peak:.2f} GB" if what == "train" else ""))
    step = make_detection_train_step(cfg, detection_optimizer(
        model, 1e-9, 1e-4), strides)
    _print_profile("8b det", f"kernel arm, b{bsz} train step",
                   *_profile_step(lambda: step(model, batch)))
    print(f"[8b det] phase took {time.perf_counter() - t0:.1f} s")
    return tuple(launches), rates


def _tf32_readings(model, cfg32, batch, strides, w8a8_pred, x):
    """The f32 detector with TF32 on (PyTorch's default for cuDNN's f32
    convolutions) against off (what the entry points set and every check
    runs): one f32 `segdet det` step's loss and gradients and the pyramid
    features (the plain windows, as the f32 CLI runs them), and the W8A8
    artifact served in f32, held against phase 8b's bounds.  A reading:
    it decides nothing but what PERF.md writes down."""
    from apla_tpu_torch.models.swin import swin_features
    from apla_tpu_torch.wrapper import set_float32_precision
    runs = {}
    try:
        for on in (False, True):
            set_float32_precision(on)
            step = _det_grads(model, cfg32, batch, strides)
            with torch.no_grad():
                feats = swin_features(model.backbone, batch["image"], cfg32)
            runs[on] = (step, feats, w8a8_pred.predict(x))
    finally:
        set_float32_precision()
    for p in model.parameters():
        p.grad = None
    (loss, grads), feats, served = runs[True]
    (r_loss, r_grads), r_feats, r_served = runs[False]
    rel = {n: (torch.linalg.vector_norm(grads[n] - r_grads[n])
               / torch.linalg.vector_norm(r_grads[n])).item()
           for n in r_grads}
    worst = max(rel, key=rel.get)
    cos = min(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()
        for a, b in zip(feats, r_feats))
    dev = _max_rel_dev(served, r_served)
    ok = (abs(loss - r_loss) <= DET_LOSS_REL_TOL * abs(r_loss)
          and rel[worst] <= DET_GRAD_REL_TOL and cos >= DET_MIN_COSINE
          and dev <= DET_SERVE_REL_TOL)
    print(f"[8b det] TF32 on vs off, f32 detector: step |dloss| / loss "
          f"{abs(loss - r_loss) / abs(r_loss):.6g} (bound "
          f"{DET_LOSS_REL_TOL}), worst per-tensor gradient ||dg||/||g|| "
          f"{rel[worst]:.6g} at {worst} (bound {DET_GRAD_REL_TOL}), pyramid "
          f"cosine {cos:.6f} (bound {DET_MIN_COSINE}); W8A8 served in f32 "
          f"max|d| / max|ref| {dev:.3g} (bound {DET_SERVE_REL_TOL}) -> "
          f"{'within' if ok else 'outside'} 8b's bounds; the entry points "
          f"and the checks run TF32 off")
    return ok


def _det_rates(model, served, batch, cfg, plain_cfg, strides):
    """Train-step img/s and peak device memory (AdamW at lr 1e-9, after a
    warm-up step) and the served forward's img/s at b8 and b16, of both
    arms in turns (plain, kernel, kernel, plain), best of two."""
    from apla_tpu_torch.models.detection import (detection_optimizer,
                                                 detector_forward,
                                                 make_detection_train_step)
    bsz = batch["image"].shape[0]
    rates = {}
    for name, c in (("plain", plain_cfg), ("kernel", cfg), ("kernel", cfg),
                    ("plain", plain_cfg)):
        step = make_detection_train_step(c, detection_optimizer(
            model, 1e-9, 1e-4), strides)
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: step(model, batch), iters=4, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        best = rates.get(("train", name), (0.0, 0.0))
        rates[("train", name)] = (max(best[0], bsz * 1000.0 / ms),
                                  max(best[1], peak))
        for b in (8, 16):
            xb = batch["image"][:b]
            with torch.inference_mode():
                ms = _time_ms(lambda: detector_forward(served, xb, c),
                              iters=10)
            key = (f"serve b{b}", name)
            rates[key] = (max(rates.get(key, (0.0,))[0], b * 1000.0 / ms),
                          0.0)
    return rates


def _trainables(model):
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _step_grads(model, cfg, images, labels, criterion, accum):
    """Loss and float32 gradients of one recipe step (accum micro-batches,
    averaged) on already augmented images; no update."""
    from apla_tpu_torch.models.classifier import classifier_forward
    params = _trainables(model)
    for p in params.values():
        p.grad = None
    mb = images.shape[0] // accum
    loss = 0.0
    for i in range(accum):
        sl = slice(i * mb, (i + 1) * mb)
        loss_i = criterion(classifier_forward(model, images[sl], cfg,
                                              deterministic=False),
                           labels[sl])
        loss_i.backward()
        loss = loss + float(loss_i.detach()) / accum
    return loss, {n: p.grad.detach().clone() / accum
                  for n, p in params.items()}


def _grad_agreement(tag, name, got, ref, loss_tol, grad_tol):
    """(|loss delta|, worst per-tensor ||g - g_ref|| / ||g_ref||, tensor)
    against `loss_tol` and `grad_tol`, printed; True when within both."""
    (loss, grads), (r_loss, r_grads) = got, ref
    rel = {n: (torch.linalg.vector_norm(grads[n] - r_grads[n])
               / torch.linalg.vector_norm(r_grads[n])).item()
           for n in r_grads}
    worst = max(rel, key=rel.get)
    ok = abs(loss - r_loss) <= loss_tol and rel[worst] <= grad_tol
    print(f"[{tag}] {name} vs plain arm: |dloss| {abs(loss - r_loss):.6g} "
          f"(bound {loss_tol}), worst per-tensor gradient "
          f"||dg||/||g|| {rel[worst]:.6g} at {worst} (bound {grad_tol})"
          f" -> {'within' if ok else 'outside'} the bounds")
    return ok


def _with_output_fault(module, name, fault, fn):
    """fn() with `fault` applied to the outputs of every call of the kernel
    wrapper `module.name`."""
    real = getattr(module, name)

    def faulty(*args, **kwargs):
        return fault(real(*args, **kwargs))

    # the wrapper counts its launches on the module's attribute, here the
    # stand-in: control launches are not the main path's
    faulty.launches = 0
    return _with_patch(module, name, faulty, fn)


def _train_step_fn(wrapper, cfg, accum, batch, run=None):
    """A zero-argument call of one recipe step of `cfg` at `accum` on a
    device batch (AdamW at lr 1e-9: a copy of the optimizer state moves;
    the model's weights move too)."""
    from apla_tpu_torch.train.optim import build_optimizer
    from apla_tpu_torch.train.steps import make_train_step
    from apla_tpu_torch.train.train_state import TrainState
    opt = build_optimizer("AdamW", {"lr": 1e-9, "weight_decay": 1e-5},
                          _trainables(wrapper.model).items(), grad_clip=1.0)
    step = make_train_step(cfg, opt, wrapper.criterion,
                           device_aug_cfg=wrapper.device_aug_cfg,
                           accum_steps=accum)
    state = TrainState(0, wrapper.model, opt)
    gen = torch.Generator(device=batch["image"].device).manual_seed(SEED)
    if run is not None:             # the step inside `run` (an arm's patch)
        return lambda: run(lambda: step(state, batch, 1e-9, gen))
    return lambda: step(state, batch, 1e-9, gen)


def _train_rate(wrapper, cfg, accum, batch, run=None):
    """Train-step img/s and peak device memory (GB) of `cfg` at `accum`
    on a device batch, after one warm-up step (inside `run`, if given)."""
    fn = _train_step_fn(wrapper, cfg, accum, batch, run)
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(fn, iters=4, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    return batch["image"].shape[0] * 1000.0 / ms, peak


def _run_params(recipe, cuts, save_dir, device):
    """The recipe with its cuts, saving under `save_dir`, on `device`, the
    index file found from the repository root."""
    from apla_tpu_torch.utils.config import update_nested_values
    params = update_nested_values(copy.deepcopy(recipe), copy.deepcopy(cuts))
    params["training_params"]["save_dir"] = save_dir
    params.setdefault("system_params", {})["device"] = str(device)
    apla = params["model_params"]["adaptation"]["params"]
    if apla.get("inds_path"):
        apla["inds_path"] = os.path.join(ROOT, apla["inds_path"])
    return params


def phase_train(device):
    from apla_tpu_torch.ops import fused_apla_attn as fa
    controls = {  # on the backward's (dqkv, dW_t)
        "dW_t zeroed": (fa, "fused_apla_attn_bwd",
                        lambda out: (out[0], out[1] * 0)),
        "dqkv halved": (fa, "fused_apla_attn_bwd",
                        lambda out: (out[0] * 0.5, out[1])),
    }
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        launches, rates, _ = _train_phase(
            device, tmp, RECIPE, SMOKE_CUTS, "5 train", "fused",
            (fa.fused_apla_attn_fwd, fa.fused_apla_attn_bwd), 0, controls,
            (LOSS_TOL, GRAD_REL_TOL))
    return launches, rates


def _train_phase(device, tmp, recipe, cuts, tag, arm, counters,
                 blocks_without_bwd, controls, tols, profile=False,
                 int8=None):
    """`recipe` with `cuts` through DefaultWrapper -> Trainer.train() ->
    test(), saving under `tmp`.  Checks: the first step's loss and
    gradients of the kernel arm (`arm`) against the plain arm (the kernels'
    paths off) within `tols` = (|dloss|, worst ||dg|| / ||g||), and each of
    `controls` (name -> (module, wrapper, fault on its outputs), or a
    function running a zero-argument call under its fault) outside them;
    the forward and backward kernels that `counters` count launched in
    every block of every micro-step and eval call (the backward in all but
    the first `blocks_without_bwd` blocks); finite losses; frozen weights
    bit for bit; every trainable tensor moved; the checkpoint reloads.
    `int8` (W8A8 training): (the int8 kernel's wrapper, a function running
    a call with the int8 product's plain version): the kernel in each
    frozen qkv, fc1 and fc2 of every micro-step and eval call, and the
    plain arm on the plain int8 product.  Then train-step img/s and peak
    memory of both arms at the recipe's accum and at 1, and (`profile`) a
    profile of the kernel arm's step at each.  Returns (launches, rates,
    profiles)."""
    from apla_tpu_torch.data.device_augs import device_augment
    from apla_tpu_torch.train.checkpoint import load_checkpoint
    from apla_tpu_torch.train.trainer import Trainer
    from apla_tpu_torch.wrapper import DefaultWrapper

    params = _run_params(recipe, cuts, tmp, device)
    t0 = time.perf_counter()
    wrapper = DefaultWrapper(params)
    wrapper.instantiate(seed=SEED)
    trainer = Trainer(wrapper)
    model, cfg = wrapper.model, wrapper.vit_cfg
    depth = cfg.depth
    accum = int(params["training_params"]["accum_steps"])
    steps = len(wrapper.dataloaders.trainloader)
    evals = len(wrapper.dataloaders.valloader) \
        + len(wrapper.dataloaders.testloader)
    print(f"[{tag}] wrapper instantiated on {wrapper.device} in "
          f"{time.perf_counter() - t0:.1f} s: {steps} steps of "
          f"{accum} x b{64 // accum}, {evals} eval batches; "
          f"{sum(p.numel() for p in _trainables(model).values()):,} "
          f"trainable in {len(_trainables(model))} tensors")

    # the kernel arm against the plain arm: first step's batch, one set of
    # augmentation draws, the same weights
    batch = next(iter(wrapper.dataloaders.trainloader))
    batch = {k: v.to(device) for k, v in batch.items()}
    images = device_augment(batch["image"], torch.Generator(
        device=device).manual_seed(SEED), wrapper.device_aug_cfg,
        compute_dtype=cfg.compute_dtype)
    plain_cfg = dataclasses.replace(cfg, use_fused_apla=False,
                                    use_flash=False)
    args = (images, batch["label"], wrapper.criterion, accum)
    plain_run = int8[1] if int8 else None
    ref = (plain_run or (lambda fn: fn()))(
        lambda: _step_grads(model, plain_cfg, *args))
    ok = _grad_agreement(tag, f"{arm} arm", _step_grads(model, cfg, *args),
                         ref, *tols)

    def faulty(control, fn):
        if callable(control):
            return control(fn)
        module, fn_name, fault = control
        return _with_output_fault(module, fn_name, fault, fn)
    caught = all([not _grad_agreement(
        tag, f"control: {name}", faulty(
            control, lambda: _step_grads(model, cfg, *args)),
        ref, *tols) for name, control in controls.items()])
    if not ok:
        raise SystemExit(f"{arm} arm's gradients disagree with the plain arm")
    if not caught:
        raise SystemExit("a broken backward kernel passes the gradient "
                         "bounds")
    for p in model.parameters():
        p.grad = None

    frozen = {n: t.detach().clone() for n, t in trainer.state.frozen().items()}
    trainable = {n: t.detach().clone()
                 for n, t in trainer.state.trainable().items()}
    counters = tuple(counters) + ((int8[0],) if int8 else ())
    for c in counters:
        c.launches = 0
    trainer.train()
    results = trainer.test()
    _sync(device)
    launches = tuple(c.launches for c in counters)
    bwd_blocks = depth - blocks_without_bwd
    expect = (depth * (steps * accum + evals), bwd_blocks * steps * accum)
    expect += (3 * expect[0],) if int8 else ()
    print(f"[{tag}] trained {trainer.iters} steps and tested in "
          f"{time.perf_counter() - t0:.1f} s; launches forward "
          f"{launches[0]} (expected {expect[0]} = {depth} x ({steps} x "
          f"{accum} micro-steps + {evals} eval calls)), backward "
          f"{launches[1]} (expected {expect[1]} = {bwd_blocks} x {steps} x "
          f"{accum})" + (f", int8 {launches[2]} (expected {expect[2]} = 3 x "
                         f"{expect[0]}: each frozen qkv, fc1, fc2)"
                         if int8 else ""))
    if launches != expect:
        raise SystemExit("the training path did not run both kernels in "
                         "every block of every micro-step")
    losses = [r["train_loss"] for _, r in trainer.history
              if "train_loss" in r]
    print(f"[{tag}] losses {losses}; test {dict(results)}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise SystemExit(f"missing or non-finite training losses {losses}")
    moved = {n: not torch.equal(trainable[n], t)
             for n, t in trainer.state.trainable().items()}
    kept = {n: torch.equal(frozen[n], t)
            for n, t in trainer.state.frozen().items()}
    print(f"[{tag}] {sum(moved.values())}/{len(moved)} trainable tensors "
          f"moved, {sum(kept.values())}/{len(kept)} frozen tensors "
          f"unchanged bit for bit")
    if not all(moved.values()) or not all(kept.values()):
        raise SystemExit(f"trainable not moved "
                         f"{[n for n, m in moved.items() if not m]}, frozen "
                         f"changed {[n for n, k in kept.items() if not k]}")
    after = {n: t.detach().clone()
             for n, t in trainer.state.trainable().items()}
    manifest, _ = load_checkpoint(trainer.checkpoint_path, trainer.state)
    reloaded = all(torch.equal(after[n], t)
                   for n, t in trainer.state.trainable().items())
    print(f"[{tag}] checkpoint {sorted(os.listdir(trainer.checkpoint_path))}"
          f" reloads at iter {manifest['iters']}: "
          f"{'same weights' if reloaded else 'DIFFERENT weights'}")
    if manifest["iters"] != trainer.iters or not reloaded:
        raise SystemExit("the checkpoint does not reload the trained state")

    # train-step throughput of both arms at the recipe's accum and at 1, in
    # turns (plain, kernel, kernel, plain), best of two
    rates = {}
    for name, a_cfg in (("plain", plain_cfg), (arm, cfg), (arm, cfg),
                        ("plain", plain_cfg)):
        for acc in (accum, 1):
            rate, peak = _train_rate(wrapper, a_cfg, acc, batch,
                                     plain_run if name == "plain" else None)
            best = rates.get((name, acc), (0.0, 0.0))
            rates[(name, acc)] = (max(best[0], rate), max(best[1], peak))
    for (name, acc), (rate, peak) in sorted(rates.items()):
        print(f"[{tag}] train step b{batch['image'].shape[0]} accum {acc} "
              f"{name} arm: {rate:.1f} img/s, peak {peak:.2f} GB")
    profiles = {}
    for acc in ((accum, 1) if profile else ()):
        profiles[acc] = _profile_step(_train_step_fn(wrapper, cfg, acc,
                                                     batch))
        _print_profile(tag, f"{arm} arm, accum {acc}", *profiles[acc])
    return launches, rates, profiles


def _proto_inputs(r, k, gen, device, collate=False):
    """Unit-norm bottleneck rows xs, xt [r, 256], column-normalised
    prototype layers ws, wt [256, k] (bf16, as the head hands them over), a
    center [k] and per-row cotangents g [r] (the iBOT masked-patch
    weights' scale); with `collate`, g is 0 past the rows the collate fills
    (PROTO_COLLATE)."""
    def unit(shape, dim):
        x = torch.randn(shape, generator=gen)
        return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)

    bf = torch.bfloat16
    g = torch.rand(r, generator=gen) / 64
    if collate:
        ratios = 0.1 + 0.4 * torch.rand(64, generator=gen)
        g[int((ratios * 256).long().sum()):] = 0
    return (unit((r, 256), -1).to(device, bf), unit((256, k), 0).to(device, bf),
            unit((r, 256), -1).to(device, bf), unit((256, k), 0).to(device, bf),
            (0.1 * torch.randn(k, generator=gen)).to(device), g.to(device))


def _proto_errors(got, ref):
    """{output: (max|err|, bound)}, per output, the bound a share of
    max|ref| (PROTO_FWD_REL_TOL for the forward's outputs)."""
    out = {}
    for name, a, r in zip(("ce", "lse_s", "lse_t", "dxs", "dws"), got, ref):
        ok = bool(torch.isfinite(a).all())
        err = (a.float() - r.float()).abs().max().item() if ok \
            else float("inf")
        tol = KERNEL_REL_TOL if name in ("dxs", "dws") else PROTO_FWD_REL_TOL
        out[name] = (err, tol * r.float().abs().max().item())
    return out


def _proto_all(pc, args, tt, lse_t=None, g=None):
    """(ce, lse_s, lse_t, dxs, dws) of the kernels (or, through `pc`'s
    references, the plain versions) on one input set; the backward takes
    the forward's lse unless `lse_t` replaces the teacher's, and the
    input's g unless `g` replaces it."""
    xs, ws, xt, wt, c, g0 = args
    fwd, dxs, dws = pc
    ce, ls, lt = fwd(xs, ws, xt, wt, c, tt, STUDENT_TEMP)
    bargs = (xs, ws, xt, wt, c, tt, STUDENT_TEMP, ls,
             lt if lse_t is None else lse_t, g0 if g is None else g)
    return ce, ls, lt, dxs(*bargs), dws(*bargs)


def _dropped_tile_g(args, tt, ref):
    """g with the 32-row tile zeroed that holds the live row contributing
    most to the largest dws value of `ref` (the plain outputs at tau_t =
    tt): the dws kernel then skips that tile's loads and products, as a
    kernel that lost a live tile would."""
    from apla_tpu_torch.ops import proto_ce as pc
    xs, ws, xt, wt, c, g = args
    d, k = divmod(int(ref[4].abs().argmax()), ref[4].shape[1])
    one = (xs, ws[:, k:k + 1], xt, wt[:, k:k + 1], c[k:k + 1])
    s, t = pc._logits(*one, tt, STUDENT_TEMP)
    ds = ((s[:, 0] - ref[1]).exp() - (t[:, 0] - ref[2]).exp()) \
        * g * (1.0 / STUDENT_TEMP)
    part = (xs[:, d].float() * ds.to(torch.bfloat16).float()).abs()
    row = int(torch.where(g != 0, part, torch.zeros_like(part)).argmax())
    out = g.clone()
    out[row // 32 * 32:row // 32 * 32 + 32] = 0
    return out, row // 32


def _proto_check(tag, kernels, plain, args, tt):
    got = _proto_all(kernels, args, tt)
    torch.cuda.synchronize()
    ref = _proto_all(plain, args, tt)
    errs = _proto_errors(got, ref)
    ok = all(e <= b for e, b in errs.values())
    print(f"[6a proto_ce] {tag} tau_t={tt}: " + ", ".join(
        f"{n} max|err| {e:.6g} (bound {b:.6g})"
        for n, (e, b) in errs.items()) + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"prototype-CE kernels disagree with their plain "
                         f"versions at {tag} tau_t={tt}")
    return got, ref, errs


def _proto_controls(kernels, args, tt, got, ref, collate):
    """Fault controls against the plain outputs `ref` at tau_t = tt: each
    changes an input or an output of the working kernels so that they
    compute what a broken kernel would; the bound must catch each."""
    if collate:
        g_drop, tile = _dropped_tile_g(args, tt, ref)
        controls = {f"products of live row tile {tile} dropped": (
            lambda: _proto_all(kernels, args, tt, g=g_drop), ("dws",))}
    else:
        huge = torch.full_like(ref[2], 1e30)       # exp(t - 1e30) = 0
        controls = {
            "tau_t taken as 1": (lambda: _proto_all(kernels, args, 1.0),
                                 ("ce", "dxs", "dws")),
            "dws zeroed": (lambda: got[:4] + (got[4] * 0,), ("dws",)),
            "dxs halved": (lambda: got[:3] + (got[3] * 0.5, got[4]),
                           ("dxs",)),
            "p_t dropped from ds (lse_t = 1e30)": (
                lambda: _proto_all(kernels, args, tt, lse_t=huge),
                ("dxs", "dws")),
        }
    for name, (fault, broken) in controls.items():
        c_errs = _proto_errors(fault(), ref)
        caught = all(c_errs[n][0] > c_errs[n][1] for n in broken)
        print(f"[6a proto_ce] control {name}: " + ", ".join(
            f"{n} {e:.6g}" for n, (e, _) in c_errs.items())
            + f" -> {'caught' if caught else 'NOT CAUGHT'} in "
            f"{list(broken)}")
        if not caught:
            raise SystemExit(f"the prototype-CE bound misses a broken "
                             f"kernel ({name})")


def _fwd_tile_control(args, tt):
    """The forward's outputs when one streamed tile of 32 prototype columns
    is left out of its statistics, against the plain outputs of all K: the
    kernel on ws, wt, c without that tile (the one holding the most of the
    rows' student softmax mass), as a kernel that skipped a tile would
    compute.  The bound must catch it in both log-sum-exps."""
    from apla_tpu_torch.ops import proto_ce as pc
    xs, ws, xt, wt, c, _ = args
    ref = pc.proto_ce_fwd_reference(xs, ws, xt, wt, c, tt, STUDENT_TEMP)
    s, _ = pc._logits(xs, ws, xt, wt, c, tt, STUDENT_TEMP)
    mass = torch.softmax(s, dim=-1).sum(dim=0)
    k = mass.shape[0]
    tile = int(torch.nn.functional.pad(mass, (0, -k % 32)).reshape(-1, 32)
               .sum(dim=1).argmax())
    keep = torch.ones(k, dtype=torch.bool, device=ws.device)
    keep[32 * tile:32 * tile + 32] = False
    got = pc.proto_ce_fwd(xs, ws[:, keep].contiguous(), xt,
                          wt[:, keep].contiguous(), c[keep], tt,
                          STUDENT_TEMP)
    errs = _proto_errors(got, ref)
    caught = all(errs[n][0] > errs[n][1] for n in ("lse_s", "lse_t"))
    print(f"[6a proto_ce] control forward tile {tile} (columns {32 * tile}"
          f"-{32 * tile + 31}) dropped, R={xs.shape[0]} K={k} tau_t={tt}: "
          + ", ".join(f"{n} {e:.6g} (bound {b:.6g})"
                      for n, (e, b) in errs.items())
          + f" -> {'caught' if caught else 'NOT CAUGHT'} in "
          f"['lse_s', 'lse_t']")
    if not caught:
        raise SystemExit("the prototype-CE forward bound misses a dropped "
                         "tile")


def _proto_library(xs, ws, xt, wt, c, tt):
    """The forward's function by PyTorch calls (not one call, and not the
    kernel's bits: the products are rounded to bf16): two bf16 matmuls,
    then logsumexp and the softmax-weighted sum in f32."""
    s = torch.matmul(xs, ws).float().mul_(1.0 / STUDENT_TEMP)
    t = torch.matmul(xt, wt).float().sub_(c).div_(tt)
    lse_s = torch.logsumexp(s, dim=-1)
    ce = lse_s - (torch.softmax(t, dim=-1) * s).sum(dim=-1)
    return ce, lse_s, torch.logsumexp(t, dim=-1)


def phase_proto_ce(device):
    from apla_tpu_torch.ops import proto_ce as pc
    kernels = (pc.proto_ce_fwd, pc.proto_ce_dxs, pc.proto_ce_dws)
    plain = (pc.proto_ce_fwd_reference, pc.proto_ce_dxs_reference,
             pc.proto_ce_dws_reference)
    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"fwd": 0.0, "dxs": 0.0, "dws": 0.0}
    cases = [((r, k), False) for r, k in PROTO_CASES] + [(PROTO_COLLATE,
                                                          True)]
    for (r, k), collate in cases:
        args = _proto_inputs(r, k, gen, device, collate)
        live = int((args[5] != 0).sum())
        tag = f"R={r} K={k}" + (f" (collate layout: {live} live rows)"
                                if collate else "")
        for tt in PROTO_TEMPS:
            got, ref, errs = _proto_check(tag, kernels, plain, args, tt)
            worst["fwd"] = max(worst["fwd"], *(errs[n][0] for n in
                                               ("ce", "lse_s", "lse_t")))
            worst["dxs"] = max(worst["dxs"], errs["dxs"][0])
            worst["dws"] = max(worst["dws"], errs["dws"][0])
        if (r, k) == PROTO_CASES[0]:
            # the fault controls at the iBOT site, against the reference
            # at the last tau_t (the dropped tile: at the collate's layout)
            _proto_controls(kernels, args, PROTO_TEMPS[-1], got, ref,
                            collate)
        del ref, got
        if (r, k) == PROTO_FWD_CONTROL and not collate:
            _fwd_tile_control(args, PROTO_TEMPS[-1])
    n_sm = _sm_count(device)
    for (r, k), _ in cases[:-1]:
        for plan in (pc.proto_fwd_plan(r, k, n_sm),
                     pc.proto_bwd_plan("dxs", r, k, n_sm),
                     pc.proto_bwd_plan("dws", r, k, n_sm)):
            print(f"[6a proto_ce] plan R={r} K={k}: {plan.describe()}")
    # times at the iBOT site, g > 0 on every row and at the collate's
    # layout: kernels (events over calls one by one, and a CUDA graph),
    # plain versions, bounds; each kernel with one and with two consumer
    # warpgroups a block (uncounted), the choice its plan makes; the
    # forward beside its multi-call yardstick
    r, k = PROTO_CASES[0]
    times = {}
    for collate in (False, True):
        xs, ws, xt, wt, c, g = _proto_inputs(r, k, gen, device, collate)
        tt = PROTO_TEMPS[0]
        _, ls, lt = pc.proto_ce_fwd(xs, ws, xt, wt, c, tt, STUDENT_TEMP)
        bargs = (xs, ws, xt, wt, c, tt, STUDENT_TEMP, ls, lt, g)
        live = int((g != 0).sum())
        rdk = r * 256 * k
        in_bytes = 2 * (2 * r * 256 + 2 * 256 * k) + 4 * k
        work = {"fwd": (4 * rdk, in_bytes + 3 * 4 * r),
                "dxs": (6 * rdk, in_bytes + 3 * 4 * r + 4 * r * 256),
                "dws": (6 * rdk, in_bytes + 3 * 4 * r + 4 * 256 * k)}
        if collate:
            # the work these inputs need: the rows with g != 0 (dxs writes
            # the others' zeros; the logits of the live rows alone)
            lk = live * 256 * k
            work = {"dxs": (6 * lk, in_bytes + 3 * 4 * r + 4 * r * 256),
                    "dws": (6 * lk, in_bytes + 3 * 4 * r + 4 * 256 * k)}
        calls = {"fwd": (lambda: pc.proto_ce_fwd(xs, ws, xt, wt, c, tt,
                                                 STUDENT_TEMP),
                         lambda: pc.proto_ce_fwd_reference(
                             xs, ws, xt, wt, c, tt, STUDENT_TEMP)),
                 "dxs": (lambda: pc.proto_ce_dxs(*bargs),
                         lambda: pc.proto_ce_dxs_reference(*bargs)),
                 "dws": (lambda: pc.proto_ce_dws(*bargs),
                         lambda: pc.proto_ce_dws_reference(*bargs))}
        for name, (kernel, ref_fn) in calls.items():
            if name not in work:
                continue
            t = {"ms": _time_ms(kernel, iters=10, warmup=2),
                 "graph_ms": _graph_ms(kernel, calls=5, iters=4)}
            t["bound_ms"], t["bound_by"] = _bound(*work[name])
            layout = "collate" if collate else "all rows live"
            msg = (f"[6a proto_ce] {name} R={r} D=256 K={k}, {layout} "
                   f"({live} live rows): kernel {t['ms']:.4f} ms (graph "
                   f"{t['graph_ms']:.4f}), bound {t['bound_ms']:.4f} ms "
                   f"({t['bound_by']}, {t['bound_ms'] / t['graph_ms']:.1%} "
                   f"of it reached)")
            if name != "fwd":
                for groups in (1, 2):
                    t[f"groups{groups}_ms"] = _time_ms(
                        lambda: pc.proto_ce_bwd_launch(name, *bargs,
                                                       groups=groups),
                        iters=5, warmup=1)
                plan = pc.proto_bwd_plan(name, r, k, n_sm)
                msg += (f"; one warpgroup a block {t['groups1_ms']:.4f} ms, "
                        f"two {t['groups2_ms']:.4f} ms, the plan takes "
                        f"{plan.groups}")
            else:
                # each block streams its split's ws and wt from L2: the
                # bytes over the time, the L2 -> SM rate each block shape
                # reached (the one-warpgroup blocks read twice the bytes)
                msg += "; "
                for groups in (1, 2):
                    ms = _graph_ms(lambda: pc.proto_ce_fwd_launch(
                        xs, ws, xt, wt, c, tt, STUDENT_TEMP, groups=groups),
                        calls=5, iters=4)
                    plan = pc.proto_fwd_plan(r, k, n_sm, groups)
                    l2 = plan.blocks_x * -(-k // 32) * 32 * 256 * 2 * 2
                    t[f"groups{groups}_graph_ms"] = ms
                    t[f"groups{groups}_l2_tb_s"] = l2 / ms / 1e9
                    msg += (f"{groups} warpgroup(s) a block: graph {ms:.4f}"
                            f" ms, {l2 / 1e9:.2f} GB from L2 at "
                            f"{l2 / ms / 1e9:.2f} TB/s; ")
                msg += (f"the plan takes "
                        f"{pc.proto_fwd_plan(r, k, n_sm).groups}")
            if collate:
                times[name]["collate"] = {key: t[key] for key in (
                    "ms", "graph_ms", "bound_ms", "groups1_ms",
                    "groups2_ms")}
                times[name]["collate"]["live_rows"] = live
            else:
                t["plain_ms"] = _time_ms(ref_fn, iters=3, warmup=1)
                t["max_abs_err"] = worst[name]
                msg += f"; plain {t['plain_ms']:.4f} ms"
                if name == "fwd":
                    def lib():
                        return _proto_library(xs, ws, xt, wt, c, tt)
                    t["library_calls_graph_ms"] = _graph_ms(lib, calls=2,
                                                            iters=3)
                    lib_err = max((a - b).abs().max().item() for a, b in
                                  zip(lib(), kernel()))
                    msg += (f"; PyTorch calls (two bf16 matmuls, logsumexp, "
                            f"softmax-weighted sum; not the same bits: "
                            f"max|diff| {lib_err:.3g}) graph "
                            f"{t['library_calls_graph_ms']:.4f} ms")
                times[name] = t
            print(msg)
        del xs, ws, xt, wt, c, g, ls, lt, bargs, calls
    return times


class _NoUpdate:
    """An optimizer stand-in that leaves the weights as they are: the step
    computes and keeps the gradients, and nothing moves."""

    def __init__(self, params):
        self.params = list(params)

    def set_lr(self, lr, wd=None):
        pass

    def step(self, g_norm):
        pass


def _ssl_step(wrapper, vit_cfg, fused_mode, optimizer, koleo=None):
    """A DINOv2 train step of the wrapper's recipe with `vit_cfg` and
    `fused_proto_ce` set to `fused_mode` (and the KoLeo weight to `koleo`
    if given), prototype layer not frozen, and a state of its own around
    the wrapper's model and teacher (the centers copied)."""
    from apla_tpu_torch.ssl.dinov2 import (DINOv2TrainState,
                                           make_dinov2_train_step)
    d2 = copy.deepcopy(wrapper.model_params.dinov2)
    d2["fused_proto_ce"] = fused_mode
    if koleo is not None:
        d2["dino"]["koleo_loss_weight"] = koleo
    cp = wrapper.crops_params
    step = make_dinov2_train_step(
        vit_cfg, optimizer, d2, cp.n_global_crops, cp.n_local_crops,
        freeze_last_layer=False,
        device_crop_cfgs=wrapper.ssl_device_crop_cfgs)
    s = wrapper.state
    state = DINOv2TrainState(step=0, model=s.model, optimizer=optimizer,
                             teacher=s.teacher,
                             dino_center=s.dino_center.clone(),
                             ibot_center=s.ibot_center.clone())
    return step, state


def _ssl_grads(wrapper, vit_cfg, fused_mode, batch):
    """Loss terms and f32 gradients of one step on `batch` (crops drawn
    from a fixed seed) without KoLeo (see SSL_GRAD_REL_TOL); momentum 1 and
    no update, so nothing moves."""
    params = _trainables(wrapper.model)
    step, state = _ssl_step(wrapper, vit_cfg, fused_mode,
                            _NoUpdate(params.values()), koleo=0.0)
    gen = torch.Generator(device=wrapper.device).manual_seed(SEED)
    _, m = step(state, batch, 0.0, 0.0, 1.0, PROTO_TEMPS[0], gen)
    losses = {k: float(m[k]) for k in SSL_AGREE_TERMS}
    grads = {n: p.grad.detach().float().clone() for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return losses, grads


def _ssl_agreement(name, got, ref):
    (losses, grads), (r_losses, r_grads) = got, ref
    d_loss = {k: abs(losses[k] - r_losses[k]) / max(abs(r_losses[k]), 1e-12)
              for k in SSL_AGREE_TERMS}
    rel = {n: (torch.linalg.vector_norm(grads[n] - r_grads[n])
               / torch.linalg.vector_norm(r_grads[n])).item()
           for n in r_grads}
    worst = max(rel, key=rel.get)
    ok = max(d_loss.values()) <= SSL_LOSS_REL_TOL \
        and rel[worst] <= SSL_GRAD_REL_TOL
    print(f"[6b ssl] {name} vs plain arm: |dloss|/|loss| " + ", ".join(
        f"{k} {v:.3g}" for k, v in d_loss.items())
        + f" (bound {SSL_LOSS_REL_TOL}); worst per-tensor ||dg||/||g|| "
        f"{rel[worst]:.6g} at {worst} (bound {SSL_GRAD_REL_TOL}); "
        f"dino_head.last_v {rel['dino_head.last_v']:.6g} -> "
        f"{'within' if ok else 'outside'} the bounds")
    return ok


def _ssl_rate(wrapper, vit_cfg, fused_mode, batch):
    """Train-step img/s and peak device memory (GB) of one arm (AdamW at
    lr 1e-9, momentum 1), after a warm-up step."""
    from apla_tpu_torch.train.optim import build_optimizer
    opt = build_optimizer("AdamW", {"lr": 1e-9, "weight_decay": 1e-5},
                          _trainables(wrapper.model).items(), grad_clip=3.0)
    step, state = _ssl_step(wrapper, vit_cfg, fused_mode, opt)
    gen = torch.Generator(device=wrapper.device).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(lambda: step(state, batch, 1e-9, 1e-5, 1.0,
                               PROTO_TEMPS[0], gen), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    return batch["raw_images"].shape[0] * 1000.0 / ms, peak, (step, state,
                                                              gen)


def _device_kernels(prof) -> dict:
    """name -> device microseconds summed over a profile's kernels."""
    out = {}
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if events:
        for e in events:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    else:
        for e in prof.events():
            for kern in e.kernels:
                out[kern.name] = out.get(kern.name, 0.0) + kern.duration
    return out


_KERNEL_GROUPS = (
    ("proto-CE kernels", ("proto_ce_", "sum_partials_kernel")),
    # gemm90::gemm_kernel<BN, A_MN, B_MN, F32_OUT>: <., 0, 1, false> is the
    # forwards' projection (fused APLA and Swin), the others the backward's
    # dO and dW_t GEMMs
    ("attention forward kernels (fused APLA, Swin, mha)",
     ("swin_row_kernel", "swin_two_pass_kernel", "mha_row_kernel",
      "mha_two_pass_kernel", "gemm_kernel<128, 0, 1,",
      "gemm_kernel<256, 0, 1,")),
    ("attention backward kernels (fused APLA, Swin, mha)",
     ("bwd_query_kernel", "bwd_key_kernel", "swin_bwd_", "dw_reduce_kernel",
      "gemm90::gemm_kernel")),
    ("gathers / index backward", ("index",)),
    ("int8 kernel (quantize pass + int8 wgmma GEMM)", ("w8a8_",)),
    ("GEMMs (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "ampere", "nvjet")),
    ("convolutions / resampling (heads, multi-crop blur)",
     ("conv", "upsample", "grid")),
    ("softmax / log-softmax / reductions", ("softmax", "reduce")),
    ("elementwise (adds, muls, casts, where)",
     ("elementwise", "vectorized", "unrolled")))


def _profile_step(fn, steps=2):
    """Wall and device-busy ms per call of fn() over `steps` profiled
    calls after one warm-up, device ms per kernel group, the top kernels
    and the top PyTorch ops by their own device ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _device_kernels(prof)
    busy = sum(kernels.values()) / 1e3 / steps
    groups = {}
    for name, us in kernels.items():
        low = name.lower()
        group = next((g for g, keys in _KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    ops = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])[:10]
    return wall, busy, groups, [(n, us / 1e3 / steps) for n, us in top], ops


def _print_profile(tag, what, wall, busy, groups, top, ops):
    print(f"[{tag}] profile, {what}: {wall:.2f} ms wall per step "
          f"(under the profiler), {busy:.2f} ms device busy, idle "
          f"{max(0.0, 1 - busy / wall):.1%}")
    print(f"[{tag}] profile by group (device ms per step): " + ", ".join(
        f"{g} {ms:.2f}" for g, ms in sorted(groups.items(),
                                            key=lambda kv: -kv[1])))
    for name, ms in top:
        print(f"[{tag}] profile top kernel {ms:8.3f} ms  {name[:100]}")
    print(f"[{tag}] profile top ops (own device ms per step): " + ", ".join(
        f"{name} {ms:.2f}" for name, ms in ops))


def phase_ssl(device, keep=None):
    """6b; with `keep` (phase 12's dict, `keep["dir"]` a directory that
    outlives the phase), its checkpoint stays for 12b: `keep["ssl_ckpt"]`."""
    if keep is not None:
        return _phase_ssl(device, _subdir(keep["dir"], "ssl"), keep)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssl_") as tmp:
        return _phase_ssl(device, tmp)


def _phase_ssl(device, tmp, keep=None):
    from apla_tpu_torch.ops import fused_apla_attn as fa
    from apla_tpu_torch.ops import proto_ce as pc
    from apla_tpu_torch.ssl.dinov2 import DINOv2Wrapper, Dinov2Trainer
    from apla_tpu_torch.train.checkpoint import load_aux_state, \
        load_checkpoint

    params = _run_params(SSL_RECIPE, SSL_CUTS, tmp, device)
    t0 = time.perf_counter()
    wrapper = DINOv2Wrapper(params)
    wrapper.instantiate(seed=SEED)
    trainer = Dinov2Trainer(wrapper)
    cfg, depth = wrapper.vit_cfg, wrapper.vit_cfg.depth
    loaders = wrapper.dataloaders
    steps = len(loaders.trainloader)
    embed_calls = 2 * len(loaders.fbank_loader) + len(loaders.valloader) \
        + len(loaders.testloader)
    cp = wrapper.crops_params
    print(f"[6b ssl] wrapper instantiated on {wrapper.device} in "
          f"{time.perf_counter() - t0:.1f} s: {steps} steps of b"
          f"{loaders.trainloader.batch_size}, {cp.n_global_crops} x "
          f"{cp.global_crops_size} + {cp.n_local_crops} x "
          f"{cp.local_crops_size} crops, {wrapper.n_prototypes} prototypes, "
          f"{embed_calls} kNN embed calls")

    # fused arm against plain arm on the first step's batch, same draws
    batch = next(iter(loaders.trainloader))
    batch = {k: v.to(device) for k, v in batch.items()
             if k not in ("label", "n_masked_patches")}
    print(f"[6b ssl] iBOT buffer: {batch['mask_indices_list'].shape[0]} rows"
          f", {int(batch['mask_valid'].sum())} of them masked patches")
    plain_cfg = dataclasses.replace(cfg, use_fused_apla=False,
                                    use_flash=False)
    mode = wrapper.model_params.dinov2.fused_proto_ce
    ref = _ssl_grads(wrapper, plain_cfg, False, batch)
    ok = _ssl_agreement("fused arm", _ssl_grads(wrapper, cfg, mode, batch),
                        ref)
    controls = {"proto-CE dws zeroed": ("proto_ce_dws", lambda d: d * 0),
                "proto-CE dxs halved": ("proto_ce_dxs", lambda d: d * 0.5)}
    caught = all([not _ssl_agreement(
        f"control: {name}", _with_output_fault(
            pc, which, fault, lambda: _ssl_grads(wrapper, cfg, mode, batch)),
        ref) for name, (which, fault) in controls.items()])
    if not ok:
        raise SystemExit("the SSL fused arm disagrees with the plain arm")
    if not caught:
        raise SystemExit("a broken prototype-CE backward passes the SSL "
                         "bounds")
    del ref

    state = trainer.state
    frozen = {n: t.detach().clone() for n, t in state.frozen().items()}
    trainable = {n: t.detach().clone() for n, t in state.trainable().items()}
    teacher = {n: t.clone() for n, t in state.teacher.items()}
    counters = (fa.fused_apla_attn_fwd, fa.fused_apla_attn_bwd,
                pc.proto_ce_fwd, pc.proto_ce_dxs, pc.proto_ce_dws)
    for c in counters:
        c.launches = 0
    trainer.train()
    results = trainer.test()
    _sync(device)
    launches = tuple(c.launches for c in counters)
    expect = (depth * (3 * steps + embed_calls), depth * 2 * steps,
              steps, steps, steps)
    print(f"[6b ssl] trained {trainer.iters} steps and tested in "
          f"{time.perf_counter() - t0:.1f} s; launches: fused forward "
          f"{launches[0]} (expected {expect[0]} = {depth} x (3 x {steps} "
          f"steps + {embed_calls} embed calls)), fused backward {launches[1]}"
          f" (expected {expect[1]}), proto_ce fwd/dxs/dws {launches[2:]} "
          f"(expected {expect[2:]})")
    if launches != expect:
        raise SystemExit("the SSL path did not run every kernel where it "
                         "should")
    records = [r for _, r in trainer.history if "train_loss" in r]
    print("[6b ssl] loss terms per step: " + "; ".join(
        ", ".join(f"{k} {r[k]:.5g}" for k in ("train_loss",)
                  + SSL_LOSS_TERMS) for r in records))
    print(f"[6b ssl] kNN test: {dict(results)}")
    if len(records) != steps or not all(
            np.isfinite([r[k] for k in ("train_loss",) + SSL_LOSS_TERMS]).all()
            for r in records):
        raise SystemExit("missing or non-finite SSL loss terms")
    kept = all(torch.equal(frozen[n], t) for n, t in state.frozen().items())
    moved = {n: not torch.equal(trainable[n], t)
             for n, t in state.trainable().items()}
    must_move = [n for n in moved if ".attn.proj_" in n
                 or n.startswith("dino_head.mlp.")]
    t_moved = sum(not torch.equal(teacher[n], t)
                  for n, t in state.teacher.items())
    centers = (float(state.dino_center.abs().max()),
               float(state.ibot_center.abs().max()))
    print(f"[6b ssl] frozen ({len(frozen)} tensors, mask_token among them) "
          f"{'unchanged bit for bit' if kept else 'CHANGED'}; "
          f"{sum(moved.values())}/{len(moved)} trainable tensors moved "
          f"({sum(moved[n] for n in must_move)}/{len(must_move)} APLA "
          f"columns and head MLP); {t_moved}/{len(teacher)} teacher tensors "
          f"moved; max |center| dino {centers[0]:.4g}, ibot {centers[1]:.4g}")
    if not kept or not all(moved[n] for n in must_move) or not t_moved \
            or min(centers) == 0.0:
        raise SystemExit("SSL training left the weights, the teacher or the "
                         "centers where they should not be")
    after = ({n: t.detach().clone() for n, t in state.trainable().items()},
             {n: t.clone() for n, t in state.teacher.items()},
             state.dino_center.clone(), state.ibot_center.clone())
    manifest, _ = load_checkpoint(trainer.checkpoint_path, state)
    state.load_aux(load_aux_state(trainer.checkpoint_path))
    reloaded = all(torch.equal(after[0][n], t)
                   for n, t in state.trainable().items()) \
        and all(torch.equal(after[1][n], t) for n, t in state.teacher.items()) \
        and torch.equal(after[2], state.dino_center) \
        and torch.equal(after[3], state.ibot_center)
    print(f"[6b ssl] checkpoint {sorted(os.listdir(trainer.checkpoint_path))}"
          f" reloads at iter {manifest['iters']}: "
          f"{'same weights, teacher and centers' if reloaded else 'DIFFERENT'}")
    if manifest["iters"] != trainer.iters or not reloaded:
        raise SystemExit("the SSL checkpoint does not reload the trained "
                         "state")
    if keep is not None:
        keep["ssl_ckpt"] = trainer.checkpoint_path

    # train-step img/s and peak memory, in turns (plain, fused, fused,
    # plain), best of two; then a profile of the fused arm's step
    rates = {}
    for name, arm, arm_mode in (("plain", plain_cfg, False),
                                ("fused", cfg, mode), ("fused", cfg, mode),
                                ("plain", plain_cfg, False)):
        rate, peak, last = _ssl_rate(wrapper, arm, arm_mode, batch)
        best = rates.get(name, (0.0, 0.0))
        rates[name] = (max(best[0], rate), max(best[1], peak))
        if name == "fused":
            fused_call = last
    for name, (rate, peak) in sorted(rates.items()):
        print(f"[6b ssl] train step b{batch['raw_images'].shape[0]} {name} "
              f"arm: {rate:.1f} img/s, peak {peak:.2f} GB")
    step, st, gen = fused_call
    _print_profile("6b ssl", "fused arm", *_profile_step(
        lambda: step(st, batch, 1e-9, 1e-5, 1.0, PROTO_TEMPS[0], gen)))
    return launches, rates


# --------------------------------------------------------------------------- #
# 11: BYOL, SimSiam and DINO v1
# --------------------------------------------------------------------------- #

def _v1_kernels(device):
    """Rows 1 and 2 at V1_KERNEL_SHAPE (DINO v1's local crops: 37 of a
    64-key tile live) against their plain versions, each output within
    KERNEL_REL_TOL of max|ref| and the rows of the tile's ragged end apart;
    timed beside the bound and the two-call yardstick.  Returns {"fwd":
    times, "bwd": times}."""
    from apla_tpu_torch.apla.core import load_indices
    from apla_tpu_torch.ops import mha as tmha
    from apla_tpu_torch.ops.fused_apla_attn import (
        fused_apla_attn_bwd, fused_apla_attn_bwd_reference,
        fused_apla_attn_fwd, fused_apla_attn_fwd_reference)
    gen = torch.Generator().manual_seed(SEED + 11)
    heads, scale = 12, 64 ** -0.5
    b, n, c3 = V1_KERNEL_SHAPE
    c = c3 // 3
    qkv = torch.randn(V1_KERNEL_SHAPE, generator=gen).to(device,
                                                         torch.bfloat16)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(device,
                                                            torch.bfloat16)
    g = torch.randn((b, n, c), generator=gen).to(device, torch.bfloat16)
    inds = torch.as_tensor(load_indices(os.path.join(ROOT, BYOL_RECIPE[
        "model_params"]["adaptation"]["params"]["inds_path"]), 12, c)[0],
        dtype=torch.int64).to(device)
    out = fused_apla_attn_fwd(qkv, w, heads, scale)
    _sync(device)
    ref = fused_apla_attn_fwd_reference(qkv, w, heads, scale)
    err = (out.float() - ref.float()).abs()
    bound = KERNEL_REL_TOL * ref.float().abs().max().item()
    tail = err[:, 32:].max().item()
    ok = bool(torch.isfinite(out).all()) and err.max().item() <= bound
    print(f"[11 kernels] fwd qkv {list(V1_KERNEL_SHAPE)} (plan "
          f"{tmha.fwd_plan(b, n, heads).describe()}): max|err| "
          f"{err.max().item():.6g}, rows 32-36 {tail:.6g}, bound "
          f"{bound:.6g} -> {'ok' if ok else 'FAIL'}")
    errs = _bwd_errors(fused_apla_attn_bwd(qkv, w, g, inds, heads, scale),
                       fused_apla_attn_bwd_reference(qkv, w, g, inds, heads,
                                                     scale))
    bwd_ok = all(e <= bd for e, bd in errs.values())
    print(f"[11 kernels] bwd k={len(inds)}: " + ", ".join(
        f"{name} max|err| {e:.6g} (bound {bd:.6g})"
        for name, (e, bd) in errs.items())
        + f" -> {'ok' if bwd_ok else 'FAIL'}")
    if not ok or not bwd_ok:
        raise SystemExit(f"rows 1, 2 disagree with their plain versions at "
                         f"{list(V1_KERNEL_SHAPE)}")
    fwd = _fused_fwd_times(qkv, w, heads, scale)
    fwd["max_abs_err"] = err.max().item()
    _print_fwd_times("11 kernels", b, n, c, fwd)
    bwd = _bwd_times("11 kernels", qkv, w, g, inds, heads, scale)
    bwd["max_abs_err"] = max(e for e, _ in errs.values())
    return {"fwd": fwd, "bwd": bwd}


def _v1_wrapper(objective, params):
    """(wrapper, trainer class) of `objective` on `params`."""
    from apla_tpu_torch.ssl.byol import BYOLTrainer, BYOLWrapper
    from apla_tpu_torch.ssl.dino import DINOTrainer, DINOWrapper
    if objective == "dino":
        return DINOWrapper(params), DINOTrainer
    return BYOLWrapper(params, use_momentum=objective == "byol"), BYOLTrainer


def _v1_state(wrapper, optimizer):
    """A state of its own around the wrapper's model: the teacher and the
    BN running stats or the center copied, so a measurement moves none of
    the trainer's."""
    from apla_tpu_torch.ssl.byol import SSLTrainState, _tree_map
    from apla_tpu_torch.ssl.dino import DINOTrainState
    s = wrapper.state
    teacher = {n: t.clone() for n, t in s.teacher.items()}
    if isinstance(s, DINOTrainState):
        return DINOTrainState(step=0, model=s.model, optimizer=optimizer,
                              teacher=teacher, center=s.center.clone())
    return SSLTrainState(step=0, model=s.model, optimizer=optimizer,
                         teacher=teacher,
                         model_state=_tree_map(torch.clone, s.model_state))


def _v1_step(wrapper, objective, cfg, optimizer):
    """A zero-argument call of one step of `objective` with `cfg` on a
    state of its own (`_v1_state`), at lr `lr`, momentum 1: run(images,
    lr) -> metrics; crops from a fixed seed."""
    from apla_tpu_torch.ssl.byol import make_byol_train_step
    from apla_tpu_torch.ssl.dino import make_dino_train_step
    state = _v1_state(wrapper, optimizer)
    crops = wrapper.ssl_device_crop_cfgs
    gen = torch.Generator(device=wrapper.device)
    if objective == "dino":
        step = make_dino_train_step(cfg, optimizer, 2, len(crops) - 2,
                                    device_crop_cfgs=crops)

        def run(images, lr):
            gen.manual_seed(SEED)
            return step(state, images, None, lr, 1e-5, 1.0,
                        float(wrapper.teacher_temp_schedule[0]), gen)[1]
    else:
        step = make_byol_train_step(cfg, optimizer, objective == "byol",
                                    device_crop_cfgs=crops)

        def run(images, lr):
            gen.manual_seed(SEED)
            return step(state, images, lr, 1.0, gen)[1]
    return run


def _v1_grads(wrapper, objective, cfg, images, pinned=None):
    """One step on `images` (no update) -> {"loss", "grads": f32 gradients
    of the trainables, "embs": the cls embeddings of every backbone call
    in order, "cots": the cotangent the heads send into each call made
    with gradients}.  With `pinned` (another run's "cots") those calls
    take that cotangent in place of their own."""
    from apla_tpu_torch.ssl import byol, dino
    module = dino if objective == "dino" else byol
    real = module.vit_features
    embs, cots = [], []

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        embs.append(out.detach().float().clone())
        if out.requires_grad:
            i = len(cots)
            cots.append(None)

            def hook(g):
                cots[i] = g.detach().clone()
                return None if pinned is None else pinned[i].to(g.dtype)

            out.register_hook(hook)
        return out

    params = _trainables(wrapper.model)
    m = _with_patch(module, "vit_features", recorded, lambda: _v1_step(
        wrapper, objective, cfg, _NoUpdate(params.values()))(images, 0.0))
    grads = {n: p.grad.detach().float().clone() for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return {"loss": float(m["loss"]), "grads": grads, "embs": embs,
            "cots": cots}


def _v1_rel(a, b) -> float:
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def _v1_agreement(tag, objective, name, got, ref):
    """`got` against the plain arm's `ref` (`_v1_grads`) within V1_TOLS:
    |dloss|, the worst ||de||/||e|| over the backbone's calls and the
    worst per-tensor ||dg||/||g|| over the backbone's trainables; the
    heads' tensors printed, not held."""
    loss_tol, emb_tol, grad_tol = V1_TOLS[objective]
    d_loss = abs(got["loss"] - ref["loss"])
    embs = [_v1_rel(e, r) for e, r in zip(got["embs"], ref["embs"])]
    grads = {n: _v1_rel(got["grads"][n], r) for n, r in ref["grads"].items()
             if torch.linalg.vector_norm(r) > 0}
    backbone = {n: v for n, v in grads.items() if n.startswith("backbone.")}
    heads = {n: v for n, v in grads.items() if n not in backbone}
    worst = max(backbone, key=backbone.get)
    ok = d_loss <= loss_tol and max(embs) <= emb_tol \
        and backbone[worst] <= grad_tol
    print(f"[{tag}] {name} vs plain arm: loss {got['loss']:.6g}, |dloss| "
          f"{d_loss:.6g} (bound {loss_tol}); ||de||/||e|| per backbone call "
          + " ".join(f"{e:.4g}" for e in embs) + f" (bound {emb_tol}); "
          f"worst backbone ||dg||/||g|| {backbone[worst]:.6g} at {worst} "
          f"(bound {grad_tol}; median "
          f"{float(np.median(list(backbone.values()))):.4g}); heads, not "
          f"held: worst {max(heads.values()):.4g} at "
          f"{max(heads, key=heads.get)} -> "
          f"{'within' if ok else 'outside'} the bounds")
    return ok


def _with_target_fwd_halved(fn):
    """fn() with the fused forward's output halved in every call made
    without gradients: the target branch (BYOL, SimSiam) or the teacher
    (DINO)."""
    from apla_tpu_torch.ops import attention
    real = attention.fused_apla_attention

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        return out if torch.is_grad_enabled() else out * 0.5

    return _with_patch(attention, "fused_apla_attention", faulty, fn)


def _with_bwd_fault(tokens, fault, fn):
    """fn() with `fault` on the fused backward's outputs in the calls at
    `tokens` tokens (every call where `tokens` is None)."""
    from apla_tpu_torch.ops import fused_apla_attn as fa
    real = fa.fused_apla_attn_bwd

    def faulty(qkv, *args, **kwargs):
        out = real(qkv, *args, **kwargs)
        return fault(out) if tokens in (None, qkv.shape[1]) else out

    faulty.launches = 0       # control launches are not the main path's
    return _with_patch(fa, "fused_apla_attn_bwd", faulty, fn)


def _v1_controls(wrapper, objective):
    """name -> fn -> fn() with a fault the bounds must catch."""
    controls = {("teacher" if objective == "dino" else "target")
                + " branch's forward halved": _with_target_fwd_halved}
    if objective == "dino":
        local = wrapper.ssl_device_crop_cfgs[-1].out_size
        n_local = (local // wrapper.vit_cfg.patch_size) ** 2 + 1
        controls["local-crop backward zeroed"] = functools.partial(
            _with_bwd_fault, n_local, lambda out: (out[0] * 0, out[1] * 0))
    else:
        controls["dW_t zeroed"] = functools.partial(
            _with_bwd_fault, None, lambda out: (out[0], out[1] * 0))
    controls["dW_t scaled by 0.95"] = functools.partial(
        _with_bwd_fault, None, lambda out: (out[0], out[1] * 0.95))
    return controls


def _v1_readings(tag, wrapper, objective, cfg, plain_cfg, images):
    """The kernel arm and each control against the plain arm on `images`,
    the heads' cotangent pinned to the plain arm's -> (kernel arm within
    the bounds, every control outside them)."""
    ref = _v1_grads(wrapper, objective, plain_cfg, images)
    free = _v1_grads(wrapper, objective, cfg, images)
    print(f"[{tag}] kernel arm under its own heads' cotangent (not held): "
          f"||dc||/||c|| per call " + " ".join(
              f"{_v1_rel(c, r):.4g}" for c, r in zip(free["cots"],
                                                     ref["cots"]))
          + ", worst backbone ||dg||/||g|| " + format(max(
              _v1_rel(free["grads"][n], r) for n, r in ref["grads"].items()
              if n.startswith("backbone.")), ".4g"))

    def kernel_arm():
        return _v1_grads(wrapper, objective, cfg, images, ref["cots"])

    ok = _v1_agreement(tag, objective, "kernel arm", kernel_arm(), ref)
    caught = all([not _v1_agreement(
        tag, objective, f"control: {name}", control(kernel_arm), ref)
        for name, control in _v1_controls(wrapper, objective).items()])
    return ok, caught


def _v1_rate(wrapper, objective, cfg, images):
    """Train-step img/s and peak device memory (GB) of one arm (AdamW at
    lr 1e-9, clip 3.0, momentum 1) after a warm-up step, and the call."""
    from apla_tpu_torch.train.optim import build_optimizer
    opt = build_optimizer("AdamW", {"lr": 1e-9, "weight_decay": 1e-5},
                          _trainables(wrapper.model).items(), grad_clip=3.0)
    run = _v1_step(wrapper, objective, cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(lambda: run(images, 1e-9), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    return images.shape[0] * 1000.0 / ms, peak, lambda: run(images, 1e-9)


def _v1_aux(state) -> dict:
    """name -> copy of the teacher and the BN running stats or center."""
    return {n: t.detach().clone() for n, t in state.aux().items()}


def _v1_objective(device, tmp, objective):
    """`objective` on BYOL_RECIPE / DINO_RECIPE with V1_CUTS through its
    wrapper -> trainer.train() -> test(checkpoint).  Returns (launches,
    rates)."""
    from apla_tpu_torch.ops import fused_apla_attn as fa
    tag = f"11 {objective}"
    recipe = DINO_RECIPE if objective == "dino" else BYOL_RECIPE
    params = _run_params(recipe, V1_CUTS, os.path.join(tmp, objective),
                         device)
    t0 = time.perf_counter()
    wrapper, trainer_cls = _v1_wrapper(objective, params)
    wrapper.instantiate(seed=SEED)
    trainer = trainer_cls(wrapper)
    cfg, depth = wrapper.vit_cfg, wrapper.vit_cfg.depth
    loaders = wrapper.dataloaders
    steps = len(loaders.trainloader)
    embed_calls = 2 * len(loaders.fbank_loader) + len(loaders.valloader) \
        + len(loaders.testloader)
    crops = [c.out_size for c in wrapper.ssl_device_crop_cfgs]
    print(f"[{tag}] wrapper instantiated on {wrapper.device} in "
          f"{time.perf_counter() - t0:.1f} s: {steps} steps of b"
          f"{loaders.trainloader.batch_size}, crops {crops}, "
          f"{sum(p.numel() for p in _trainables(wrapper.model).values()):,}"
          f" trainable in {len(_trainables(wrapper.model))} tensors, "
          f"{embed_calls} kNN embed calls")

    # kernel arm against plain arm on the first step's batch, same crops
    images = next(iter(loaders.trainloader))["image"].to(device)
    plain_cfg = dataclasses.replace(cfg, use_fused_apla=False,
                                    use_flash=False)
    ok, caught = _v1_readings(tag, wrapper, objective, cfg, plain_cfg,
                              images)
    if not ok:
        raise SystemExit(f"{objective}: the kernel arm disagrees with the "
                         "plain arm")
    if not caught:
        raise SystemExit(f"{objective}: a fault passes the bounds")

    state = trainer.state
    frozen = {n: t.detach().clone() for n, t in state.frozen().items()}
    trainable = {n: t.detach().clone() for n, t in state.trainable().items()}
    aux = _v1_aux(state)
    counters = (fa.fused_apla_attn_fwd, fa.fused_apla_attn_bwd)
    for c in counters:
        c.launches = 0
    trainer.train()
    after = ({n: t.detach().clone() for n, t in state.trainable().items()},
             _v1_aux(state))
    # the checkpoint through the --test path, on a state moved away first
    with torch.no_grad():
        for t in list(state.trainable().values()) + list(state.aux().values()):
            t.add_(1.0)
    results = trainer.test(chpt_path=trainer.checkpoint_path)
    _sync(device)
    launches = tuple(c.launches for c in counters)
    fwd_per_step = 3 if objective == "dino" else 4
    expect = (depth * (fwd_per_step * steps + embed_calls),
              depth * 2 * steps)
    print(f"[{tag}] trained {trainer.iters} steps and tested in "
          f"{time.perf_counter() - t0:.1f} s; launches: fused forward "
          f"{launches[0]} (expected {expect[0]} = {depth} x ({fwd_per_step}"
          f" x {steps} steps + {embed_calls} embed calls)), fused backward "
          f"{launches[1]} (expected {expect[1]} = {depth} x 2 x {steps})")
    if launches != expect:
        raise SystemExit(f"{objective}: the path did not run both kernels "
                         "in every block of every call")
    records = [r for _, r in trainer.history if "train_loss" in r]
    losses = [r["train_loss"] for r in records]
    print(f"[{tag}] losses {losses}; kNN test {dict(results)}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise SystemExit(f"{objective}: missing or non-finite losses")
    kept = all(torch.equal(frozen[n], t) for n, t in state.frozen().items())
    moved = {n: not torch.equal(trainable[n], t)
             for n, t in after[0].items()}
    must_move = [n for n in moved if ".attn.proj_" in n
                 or n.endswith("kernel")]
    teacher = [n for n in aux if n.startswith("teacher.")
               and not n.endswith("last_g")]
    stats = [n for n in aux if not n.startswith("teacher.")]
    t_moved = sum(not torch.equal(aux[n], after[1][n]) for n in teacher)
    s_moved = sum(not torch.equal(aux[n], after[1][n]) for n in stats)
    print(f"[{tag}] frozen ({len(frozen)} tensors) "
          f"{'unchanged bit for bit' if kept else 'CHANGED'}; "
          f"{sum(moved.values())}/{len(moved)} trainable tensors moved "
          f"({sum(moved[n] for n in must_move)}/{len(must_move)} APLA "
          f"columns and head kernels); {t_moved}/{len(teacher)} teacher "
          f"tensors moved; {s_moved}/{len(stats)} "
          f"{'center' if objective == 'dino' else 'BN running stats'} moved")
    if not kept or not all(moved[n] for n in must_move) \
            or (t_moved > 0) != (objective != "simsiam") \
            or s_moved != len(stats):
        raise SystemExit(f"{objective}: training left the weights, the "
                         "teacher or the running state where they should "
                         "not be")
    reloaded = all(torch.equal(after[0][n], t)
                   for n, t in state.trainable().items()) \
        and all(torch.equal(after[1][n], t) for n, t in state.aux().items())
    print(f"[{tag}] checkpoint {sorted(os.listdir(trainer.checkpoint_path))}"
          f" reloaded by test(): "
          f"{'same trainables, teacher and ' if reloaded else 'DIFFERENT '}"
          f"{'center' if objective == 'dino' else 'BN running stats'}")
    if not reloaded or not 0.0 <= results["knn_test_accuracy"] <= 1.0:
        raise SystemExit(f"{objective}: the checkpoint does not reload the "
                         "trained state, or no kNN table")

    # train-step img/s and peak memory in turns (plain, kernel, kernel,
    # plain), best of two; a profile of DINO's kernel arm
    rates = {}
    for name, arm in (("plain", plain_cfg), ("kernel", cfg),
                      ("kernel", cfg), ("plain", plain_cfg)):
        rate, peak, call = _v1_rate(wrapper, objective, arm, images)
        best = rates.get(name, (0.0, 0.0))
        rates[name] = (max(best[0], rate), max(best[1], peak))
        if name == "kernel":
            kernel_call = call
    for name, (rate, peak) in sorted(rates.items()):
        print(f"[{tag}] train step b{images.shape[0]} {name} arm: "
              f"{rate:.1f} img/s, peak {peak:.2f} GB")
    if objective == "dino":
        _print_profile(tag, "kernel arm", *_profile_step(kernel_call))
    return launches, rates


def phase_ssl_v1(device):
    """11: rows 1, 2 at DINO v1's local-crop shape, then BYOL, SimSiam and
    DINO v1 in turn.  Returns (kernel times, {objective: launches},
    {objective: rates})."""
    kernels = _v1_kernels(device)
    launches, rates = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssl_v1_") as tmp:
        for objective in V1_OBJECTIVES:
            launches[objective], rates[objective] = _v1_objective(
                device, tmp, objective)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return kernels, launches, rates


def phase_seg_kernels(device):
    """9a: the fused APLA kernels (rows 1, 2; TPU rows 5-7's shape) against
    their plain versions at SEG_KERNEL_CASES with every column trainable,
    the forward and backward fault controls at b8, shared memory,
    registers and the forward's launch plans at C = 1024, and times at b8
    beside the bounds and the two-call yardstick."""
    from apla_tpu_torch.ops import apla_proj_gemm as pg
    from apla_tpu_torch.ops import cuda_build
    from apla_tpu_torch.ops import fused_apla_attn as fa
    from apla_tpu_torch.ops import mha as tmha
    gen = torch.Generator().manual_seed(SEED + 5)
    heads, scale = SEG_HEADS, 64 ** -0.5
    worst = {"fwd": 0.0, "bwd": 0.0}
    for b, n, c in SEG_KERNEL_CASES:
        qkv = torch.randn((b, n, 3 * c), generator=gen).to(device,
                                                           torch.bfloat16)
        w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(
            device, torch.bfloat16)
        g = torch.randn((b, n, c), generator=gen).to(device, torch.bfloat16)
        inds = torch.arange(c, device=device)
        out = fa.fused_apla_attn_fwd(qkv, w, heads, scale)
        got = fa.fused_apla_attn_bwd(qkv, w, g, inds, heads, scale)
        torch.cuda.synchronize()
        ref_out = fa.fused_apla_attn_fwd_reference(qkv, w, heads, scale)
        ref = fa.fused_apla_attn_bwd_reference(qkv, w, g, inds, heads,
                                               scale)
        f_bound = KERNEL_REL_TOL * ref_out.float().abs().max().item()
        errs = {"out": ((out.float() - ref_out.float()).abs().max().item()
                        if torch.isfinite(out).all() else float("inf"),
                        f_bound), **_bwd_errors(got, ref)}
        ok = all(e <= bd for e, bd in errs.values())
        print(f"[9a seg_kernels] qkv [{b}, {n}, {3 * c}] k={c}: " + ", ".join(
            f"{k} max|err| {e:.6g} (bound {bd:.6g})"
            for k, (e, bd) in errs.items()) + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the fused APLA kernels disagree with their "
                             f"plain versions at [{b}, {n}, {3 * c}]")
        worst["fwd"] = max(worst["fwd"], errs["out"][0])
        worst["bwd"] = max(worst["bwd"], *(errs[k][0] for k in
                                           ("dq", "dk", "dv", "dW_t")))
        if b != SEG_KERNEL_CASES[0][0]:
            continue
        for name, fault in _faults().items():
            f_qkv, f, f_scale = fault(qkv, scale)
            e = (fa.fused_apla_attn_fwd(f_qkv, w * f, heads, f_scale).float()
                 - ref_out.float()).abs().max().item()
            print(f"[9a seg_kernels] forward control {name}: max|err| "
                  f"{e:.6g} bound {f_bound:.6g} -> "
                  f"{'caught' if e > f_bound else 'NOT CAUGHT'}")
            if e <= f_bound:
                raise SystemExit(f"the forward bound misses a broken kernel "
                                 f"({name}) at the seg shape")
        # the ragged tail: N = 1025 leaves one query row in the last tile,
        # a fault the step check of phase 9b cannot see
        e = (out.index_fill(1, torch.tensor([n - 1], device=device), 0)
             .float() - ref_out.float()).abs().max().item()
        print(f"[9a seg_kernels] output control last (ragged) query row "
              f"unwritten: max|err| {e:.6g} bound {f_bound:.6g} -> "
              f"{'caught' if e > f_bound else 'NOT CAUGHT'}")
        if e <= f_bound:
            raise SystemExit("the forward bound misses an unwritten tail row "
                             "at the seg shape")
        for name, (change, broken, intact) in _bwd_controls().items():
            f_qkv, f_w, f_inds, f_scale = change(qkv, w, inds, scale)
            c_errs = _bwd_errors(fa.fused_apla_attn_bwd(
                f_qkv, f_w, g, f_inds, heads, f_scale), ref)
            caught = all(c_errs[k][0] > c_errs[k][1] for k in broken)
            specific = all(c_errs[k][0] <= c_errs[k][1] for k in intact)
            print(f"[9a seg_kernels] backward control {name}: " + ", ".join(
                f"{k} {e:.6g}" for k, (e, _) in c_errs.items())
                + f" -> {'caught' if caught else 'NOT CAUGHT'} in "
                f"{list(broken)}")
            if not caught or not specific:
                raise SystemExit(f"backward control {name} at the seg shape: "
                                 f"caught {caught}, specific {specific}")
        # what the kernels take at C = 1024: dynamic shared memory per block
        # against the device's opt-in limit, registers and spills, and the
        # forward's launch plans (the attention kernel's, the GEMM's)
        dev = device.index or 0
        limit = cuda_build.device_smem(fa._bwd_library,
                                       "fused_apla_attn_bwd_prepare", dev)
        attn, do_gemm, dw_gemm = fa.bwd_plans(b, n, c, heads, c)
        chunks = fa.dw_chunks(b * n, c, c, _sm_count(device))[1]
        print(f"[9a seg_kernels] shared memory per block: forward "
              f"{tmha.fwd_plan(b, n, heads).smem_bytes} bytes (attention) "
              f"and {pg.gemm_plan(b * n, c).smem_bytes} (GEMM) at C={c}, "
              f"backward {attn.q_smem} (query side), {attn.k_smem} (key "
              f"side), {do_gemm.smem_bytes} (dO GEMM), "
              f"{dw_gemm.smem_bytes} (dW GEMM) bytes; the device allows "
              f"{limit} bytes per block; backward plans: attention "
              f"{attn.describe()}; dO GEMM {do_gemm.describe()}; dW GEMM "
              f"{dw_gemm.describe()}, for each of {chunks} chunks of rows")
        for src, kernel in ((tmha.FWD_SOURCE, "mha_two_pass_kernel"),
                            (pg.SOURCE, "gemm_kernel"),
                            (fa._BWD_SOURCE, "")):
            for line in _resources(cuda_build.resource_report(src)):
                if line.startswith(kernel):
                    print(f"[9a seg_kernels]   {src}: {line}")
        for bb in (b, 1):
            print(f"[9a seg_kernels] forward launch plans at b{bb}: "
                  f"attention {tmha.fwd_plan(bb, n, heads).describe()}; "
                  f"GEMM {pg.gemm_plan(bb * n, c).describe()}")
        # times at b8: the forward as phase 2 times it; the backward, its
        # plain version and autograd through the two-call yardstick
        times = {"fwd": _fused_fwd_times(qkv, w, heads, scale)}
        _print_fwd_times("9a seg_kernels", b, n, c, times["fwd"])
        lq, lw = qkv.clone().requires_grad_(), w.clone().requires_grad_()
        lout = _library_attn(lq, lw, heads, scale)
        kernel = lambda: fa.fused_apla_attn_bwd(  # noqa: E731
            qkv, w, g, inds, heads, scale)
        t = {"ms": _time_ms(kernel), "graph_ms": _graph_ms(kernel),
             "plain_ms": _time_ms(lambda: fa.fused_apla_attn_bwd_reference(
                 qkv, w, g, inds, heads, scale), iters=5),
             "library_two_calls_ms": _time_ms(lambda: torch.autograd.grad(
                 lout, (lq, lw), g, retain_graph=True), iters=10)}
        t["bound_ms"], t["bound_by"] = _attn_bwd_bound(b, n, c, c)
        t["parts"] = _bwd_parts(
            lambda bits: fa.fused_apla_attn_bwd_part(qkv, w, g, inds, heads,
                                                     scale, bits),
            _bwd_launch_bounds(b, n, c, c))
        times["bwd"] = t
        print(f"[9a seg_kernels] bwd b{b} [{b}, {n}, {3 * c}] k={c}: "
              f"kernel {t['ms']:.4f} ms ({t['graph_ms']:.4f} from a CUDA "
              f"graph), plain {t['plain_ms']:.4f} ms, two library calls "
              f"(SDPA + matmul, autograd) {t['library_two_calls_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{t['bound_ms'] / t['graph_ms']:.1%} of it reached)")
        _print_parts("9a seg_kernels", t["parts"])
        del lq, lw, lout
    for name in ("fwd", "bwd"):
        times[name]["max_abs_err"] = worst[name]
    return times


def _write_ade(root):
    """The synthetic ADE20K-layout set of phase 9b under `root`: SEG_TRAIN
    training and SEG_VAL validation images, 512 x 683, 683 x 512 or (every
    fourth) 512 x 512, of dark noise with 2-9 filled rectangles, each one
    class of 150 in one colour; annotations hold the raw ids (1..150 in the
    rectangles, 0 (unlabelled) around them, a 255 strip in some).  The
    images are PNG streams under ADE20K's `.jpg` names (the reader decodes
    by content, as Pillow does; JPEG decoding is not ported)."""
    from apla_tpu_torch.data.detection_data import write_png
    rng = np.random.default_rng(SEED)
    colours = rng.integers(64, 256, (151, 3))
    for split, count in (("training", SEG_TRAIN), ("validation", SEG_VAL)):
        img_dir = os.path.join(root, "images", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        for i in range(count):
            h, w = ((512, 512) if i % 4 == 3 else
                    (512, 683) if i % 2 == 0 else (683, 512))
            img = rng.integers(0, 48, (h, w, 3)).astype(np.uint8)
            ann = np.zeros((h, w), np.uint8)
            for _ in range(int(rng.integers(2, 10))):
                cls = int(rng.integers(1, 151))
                bh, bw = int(rng.integers(32, h // 2)), int(rng.integers(
                    32, w // 2))
                y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(
                    0, w - bw))
                img[y0:y0 + bh, x0:x0 + bw] = colours[cls]
                ann[y0:y0 + bh, x0:x0 + bw] = cls
            if i % 3 == 0:
                ann[:, :8] = 255
            write_png(os.path.join(img_dir, f"ADE_{split}_{i:08d}.jpg"), img)
            write_png(os.path.join(ann_dir, f"ADE_{split}_{i:08d}.png"), ann)


def phase_seg(device, keep=None):
    """9b; with `keep` (as phase 6b's), its artifact, data and
    `--eval_only` mIoU (plain and sliding) stay for phase 12d:
    `keep["seg"]`."""
    if keep is not None:
        return _phase_seg(device, _subdir(keep["dir"], "seg"), keep)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_") as tmp:
        return _phase_seg(device, tmp)


def _seg_grads(model, cfg, batch):
    """Loss and f32 gradients of one segmentation step (no update): the
    main and aux losses as `make_seg_train_step` sums them."""
    from apla_tpu_torch.models.seg import (segmentation_loss,
                                           segmenter_forward_train)
    params = _trainables(model)
    for p in params.values():
        p.grad = None
    main, aux = segmenter_forward_train(model, batch["image"], cfg)
    loss = segmentation_loss(main, batch["label"])
    for a in aux:
        loss = loss + 0.4 * segmentation_loss(a, batch["label"])
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in params.items()}


def _seg_rates(model, batch, cfg, plain_cfg, head_lr_mult):
    """Train-step img/s and peak device memory (AdamW at lr 1e-9, after a
    warm-up step) and the served forward's img/s at b1 and b8, of both arms
    in turns (plain, kernel, kernel, plain), best of two."""
    from apla_tpu_torch.models.seg import (make_seg_train_step,
                                           seg_optimizer, segmenter_forward)
    bsz = batch["image"].shape[0]
    rates = {}
    for name, c in (("plain", plain_cfg), ("kernel", cfg), ("kernel", cfg),
                    ("plain", plain_cfg)):
        step = make_seg_train_step(c, seg_optimizer(model, 1e-9, 1e-4,
                                                    head_lr_mult))
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: step(model, batch), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        old = rates.get(("train", name), (0.0, 0.0))
        rates[("train", name)] = (max(old[0], bsz * 1000.0 / ms),
                                  max(old[1], peak))
        for b in (1, 8):
            xb = batch["image"][:b]
            with torch.inference_mode():
                ms = _time_ms(lambda: segmenter_forward(model, xb, c),
                              iters=5)
            key = (f"serve b{b}", name)
            rates[key] = (max(rates.get(key, (0.0,))[0], b * 1000.0 / ms),
                          0.0)
    return rates


def _phase_seg(device, tmp, keep=None):
    from apla_tpu_torch import segdet
    from apla_tpu_torch.data.loader import DataLoader
    from apla_tpu_torch.data.segmentation_data import (ADE20KSegmentation,
                                                       segmentation_collate)
    from apla_tpu_torch.apla.core import AplaConfig
    from apla_tpu_torch.models.seg import (init_segmenter, make_seg_train_step,
                                           seg_optimizer)
    from apla_tpu_torch.ops import fused_apla_attn as fa
    from apla_tpu_torch.ops.quant import quantize_frozen_backbone
    from apla_tpu_torch.serve import (SegPredictor, export_segmenter,
                                      load_predictor, segmenter_from_state)

    t0 = time.perf_counter()
    _write_ade(tmp)
    r = SEG_RECIPE
    cfg = segdet.seg_vit_config(r["backbone"], r["img_size"],
                                r["patch_size"], r["use_fused"])
    plain_cfg = dataclasses.replace(cfg, use_fused_apla=False)
    depth, bsz = cfg.depth, r["batch_size"]
    steps, evals = SEG_TRAIN // bsz, -(-SEG_VAL // bsz)
    ds = ADE20KSegmentation(tmp, "training", img_size=r["img_size"])
    print(f"[9b seg] wrote {len(ds)} training and "
          f"{len(ADE20KSegmentation(tmp, 'validation'))} validation images "
          f"in {time.perf_counter() - t0:.1f} s")

    # the kernel arm against the plain arm: the loop's first batch, the
    # loop's init from SEED
    loader = DataLoader(ds, batch_size=bsz, shuffle=True, drop_last=True,
                        num_workers=0, collate_fn=segmentation_collate,
                        seed=SEED)
    batch = {k: v.to(device) for k, v in next(iter(loader)).items()}
    t = time.perf_counter()
    model = init_segmenter(cfg, ds.n_classes,
                           AplaConfig(partial_size=r["partial_size"]),
                           channels=r["channels"], n_aux_heads=r["aux_heads"],
                           generator=torch.Generator().manual_seed(SEED),
                           device=device)
    init_t, init_f = segdet._state(model)
    train = _trainables(model)
    print(f"[9b seg] {r['backbone']}/{r['patch_size']} SETR-PUP segmenter at "
          f"{r['img_size']} (init {time.perf_counter() - t:.1f} s): "
          f"{sum(p.numel() for p in train.values()):,} trainable in "
          f"{len(train)} tensors ({sum(p.numel() for n, p in train.items() if '.attn.proj.' in n):,} "
          f"in the {depth} projections), "
          f"{sum(p.numel() for p in model.parameters()):,} in all; labels "
          f"in the batch {sorted(torch.unique(batch['label']).tolist())[:6]}"
          f"... ({int((batch['label'] == 255).sum())} ignored pixels)")
    ref = _seg_grads(model, plain_cfg, batch)
    loss_tol = SEG_LOSS_REL_TOL * abs(ref[0])
    ok = _grad_agreement("9b seg", "kernel arm",
                         _seg_grads(model, cfg, batch), ref, loss_tol,
                         SEG_GRAD_REL_TOL)
    controls = {"dW_t zeroed": lambda out: (out[0], out[1] * 0),
                "dqkv halved": lambda out: (out[0] * 0.5, out[1])}
    caught = all([not _grad_agreement(
        "9b seg", f"control: {name}", _with_output_fault(
            fa, "fused_apla_attn_bwd", fault,
            lambda: _seg_grads(model, cfg, batch)), ref, loss_tol,
        SEG_GRAD_REL_TOL) for name, fault in controls.items()])
    # forward faults (one left unwritten tail row of 1025 passes both
    # bounds here: phase 9a holds it, PERF.md)
    fwd_controls = {
        "output x (1 + 2^-6)": lambda out: out * (1 + 2 ** -6),
        "output halved": lambda out: out * 0.5,
        "first head's 64 columns zeroed": lambda out: out.index_fill(
            2, torch.arange(64, device=out.device), 0)}
    fwd_caught = [not _grad_agreement(
        "9b seg", f"control: forward {name}", _with_output_fault(
            fa, "fused_apla_attn_fwd", fault,
            lambda: _seg_grads(model, cfg, batch)), ref, loss_tol,
        SEG_GRAD_REL_TOL) for name, fault in fwd_controls.items()]
    if not ok:
        raise SystemExit("the segmenter's kernel arm disagrees with its "
                         "plain arm")
    if not caught:
        raise SystemExit("a broken fused backward passes the gradient bounds")
    if not all(fwd_caught):
        raise SystemExit("a broken fused forward passes the bounds")
    for p in model.parameters():
        p.grad = None

    # train, evaluate, checkpoint through the loop; --resume, --eval_only,
    # a sliding-window evaluation (the plain arm's step: above and in the
    # rates below)
    kw = {k: v for k, v in r.items()}
    kw.update(SEG_CUTS, seed=SEED, device=str(device))
    kdir = os.path.join(tmp, "kernel")
    counters = (fa.fused_apla_attn_fwd, fa.fused_apla_attn_bwd)
    launches = [0, 0]

    def run(expect, what, **extra):
        for c in counters:
            c.launches = 0
        t = time.perf_counter()
        out = segdet.train_segmentation(tmp, **{**kw, **extra})
        _sync(device)
        got = tuple(c.launches for c in counters)
        print(f"[9b seg] {what}: {out} in {time.perf_counter() - t:.1f} s; "
              f"fused kernel launches forward {got[0]}, backward {got[1]} "
              f"(expected {expect[0]}, {expect[1]})")
        if got != expect:
            raise SystemExit(f"{what} did not run the fused kernels in "
                             "every block of every step and eval call")
        for i in range(2):
            launches[i] += got[i]
        return out

    # the backward runs in all 24 blocks: every projection is trainable,
    # so FusedAplaAttention's backward is needed for dW_t even in block 0,
    # whose qkv needs no gradient
    per_epoch = (depth * (steps + evals), depth * steps)
    out = run(per_epoch, "train 1 epoch (kernel arm)", save_dir=kdir)
    with open(os.path.join(kdir, "seg.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [x["train_loss"] for x in recs if "train_loss" in x]
    print(f"[9b seg] losses {losses}, grad norms "
          f"{[x['grad_norm'] for x in recs if 'grad_norm' in x]}")
    if (out["iters"] != steps or len(losses) != steps
            or not np.isfinite(losses).all()):
        raise SystemExit(f"missing or non-finite segmentation losses "
                         f"{losses}")
    if not all(segdet._has_ckpt(kdir, n) for n in ("seg_best", "seg_last",
                                                   "seg_frozen")):
        raise SystemExit(f"checkpoints missing: {sorted(os.listdir(kdir))}")
    best = segdet.load_checkpoint(os.path.join(kdir, "seg_best.pt"))
    last = segdet.load_checkpoint(os.path.join(kdir, "seg_last.pt"))
    kept = all(torch.equal(best["frozen"][n], v) for n, v in init_f.items())
    moved = {n: not torch.equal(last["trainable"][n], v)
             for n, v in init_t.items()}
    print(f"[9b seg] {sum(moved.values())}/{len(moved)} trainable tensors "
          f"moved, {len(init_f)} frozen tensors "
          f"{'unchanged bit for bit' if kept else 'CHANGED'}; checkpoints "
          f"{sorted(os.listdir(kdir))}")
    if not kept or not all(moved.values()):
        raise SystemExit(f"trainable not moved "
                         f"{[n for n, m in moved.items() if not m]} or "
                         "frozen changed")
    out2 = run(per_epoch, "--resume to 2 epochs", save_dir=kdir, epochs=2,
               resume=True)
    if out2["iters"] != steps:
        raise SystemExit("--resume did not continue at the second epoch")
    with open(os.path.join(kdir, "seg_best.json")) as f:
        best_miou = json.load(f)["miou"]
    out3 = run((depth * evals, 0), "--eval_only", save_dir=kdir,
               eval_only=True)
    print(f"[9b seg] --eval_only mIoU {out3['best_miou']!r}, seg_best's "
          f"{best_miou!r}")
    if out3["iters"] != 0 or out3["best_miou"] != best_miou:
        raise SystemExit("--eval_only does not report the best checkpoint's "
                         "mIoU")
    crop, stride = r["img_size"], (2 * r["img_size"]) // 3
    windows = len(range(0, SEG_SLIDE_SIZE - crop + 1, stride)) + (
        (SEG_SLIDE_SIZE - crop) % stride != 0)
    out4 = run((depth * evals * windows ** 2, 0),
               f"--eval_only --eval_img_size {SEG_SLIDE_SIZE} (sliding "
               f"windows, stride {stride})", save_dir=kdir, eval_only=True,
               eval_img_size=SEG_SLIDE_SIZE)
    if not 0.0 <= out4["best_miou"] <= 1.0:
        raise SystemExit("the sliding-window evaluation gave no mIoU")

    # export the best checkpoint with the fused bf16 config and serve it
    best = segdet.load_checkpoint(os.path.join(kdir, "seg_best.pt"))
    served = segmenter_from_state(cfg, best["trainable"], best["frozen"],
                                  device)
    art = os.path.join(tmp, "artifact")
    export_segmenter(art, served, cfg, batch_sizes=(1, 8))
    if keep is not None:
        keep["seg"] = {"artifact": art, "root": tmp,
                       "miou": out3["best_miou"],
                       "slide_miou": out4["best_miou"], "stride": stride,
                       "windows": windows, "depth": depth}
    pred = load_predictor(art, device)
    val = ADE20KSegmentation(tmp, "validation", img_size=crop)
    x = np.stack([val[i]["image"] for i in range(9)])
    big = ADE20KSegmentation(tmp, "validation", img_size=SEG_SLIDE_SIZE)
    x_big = np.stack([big[i]["image"] for i in range(9)])
    for c in counters:
        c.launches = 0
    # 1 and 9 images each way: the calls b1, then b8 + b1; the windows of
    # one image in one padded b8 call, those of 9 images in 5 b8 calls
    logits = [pred.predict(x[:1]), pred.predict(x)]
    slid = [pred.predict_slide(x_big[:1]), pred.predict_slide(x_big)]
    _sync(device)
    got = tuple(c.launches for c in counters)
    expect = (depth * (1 + 2 + -(-windows ** 2 // 8)
                       + -(-9 * windows ** 2 // 8)), 0)
    for i in range(2):
        launches[i] += got[i]
    print(f"[9b seg] served predict and predict_slide (at "
          f"{SEG_SLIDE_SIZE}) at 1 and 9 images: shapes "
          f"{[lg.shape for lg in logits + slid]}; fused kernel launches "
          f"{got} (expected {expect})")
    if got != expect or not all(np.isfinite(lg).all()
                                for lg in logits + slid):
        raise SystemExit("the served segmenter did not run the fused kernel "
                         "in every block, or returned non-finite logits")
    # the reference: the in-process module through the same calls
    inproc = SegPredictor(pred.meta, served, cfg, device)
    refs = [inproc.predict(x[:1]), inproc.predict(x),
            inproc.predict_slide(x_big[:1]), inproc.predict_slide(x_big)]
    devs = [float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-12))
            for a, b in zip(logits + slid, refs)]
    print(f"[9b seg] served logits vs the in-process module through the "
          f"same calls (predict at 1 and 9 images, predict_slide at 1 and "
          f"9): max|d| / max|ref| {[f'{d:.3g}' for d in devs]} (bound "
          f"{SEG_SERVE_REL_TOL})")
    if max(devs) > SEG_SERVE_REL_TOL:
        raise SystemExit("the served logits differ from the in-process "
                         "forward")
    del served, inproc, refs
    # W8A8: the best checkpoint through the CLI with --quantize_frozen
    # (bf16, the fused attention), served: the int8 kernel in each qkv,
    # fc1 and fc2 and the attention kernel in every block of every call
    q_int8, q_fwd = _w8a8_served(
        "9b seg", ["export_seg", "--ckpt", os.path.join(kdir, "seg_best.pt"),
                   "--backbone", r["backbone"], "--img_size",
                   str(r["img_size"]), "--patch_size", str(r["patch_size"])],
        os.path.join(tmp, "w8a8"), device, [x[:1], x[:2]],
        lambda p: SegPredictor(p.meta, quantize_frozen_backbone(
            segmenter_from_state(p.vit_cfg, best["trainable"], best["frozen"],
                                 device)), p.vit_cfg, device),
        fwd_counter=fa.fused_apla_attn_fwd, per_call=(3 * depth, depth))
    launches[0] += q_fwd
    launches.append(q_int8)

    rates = _seg_rates(model, batch, cfg, plain_cfg, r["head_lr_mult"])
    for (what, name), (rate, peak) in sorted(rates.items()):
        print(f"[9b seg] {what} {name} arm: {rate:.2f} img/s"
              + (f", peak {peak:.2f} GB" if what == "train" else ""))
    step = make_seg_train_step(cfg, seg_optimizer(model, 1e-9, 1e-4,
                                                  r["head_lr_mult"]))
    _print_profile("9b seg", f"kernel arm, b{bsz} train step",
                   *_profile_step(lambda: step(model, batch)))
    print(f"[9b seg] phase took {time.perf_counter() - t0:.1f} s")
    return tuple(launches), rates


def _int8_bound(m, k, n, dtype, bias=False):
    """The int8 GEMM's least time: 2 m n k int8 tensor-core operations;
    reads x (m k in its dtype), the int8 weight (k n), its scales and the
    f32 bias if any, writes y (m n in x's dtype)."""
    es = torch.finfo(dtype).bits // 8
    t_ops = 2 * m * n * k / PEAK_INT8_OPS * 1e3
    t_bytes = (m * k * es + k * n + 4 * n * (1 + bias) + m * n * es) \
        / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _int8_operands(device, m, k, n, dtype, gen, bias=False):
    """x [m, k], a `QuantizedKernel` of a [k, n] weight (its int8 codes,
    scales and K-major copy) and, if asked, an f32 bias [n], on
    `device`."""
    from apla_tpu_torch.ops.quant import QuantizedKernel, quantize_weight
    x = torch.randn((m, k), generator=gen).to(device, dtype)
    w = (torch.randn((k, n), generator=gen) * k ** -0.5).to(device)
    b = (torch.randn((n,), generator=gen) * 0.1).to(device) if bias \
        else None
    return x, QuantizedKernel(*quantize_weight(w)), b


def _int8_faulty(x, w_i8, w_scale, group, tensor_sx=False, trunc=False,
                 bias=None):
    """What a broken int8 kernel would compute: the plain version with one
    activation scale for the whole tensor, with the codes truncated toward
    zero instead of rounded half to even, or with the bias added to the f32
    sum before the one rounding instead of after it."""
    from apla_tpu_torch.ops.int8_matmul import scale_of
    m, k = x.shape
    xf = x.float().reshape(m, k // group, group)
    amax = xf.abs().amax() if tensor_sx else xf.abs().amax(-1, keepdim=True)
    sx = scale_of(amax).expand(m, k // group, 1)
    codes = torch.clamp((torch.trunc if trunc else torch.round)(xf / sx),
                        -127, 127)
    acc = torch.zeros((m, w_i8.shape[1]), device=x.device)
    for g in range(k // group):
        part = torch.matmul(codes[:, g].double(),
                            w_i8[g * group:(g + 1) * group].double())
        acc = acc + (part.float() * sx[:, g]) * w_scale[None, :]
    if bias is not None:
        acc = acc + bias.to(x.dtype).float()
    return acc.to(x.dtype)


def phase_int8(device):
    """10a: the int8 kernel (quantize pass + int8 wgmma GEMM) against its
    plain version at INT8_CASES, with seven fault controls; its registers,
    spills and shared memory; times by events, from a CUDA graph and as the
    host's ms to launch one, beside the bound, torch._int_mm and
    torch.matmul (the yardsticks the port never calls).  Its two launches
    apart: tools/compare_mha_fwd.py --kernel int8 (torch.profiler, in a
    process of their own: late in this run it lost kernel records)."""
    from apla_tpu_torch.ops import cuda_build
    from apla_tpu_torch.ops import int8_matmul as tim
    from apla_tpu_torch.ops.quant import dequantize_weight
    for line in _resources(cuda_build.resource_report(tim.SOURCE)):
        print(f"[10a int8] {line}")
    gen = torch.Generator().manual_seed(SEED)
    worst, times = 0.0, {}
    for name, m, k, n, group, dtype, with_bias in INT8_CASES:
        x, qk, b = _int8_operands(device, m, k, n, dtype, gen, with_bias)

        def kernel(x=x, w=qk.w_int8, s=qk.scale, group=group,
                   wk=qk.w_kmajor, b=b):
            return tim.fused_int8_matmul(x, w, s, group, wk, bias=b)

        y = kernel()
        torch.cuda.synchronize()
        ref = tim.fused_int8_matmul_reference(x, qk.w_int8, qk.scale, group,
                                              b)
        err = (y.float() - ref.float()).abs().max().item()
        bound = INT8_REL_TOL * ref.float().abs().max().item()
        ok = (y.shape == ref.shape and y.dtype == dtype
              and bool(torch.isfinite(y).all()) and err <= bound)
        plan = tim.int8_plan(m, n, k, group, dtype)
        print(f"[10a int8] {name}: x [{m}, {k}] {str(dtype)[6:]} @ int8 "
              f"[{k}, {n}], groups of {group}"
              + (", + f32 bias" if with_bias else "")
              + f" ({plan.describe()}): max|err| {err:.6g} bound "
              f"{bound:.6g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the int8 kernel disagrees with its plain "
                             f"version at {name}")
        worst = max(worst, err)
        controls = {}
        if name == "fc2 b64":
            tail = (m // 128) * 128
            controls = {
                "sw dropped": lambda: tim.fused_int8_matmul(
                    x, qk.w_int8, torch.ones_like(qk.scale), group,
                    qk.w_kmajor),
                "one tensor-wide sx": lambda: _int8_faulty(
                    x, qk.w_int8, qk.scale, group, tensor_sx=True),
                "truncation instead of rint": lambda: _int8_faulty(
                    x, qk.w_int8, qk.scale, group, trunc=True),
                f"ragged tail rows {tail}..{m - 1} unwritten":
                    lambda: torch.cat([y[:tail], torch.zeros_like(y[tail:])]),
            }
        elif name == INT8_ROW13:
            kk = k - group
            controls = {"the last group skipped": lambda: tim.fused_int8_matmul(
                x[:, :kk].contiguous(), qk.w_int8[:kk], qk.scale, group,
                qk.w_kmajor[:, :kk].contiguous())}
        elif with_bias:
            controls = {
                "bias dropped": lambda: tim.fused_int8_matmul(
                    x, qk.w_int8, qk.scale, group, qk.w_kmajor),
                "bias added before the rounding": lambda: _int8_faulty(
                    x, qk.w_int8, qk.scale, group, bias=b)}
        for c_name, fault in controls.items():
            c_err = (fault().float() - ref.float()).abs().max().item()
            print(f"[10a int8] control {c_name} at {name}: max|err| "
                  f"{c_err:.6g} bound {bound:.6g} -> "
                  f"{'caught' if c_err > bound else 'NOT CAUGHT'}")
            if c_err <= bound:
                raise SystemExit(f"the int8 bound misses a broken kernel "
                                 f"({c_name})")
        # yardsticks the port never calls: the bf16 (or f32) product with
        # the dequantized weight (with the bias, as F.linear adds it), and
        # torch._int_mm, the int8 product alone
        w_mm = dequantize_weight(qk.w_int8, qk.scale).to(dtype)
        codes = torch.randint(-127, 128, (m, k), generator=gen,
                              dtype=torch.int8).to(device)
        matmul = ((lambda: torch.matmul(x, w_mm)) if b is None else
                  (lambda: torch.addmm(b.to(dtype), x, w_mm)))
        t = {"ms": _time_ms(kernel), "graph_ms": _graph_ms(kernel),
             "host_ms": _host_ms(kernel),
             "plain_ms": _time_ms(lambda: tim.fused_int8_matmul_reference(
                 x, qk.w_int8, qk.scale, group, b), iters=5, warmup=1),
             "library_ms": (_time_ms(lambda: torch._int_mm(
                 codes, qk.w_kmajor.t())) if m > 16 else None),
             "library_matmul_ms": _time_ms(matmul)}
        t["bound_ms"], t["bound_by"] = _int8_bound(m, k, n, dtype,
                                                   with_bias)
        times[name] = t
        print(f"[10a int8] {name}: kernel {t['ms']:.4f} ms "
              f"({2 * m * n * k / t['ms'] / 1e9:.1f} TOPS; graph "
              f"{t['graph_ms']:.4f}, host {t['host_ms']:.4f} ms to launch "
              f"one), plain {t['plain_ms']:.4f} ms, torch._int_mm "
              + (f"{t['library_ms']:.4f}" if t["library_ms"] else "n/a")
              + f" ms, {str(dtype)[6:]} torch.matmul"
              + (" + bias" if b is not None else "")
              + f" {t['library_matmul_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}); "
              f"{t['bound_ms'] / t['ms']:.1%} of it")
        del x, qk, b, y, ref, w_mm, codes
    return worst, times


def _arrays(out):
    """The numpy arrays of a predictor's output, flattened in order."""
    if isinstance(out, np.ndarray):
        return [out]
    return [a for part in out for a in _arrays(part)]


def _max_rel_dev(outs, refs):
    return max(float(np.abs(a - b).max() / max(float(np.abs(b).max()),
                                               1e-12))
               for a, b in zip(_arrays(outs), _arrays(refs), strict=True))


def _w8a8_served(tag, argv, art, device, requests, inproc, fwd_counter=None,
                 per_call=(0, 0)):
    """`serve.main(argv + --quantize_frozen)` exports a W8A8 artifact to
    `art`; it is reloaded on `device` and asked for `requests`: the int8
    kernel must run per_call[0] times in every call (and `fwd_counter`,
    the attention kernel, per_call[1] times), the outputs must be finite and
    within W8A8_SERVE_REL_TOL of `inproc(pred)`, a predictor over the
    in-process quantized module, through the same calls.  Returns the
    (int8, attention) launches."""
    from apla_tpu_torch import serve
    from apla_tpu_torch.ops import int8_matmul as tim
    t = time.perf_counter()
    serve.main(argv + ["--out", art, "--batch_sizes", "1,8",
                       "--quantize_frozen"])
    pred = serve.load_predictor(art, device)
    n_calls = sum(1 for x in requests for _ in pred._iter_chunks(x))
    counters = [tim.fused_int8_matmul] + ([fwd_counter] if fwd_counter
                                          else [])
    for c in counters:
        c.launches = 0
    outs = [pred.predict(x) for x in requests]
    _sync(device)
    got = tuple(c.launches for c in counters) + (0,) * (2 - len(counters))
    expect = (per_call[0] * n_calls, per_call[1] * n_calls)
    dev = _max_rel_dev(outs, [inproc(pred).predict(x) for x in requests])
    print(f"[{tag}] W8A8 artifact (--quantize_frozen, "
          f"quantized_frozen={pred.meta['quantized_frozen']}, params.npz "
          f"{os.path.getsize(os.path.join(art, 'params.npz')):,} bytes) "
          f"exported and reloaded in {time.perf_counter() - t:.1f} s; "
          f"{[len(x) for x in requests]} images in {n_calls} calls: "
          f"int8 / attention kernel launches {got} (expected {expect}); "
          f"vs the in-process quantized module through the same calls "
          f"max|d| / max|ref| {dev:.3g} (bound {W8A8_SERVE_REL_TOL})")
    if not pred.meta["quantized_frozen"] or got != expect or not all(
            np.isfinite(a).all() for a in _arrays(outs)):
        raise SystemExit(f"the W8A8 artifact did not run the int8 kernel in "
                         f"every quantized product of every call")
    if dev > W8A8_SERVE_REL_TOL:
        raise SystemExit("the W8A8 artifact's outputs differ from the "
                         "in-process quantized module's")
    return got


def _peak_above(device, fn) -> float:
    """GB of device memory fn() takes at its peak above what was allocated
    before it."""
    _sync(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    _sync(device)
    return (torch.cuda.max_memory_allocated(device) - base) / 1e9


def phase_w8a8(device):
    with tempfile.TemporaryDirectory(prefix="chip_smoke_w8a8_") as tmp:
        return _phase_w8a8(device, tmp)


def _cosines(outs, refs):
    """Per-request minimum embedding cosine of (logits, embedding) pairs."""
    return [float((np.sum(e * r, -1) / (np.linalg.norm(e, axis=-1)
                                        * np.linalg.norm(r, axis=-1))).min())
            for (_, e), (_, r) in zip(outs, refs)]


def _codes_flipped(runs):
    """(codes that differ, codes) between the int8 inputs two arms gave the
    same products: `runs` is two lists of int8 code tensors."""
    diff = sum(int((a != b).sum()) for a, b in zip(*runs, strict=True))
    return diff, sum(a.numel() for a in runs[0])


def _phase_w8a8(device, tmp):
    from apla_tpu_torch.models.classifier import (classifier_forward,
                                                  init_classifier)
    from apla_tpu_torch.ops import fused_apla_attn as fa
    from apla_tpu_torch.ops import int8_matmul as tim
    from apla_tpu_torch.ops import quant
    from apla_tpu_torch.serve import (Predictor, export_classifier,
                                      load_predictor)
    from apla_tpu_torch.wrapper import build_apla_config, build_vit_config

    t0 = time.perf_counter()
    grid_cfg = build_vit_config(RECIPE)
    apla_cfg = build_apla_config(RECIPE)
    if apla_cfg.inds_path:
        apla_cfg = dataclasses.replace(
            apla_cfg, inds_path=os.path.join(ROOT, apla_cfg.inds_path))
    model = init_classifier(grid_cfg, N_CLASSES, apla_cfg,
                            generator=torch.Generator().manual_seed(SEED),
                            device=device)
    serve_cfg = dataclasses.replace(grid_cfg, img_size=SERVE_IMG)
    depth = serve_cfg.depth
    arts = {"float": os.path.join(tmp, "float"),
            "w8a8": os.path.join(tmp, "w8a8")}
    export_classifier(arts["float"], model, serve_cfg,
                      batch_sizes=BATCH_SIZES)
    meta = export_classifier(arts["w8a8"], model, serve_cfg,
                             batch_sizes=BATCH_SIZES, quantize_frozen=True)
    inproc_model = quant.quantize_frozen_backbone(copy.deepcopy(model))
    del model
    sizes = {k: os.path.getsize(os.path.join(p, "params.npz"))
             for k, p in arts.items()}
    print(f"[10b w8a8] ViT-B/14 APLA-128 classifier exported float and W8A8 "
          f"(quantized_frozen={meta['quantized_frozen']}) in "
          f"{time.perf_counter() - t0:.1f} s: params.npz {sizes['float']:,} "
          f"and {sizes['w8a8']:,} bytes ({sizes['w8a8'] / sizes['float']:.3f}"
          f"x)")
    if not meta["quantized_frozen"]:
        raise SystemExit("the W8A8 export did not quantize the backbone")
    pred, fpred = (load_predictor(arts[k], device) for k in ("w8a8", "float"))
    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((n, SERVE_IMG, SERVE_IMG, 3),
                                    dtype=np.float32) for n in REQUESTS]
    n_calls = sum(1 for x in requests for _ in pred._iter_chunks(x))

    counters = (tim.fused_int8_matmul, fa.fused_apla_attn_fwd)
    for c in counters:
        c.launches = 0
    outs = [pred.predict_and_embed(x) for x in requests]
    _sync(device)
    launches = tuple(c.launches for c in counters)
    expect = (3 * depth * n_calls, depth * n_calls)
    print(f"[10b w8a8] answered {list(REQUESTS)} images in {n_calls} calls; "
          f"int8 / attention kernel launches {launches} (expected {expect})")
    if launches != expect:
        raise SystemExit("the W8A8 served path did not run the int8 kernel "
                         "in each qkv, fc1 and fc2 of every call")
    for x, (logits, emb) in zip(requests, outs):
        if logits.shape != (len(x), N_CLASSES) \
                or emb.shape != (len(x), serve_cfg.embed_dim) \
                or not (np.isfinite(logits).all() and np.isfinite(emb).all()):
            raise SystemExit(f"bad W8A8 output for a request of {len(x)}")
    inproc = Predictor(pred.meta, inproc_model.eval(), serve_cfg, device)
    dev = _max_rel_dev(outs, [inproc.predict_and_embed(x) for x in requests])
    print(f"[10b w8a8] served vs the in-process quantized module through the "
          f"same calls: max|d| / max|ref| {dev:.3g} (bound "
          f"{W8A8_SERVE_REL_TOL})")
    if dev > W8A8_SERVE_REL_TOL:
        raise SystemExit("the W8A8 artifact's outputs differ from the "
                         "in-process quantized module's")
    del inproc, inproc_model

    # the int8 arm: the same calls with the int8 kernel's plain version in
    # its place (the attention kernel as before), so any difference is the
    # int8 kernel's; the plain arm: the attention's plain version as well
    plain_cfg = dataclasses.replace(serve_cfg, use_fused_apla=False,
                                    use_flash=False)
    plain = Predictor(pred.meta, pred.model, plain_cfg, device)
    real = quant.fused_int8_matmul

    def plain_int8(x, w_i8, w_scale, group, w_kmajor=None, bias=None):
        return tim.fused_int8_matmul_reference(x, w_i8, w_scale, group,
                                               bias)

    def plain_run(fn, int8=plain_int8):
        return _with_patch(quant, "fused_int8_matmul", int8, fn)

    def codes_of(pr, int8):
        """The int8 codes of every quantized product of the 9-image
        request served by `pr` through `int8`."""
        codes = []

        def rec(x, *args, **kwargs):
            codes.append(quant._quantize_rows(x)[0])
            return int8(x, *args, **kwargs)
        plain_run(lambda: pr.predict(requests[1]), rec)
        return codes

    int8_outs = plain_run(lambda: [pred.predict_and_embed(x)
                                   for x in requests])
    dev = _max_rel_dev(outs, int8_outs)
    kernel_codes = codes_of(pred, real)
    flipped = [_codes_flipped((kernel_codes, codes_of(pr, plain_int8)))
               for pr in (pred, plain)]
    print(f"[10b w8a8] kernel arm vs int8 arm (the int8 kernel's plain "
          f"version in every quantized product): max|d| / max|ref| "
          f"{dev:.3g} (bound {W8A8_SERVE_REL_TOL}); int8 codes of the "
          f"9-image request that differ: {flipped[0][0]:,} of "
          f"{flipped[0][1]:,}")
    # a fault control: every int8 product without its weight scales
    c_dev = _max_rel_dev(plain_run(lambda: [pred.predict_and_embed(x)
                                            for x in requests],
                                   lambda x, w, s, group, w_kmajor=None,
                                   bias=None: real(
                                       x, w, torch.ones_like(s), group,
                                       w_kmajor, bias)), int8_outs)
    print(f"[10b w8a8] control: sw dropped vs int8 arm: max|d| / max|ref| "
          f"{c_dev:.3g} -> {'caught' if c_dev > W8A8_SERVE_REL_TOL else 'NOT CAUGHT'}")
    plain_outs = plain_run(lambda: [plain.predict_and_embed(x)
                                    for x in requests])
    p_cos = min(_cosines(outs, plain_outs))
    print(f"[10b w8a8] kernel arm vs plain arm (both kernels' plain "
          f"versions): min embedding cosine {p_cos:.6f} (bound "
          f"{W8A8_MIN_COSINE}); int8 codes of the 9-image request that "
          f"differ: {flipped[1][0]:,} of {flipped[1][1]:,} "
          f"({flipped[1][0] / flipped[1][1]:.3g}: bf16 activations one "
          f"rounding apart upstream)")
    del kernel_codes
    if dev > W8A8_SERVE_REL_TOL or p_cos < W8A8_MIN_COSINE:
        raise SystemExit("the W8A8 kernel arm disagrees with its plain arms")
    if c_dev <= W8A8_SERVE_REL_TOL:
        raise SystemExit("a broken int8 kernel passes the W8A8 bound")

    # W8A8 against the float artifact
    f_outs = [fpred.predict_and_embed(x) for x in requests]
    cos = min(_cosines(outs, f_outs))
    dl = max(float(np.abs(lg - r).max() / np.abs(r).max())
             for (lg, _), (r, _) in zip(outs, f_outs))
    top1 = np.mean(np.concatenate([lg.argmax(-1) == r.argmax(-1)
                                   for (lg, _), (r, _) in zip(outs, f_outs)]))
    print(f"[10b w8a8] W8A8 vs float artifact: min embedding cosine "
          f"{cos:.6f} (bound {W8A8_MIN_COSINE}), max|dlogits| / max|logits| "
          f"{dl:.4g}, top-1 agreement {top1:.3f}")
    if cos < W8A8_MIN_COSINE:
        raise SystemExit("the W8A8 artifact strays from the float one")

    x64 = torch.from_numpy(requests[-1][:64]).to(device)
    arms = {"w8a8 kernel": lambda: classifier_forward(pred.model, x64,
                                                      serve_cfg),
            "w8a8 plain": lambda: plain_run(lambda: classifier_forward(
                pred.model, x64, plain_cfg)),
            "float kernel": lambda: classifier_forward(fpred.model, x64,
                                                       serve_cfg)}
    rates, peaks = {}, {}
    with torch.inference_mode():
        for name in ("w8a8 plain", "w8a8 kernel", "float kernel",
                     "float kernel", "w8a8 kernel", "w8a8 plain"):
            ms = _time_ms(arms[name], iters=10)
            rates.setdefault(name, []).append(64 * 1000.0 / ms)
        for name, fn in arms.items():
            peaks[name] = _peak_above(device, fn)
    weights = {name: sum(t.numel() * t.element_size() for t in
                         list(m.parameters()) + list(m.buffers())) / 1e9
               for name, m in (("w8a8", pred.model), ("float", fpred.model))}
    best = {name: max(r) for name, r in rates.items()}
    print(f"[10b w8a8] b64 forward img/s (best of 2 turns): " + ", ".join(
        f"{name} {best[name]:.1f} {rates[name]}" for name in arms)
          + "; peak device memory above the resident weights per b64 call: "
          + ", ".join(f"{name} {peaks[name]:.2f} GB" for name in arms)
          + f"; resident weights W8A8 {weights['w8a8']:.3f} GB, float "
          f"{weights['float']:.3f} GB")
    with torch.inference_mode():
        _print_profile("10b w8a8", "W8A8 kernel arm, one b64 call",
                       *_profile_step(arms["w8a8 kernel"]))
    print(f"[10b w8a8] phase took {time.perf_counter() - t0:.1f} s")
    return launches, best


# --------------------------------------------------------------------------- #
# 12: the shipped recipes from real weights
# --------------------------------------------------------------------------- #

def _subdir(root, name):
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    return path


def _dinov2_state(cfg, seed) -> dict:
    """A seeded DINOv2 ViT state dict in the torch.hub layout at `cfg`'s
    widths: LayerScale, a mask token, `pos_embed` on `cfg`'s grid."""
    g = torch.Generator().manual_seed(seed)
    d, h, p = cfg.embed_dim, cfg.mlp_hidden, cfg.patch_size

    def w(*shape, mean=0.0):
        return mean + 0.02 * torch.randn(shape, generator=g)
    sd = {"cls_token": w(1, 1, d), "pos_embed": w(1, cfg.num_patches + 1, d),
          "mask_token": w(1, d), "patch_embed.proj.weight": w(d, 3, p, p),
          "patch_embed.proj.bias": w(d), "norm.weight": w(d, mean=1.0),
          "norm.bias": w(d)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for name, shape in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                            ("mlp.fc1", (h, d)), ("mlp.fc2", (d, h))):
            sd[f"{b}{name}.weight"] = w(*shape)
            sd[f"{b}{name}.bias"] = w(shape[0])
        for name in ("norm1", "norm2"):
            sd[f"{b}{name}.weight"] = w(d, mean=1.0)
            sd[f"{b}{name}.bias"] = w(d)
        for name in ("ls1", "ls2"):
            sd[f"{b}{name}.gamma"] = 0.1 + 0.9 * torch.rand(d, generator=g)
    return sd


def _chunked(sd, chunks=4):
    """DINOv2's BlockChunk layout: block i of chunk c as `blocks.c.i.`."""
    depth = 1 + max(int(k.split(".")[1]) for k in sd if
                    k.startswith("blocks."))
    per = -(-depth // chunks)
    return {(f"blocks.{int(k.split('.')[1]) // per}.{k[len('blocks.'):]}"
             if k.startswith("blocks.") else k): v for k, v in sd.items()}


def _hf(sd):
    """The same tensors under Hugging Face `Dinov2Model` names."""
    emb = "embeddings."
    out = {emb + "patch_embeddings.projection.weight":
           sd["patch_embed.proj.weight"],
           emb + "patch_embeddings.projection.bias":
           sd["patch_embed.proj.bias"],
           emb + "cls_token": sd["cls_token"], emb + "mask_token":
           sd["mask_token"], emb + "position_embeddings": sd["pos_embed"],
           "layernorm.weight": sd["norm.weight"],
           "layernorm.bias": sd["norm.bias"]}
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        b, p = f"blocks.{i}.", f"encoder.layer.{i}."
        for n, wt, bias in zip(("query", "key", "value"),
                               sd[b + "attn.qkv.weight"].chunk(3),
                               sd[b + "attn.qkv.bias"].chunk(3)):
            out[f"{p}attention.attention.{n}.weight"] = wt.clone()
            out[f"{p}attention.attention.{n}.bias"] = bias.clone()
        for ours, theirs in (("attn.proj", "attention.output.dense"),
                             ("norm1", "norm1"), ("norm2", "norm2"),
                             ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                out[f"{p}{theirs}.{leaf}"] = sd[f"{b}{ours}.{leaf}"]
        out[p + "layer_scale1.lambda1"] = sd[b + "ls1.gamma"]
        out[p + "layer_scale2.lambda1"] = sd[b + "ls2.gamma"]
        i += 1
    return out


def _recipe_file(tmp, name, recipe, cuts, device, pth):
    """`recipe` with `cuts` on `device`, its checkpoint path at `pth`,
    written as JSON for the CLIs' `--params_path` (the card's machine has no
    PyYAML)."""
    params = _run_params(recipe, cuts, tmp, device)
    params["model_params"]["pretrained_checkpoint"] = pth
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(params, f)
    return path, params


def _run_main(argv):
    """`apla_tpu_torch.main.run_cli(argv)` -> (its result, the `Trainer`
    it built, that trainer's model state when it was built: the wrapper's
    weights before any step)."""
    from apla_tpu_torch import main as tmain
    from apla_tpu_torch.train import trainer as tr
    seen = []

    class Recorded(tr.Trainer):
        def __init__(self, wrapper):
            super().__init__(wrapper)
            seen.append((self, {n: t.detach().clone() for n, t in
                                self.state.model.state_dict().items()}))
    result = _with_patch(tr, "Trainer", Recorded,
                         lambda: tmain.run_cli(argv))
    return result, seen[0][0], seen[0][1]


def _same(got: dict, want: dict, names=None) -> list:
    """The names (of `names`, default all of `want`) whose tensors differ
    bit for bit (or are missing) in `got`."""
    return [n for n in (names if names is not None else want)
            if n not in got or not torch.equal(got[n].cpu(), want[n].cpu())]


def _main_run_checks(tag, trainer, accum, counters):
    """The launches (rows 1, 2 in every block of every micro-step and eval
    call) and finite losses of a `run_cli` training run."""
    loaders = trainer.wrapper.dataloaders
    steps = len(loaders.trainloader)
    evals = len(loaders.valloader) + len(loaders.testloader)
    depth = trainer.vit_cfg.depth
    got = tuple(c.launches for c in counters)
    expect = (depth * (steps * accum + evals), depth * steps * accum)
    losses = [r["train_loss"] for _, r in trainer.history
              if "train_loss" in r]
    print(f"[{tag}] {steps} update(s) of {accum} x b"
          f"{loaders.trainloader.batch_size // accum}, losses {losses}; "
          f"fused kernel launches forward {got[0]} (expected {expect[0]}), "
          f"backward {got[1]} (expected {expect[1]})")
    if got != expect:
        raise SystemExit(f"[{tag}] the run did not launch rows 1 and 2 in "
                         "every block of every micro-step and eval call")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise SystemExit(f"[{tag}] missing or non-finite losses {losses}")
    return got


def phase_import(device, float_rates, keep):
    """12: the shipped recipes from real weights (12a import, 12b transfer
    and serve export, 12c W8A8 training, 12d serve eval); `float_rates`:
    phase 5's train-step rates, printed beside W8A8's; `keep`: what phases
    6b, 8b and 9b left (the DINOv2 checkpoint, the detector's and the
    segmenter's artifacts with their data and the loops' readings)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as tmp:
        return _phase_import(device, tmp, float_rates, keep)


def _phase_import(device, tmp, float_rates, keep):
    from apla_tpu_torch import serve
    from apla_tpu_torch.ops import fused_apla_attn as fa
    from apla_tpu_torch.ops import fused_swin_attn as fs
    from apla_tpu_torch.ops import int8_matmul as tim
    from apla_tpu_torch.ops import quant
    from apla_tpu_torch.train.checkpoint import load_transfer_checkpoint
    from apla_tpu_torch.utils.pretrained import convert_torch_vit_state_dict
    from apla_tpu_torch.wrapper import DefaultWrapper, build_vit_config

    t0 = time.perf_counter()
    launches = {"fwd": 0, "bwd": 0, "int8": 0, "swin_fwd": 0, "seg_fwd": 0}
    counters = (fa.fused_apla_attn_fwd, fa.fused_apla_attn_bwd)
    cfg = build_vit_config(IMPORT_RECIPE)
    accum = int(IMPORT_RECIPE["training_params"]["accum_steps"])

    # 12a: the seeded ViT-B/14 in three layouts, imported by the shipped
    # recipe through `python -m apla_tpu_torch.main`
    sd = _dinov2_state(cfg, SEED)
    paths = {}
    for name, layout in (("hub", sd), ("chunked", _chunked(sd)),
                         ("hf", _hf(sd))):
        paths[name] = os.path.join(tmp, f"dinov2_vitb14_{name}.pth")
        torch.save(layout, paths[name])
    want = {f"backbone.{n}": t for n, t in
            convert_torch_vit_state_dict(sd, cfg.depth,
                                         has_layerscale=True).items()}
    print(f"[12a import] ViT-B/14 state dict ({len(sd)} tensors, "
          f"{sum(t.numel() for t in sd.values()):,} values, pos_embed "
          f"{tuple(sd['pos_embed'].shape)}, LayerScale, mask token) written "
          f"in the hub, chunked and HF layouts in "
          f"{time.perf_counter() - t0:.1f} s")
    recipe, params = _recipe_file(tmp, "imagenet", IMPORT_RECIPE,
                                  IMPORT_CUTS, device, paths["hub"])
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    _, trainer, before = _run_main(["--params_path", recipe, "--device",
                                    str(device), "--model_name", "import"])
    _sync(device)
    got = _main_run_checks("12a import", trainer, accum, counters)
    launches["fwd"] += got[0]
    launches["bwd"] += got[1]
    frozen_names = [n for n in want if not n.endswith(("proj_wt",
                                                       "proj_bt"))]
    bad = _same(before, want, frozen_names)
    model = trainer.state.model
    inds_ok = all(torch.equal(
        before[f"backbone.blocks.{i}.attn.proj_wt"],
        before[f"backbone.blocks.{i}.attn.proj.kernel"][
            :, before[f"backbone.blocks.{i}.attn.inds"]]) and torch.equal(
        before[f"backbone.blocks.{i}.attn.proj_bt"],
        before[f"backbone.blocks.{i}.attn.proj.bias"][
            before[f"backbone.blocks.{i}.attn.inds"]])
        for i in range(cfg.depth))
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"[12a import] `main --params_path` (pretrained: true, "
          f"pretrained_checkpoint -> the hub file) in "
          f"{time.perf_counter() - t:.1f} s: {len(frozen_names) - len(bad)}"
          f"/{len(frozen_names)} imported tensors bit-equal to the file's "
          f"as the converter maps them; APLA-128 columns = the projection's "
          f"`inds` columns in every block: {inds_ok}; {trainable:,} "
          f"trainable")
    if bad or not inds_ok:
        raise SystemExit(f"the import differs from the file at {bad[:5]}")
    others = {}
    for name in ("chunked", "hf"):
        p = copy.deepcopy(params)
        p["model_params"]["pretrained_checkpoint"] = paths[name]
        p["model_params"]["n_classes"] = N_CLASSES
        w = DefaultWrapper(p)
        w.init_model(SEED)
        others[name] = _same(w.model.state_dict(), before)
        del w
    print(f"[12a import] the chunked and HF layouts give models bit-equal "
          f"to the hub layout's: tensors that differ "
          f"{ {k: len(v) for k, v in others.items()} }")
    if any(others.values()):
        raise SystemExit(f"the layouts import differently: {others}")
    del trainer, model, before

    # 12b: phase 6b's DINOv2 checkpoint adopted by a supervised fine-tune
    # (backbone-only), one update, checkpointed, then `serve export
    # --pretrained_path` and served b64 at the recipe's 518 grid
    ssl_ckpt = keep["ssl_ckpt"]
    t_ck, f_ck = load_transfer_checkpoint(ssl_ckpt)
    ft_cuts = copy.deepcopy(IMPORT_CUTS)
    ft_cuts["dataset_params"]["synthetic_size"] = 64
    recipe_ft, _ = _recipe_file(tmp, "finetune", IMPORT_RECIPE, ft_cuts,
                                device, paths["hub"])
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    _, trainer, before = _run_main([
        "--params_path", recipe_ft, "--pretrained_path", ssl_ckpt,
        "--device", str(device), "--model_name", "finetune"])
    _sync(device)
    got = _main_run_checks("12b transfer", trainer, accum, counters)
    launches["fwd"] += got[0]
    launches["bwd"] += got[1]
    adopted_t = [n for n in before if n in t_ck]
    adopted_f = [n for n in before if n in f_ck]
    bad = _same(before, t_ck, adopted_t) + _same(before, f_ck, adopted_f)
    head_kept = not any(n.startswith("fc.") for n in t_ck)
    print(f"[12b transfer] `main --pretrained_path` (6b's DINOv2 checkpoint)"
          f" in {time.perf_counter() - t:.1f} s: backbone-only scope "
          f"(head not in the checkpoint: {head_kept}); {len(adopted_t)} "
          f"trainable (the teacher's best snapshot) and {len(adopted_f)} "
          f"frozen tensors adopted, bit-equal to the checkpoint's: "
          f"{not bad}")
    if bad or not head_kept or not adopted_t or not adopted_f:
        raise SystemExit(f"the transfer differs from the checkpoint at "
                         f"{bad[:5]}")
    art = os.path.join(tmp, "classifier")
    t = time.perf_counter()
    serve.main(["export", "--params_path", recipe_ft, "--pretrained_path",
                trainer.checkpoint_path, "--out", art, "--n_classes",
                str(N_CLASSES), "--batch_sizes", "64"])
    pred = serve.load_predictor(art, device)
    img = pred.meta["img_size"]
    x = np.random.default_rng(SEED).standard_normal(
        (64, img, img, 3), dtype=np.float32)
    fa.fused_apla_attn_fwd.launches = 0
    out = pred.predict_and_embed(x)
    _sync(device)
    served_launches = fa.fused_apla_attn_fwd.launches
    launches["fwd"] += served_launches
    inproc = serve.Predictor(pred.meta, trainer.state.model, pred.vit_cfg,
                             device)
    with trainer._trainable_swapped(trainer.best_trainable):
        ref = inproc.predict_and_embed(x)
    dev = _max_rel_dev(out, ref)
    print(f"[12b transfer] `serve export --pretrained_path` (the fine-tune's "
          f"checkpoint) and reload in {time.perf_counter() - t:.1f} s; b64 "
          f"at {img} px: row-1 launches {served_launches} (expected "
          f"{cfg.depth}); vs the in-process module max|d| / max|ref| "
          f"{dev:.3g} (bound {W8A8_SERVE_REL_TOL})")
    if served_launches != cfg.depth or dev > W8A8_SERVE_REL_TOL or not all(
            np.isfinite(a).all() for a in out):
        raise SystemExit("the exported classifier does not answer as the "
                         "fine-tuned module")
    ft_ckpt = trainer.checkpoint_path
    del trainer, before, inproc, pred

    # 12c: W8A8 training, row 13 in every frozen qkv, fc1 and fc2
    def plain_int8(x, w_i8, w_scale, group, w_kmajor=None, bias=None):
        return tim.fused_int8_matmul_reference(x, w_i8, w_scale, group,
                                               bias)

    def int8_fault(**kw):
        def faulty(x, w_i8, w_scale, group, w_kmajor=None, bias=None):
            y = _int8_faulty(x, w_i8, w_scale, group, **kw)
            return y if bias is None else y + bias.to(y.dtype)
        return lambda fn: _with_patch(quant, "fused_int8_matmul", faulty, fn)
    controls = {
        "int8 codes truncated": int8_fault(trunc=True),
        "int8 product scaled by 0.9": (quant, "fused_int8_matmul",
                                       lambda y: y * 0.9),
        "dW_t zeroed": (fa, "fused_apla_attn_bwd",
                        lambda out: (out[0], out[1] * 0)),
    }
    w8_cuts = copy.deepcopy(IMPORT_CUTS)
    w8_cuts["model_params"] = {"pretrained_checkpoint": paths["hub"]}
    w8_launches, w8_rates, _ = _train_phase(
        device, _subdir(tmp, "w8a8"), W8A8_RECIPE, w8_cuts, "12c w8a8 train",
        "kernel", counters, 0, controls,
        (W8A8_LOSS_TOL, W8A8_GRAD_REL_TOL), profile=True, int8=(
            tim.fused_int8_matmul,
            lambda fn: _with_patch(quant, "fused_int8_matmul", plain_int8,
                                   fn)))
    launches["fwd"] += w8_launches[0]
    launches["bwd"] += w8_launches[1]
    launches["int8"] += w8_launches[2]
    bsz = IMPORT_RECIPE["dataloader_params"]["trainloader"]["batch_size"]
    for acc in (accum, 1):
        w8, fl = w8_rates[("kernel", acc)], float_rates[("fused", acc)]
        print(f"[12c w8a8 train] b{bsz} accum {acc}: W8A8 kernel arm "
              f"{w8[0]:.1f} img/s, peak {w8[1]:.2f} GB; phase 5's float "
              f"fused arm {fl[0]:.1f} img/s, peak {fl[1]:.2f} GB")

    # 12d: serve eval on the classifier (12b), the detector (8b) and the
    # segmenter (9b), each against its loop's own evaluation of the same
    # weights
    eval_recipe, eval_params = _recipe_file(tmp, "eval", IMPORT_RECIPE,
                                            EVAL_CUTS, device, paths["hub"])
    t = time.perf_counter()
    fa.fused_apla_attn_fwd.launches = 0
    served = serve.main(["eval", art, "--params_path", eval_recipe, "--knn",
                         "--device", str(device)])
    _sync(device)
    cls_launches = fa.fused_apla_attn_fwd.launches
    launches["fwd"] += cls_launches
    trained, _, _ = _run_main(["--params_path", eval_recipe, "--test",
                               "--knn", "--pretrained_path", ft_ckpt,
                               "--device", str(device)])
    differ = {k: (v, trained.get(k)) for k, v in served.items()
              if trained.get(k) != v}
    # one call per loader batch (the bank's, the test split's): the
    # artifact answers at b64
    dl, n_eval = eval_params["dataloader_params"], \
        eval_params["dataset_params"]["synthetic_size"]
    cls_expect = cfg.depth * sum(-(-n_eval // dl[name]["batch_size"])
                                 for name in ("valloader", "testloader"))
    print(f"[12d serve eval] classifier: `serve eval --knn` in "
          f"{time.perf_counter() - t:.1f} s, row-1 launches {cls_launches} "
          f"(expected {cls_expect}): {served}; the trainer's `--test --knn` "
          f"of the checkpoint reads the same: {not differ} {differ}")
    if cls_launches != cls_expect or differ:
        raise SystemExit(f"served classifier metrics differ from the "
                         f"trainer's: {differ}")
    det = keep["det"]
    fs.fused_swin_attn_fwd.launches = 0
    served = serve.main(["eval", det["artifact"], "--det_img_dir",
                         det["img_dir"], "--det_ann", det["ann"],
                         "--device", str(device), "--num_workers", "0"])
    _sync(device)
    det_launches = fs.fused_swin_attn_fwd.launches
    launches["swin_fwd"] += det_launches
    det_calls = -(-DET_IMAGES // 16)
    print(f"[12d serve eval] detector: val_map50 {served['val_map50']} "
          f"(8b's --eval_only {det['map50']!r}), window-kernel launches "
          f"{det_launches} (expected {det['depth'] * det_calls})")
    if served["val_map50"] != round(det["map50"], 4) \
            or det_launches != det["depth"] * det_calls:
        raise SystemExit("the served detector's mAP@50 is not the loop's")
    seg = keep["seg"]
    for what, extra, want_miou, windows in (
            ("plain", [], seg["miou"], 1),
            (f"sliding at {SEG_SLIDE_SIZE}",
             ["--eval_img_size", str(SEG_SLIDE_SIZE), "--eval_stride",
              str(seg["stride"])], seg["slide_miou"], seg["windows"] ** 2)):
        fa.fused_apla_attn_fwd.launches = 0
        served = serve.main(["eval", seg["artifact"], "--seg_root",
                             seg["root"], "--device", str(device),
                             "--num_workers", "0", *extra])
        _sync(device)
        got = fa.fused_apla_attn_fwd.launches
        launches["seg_fwd"] += got
        expect = seg["depth"] * -(-SEG_VAL * windows // 8)
        print(f"[12d serve eval] segmenter {what}: val_miou "
              f"{served['val_miou']} (9b's --eval_only {want_miou!r}), "
              f"fused launches {got} (expected {expect})")
        if served["val_miou"] != round(want_miou, 4) or got != expect:
            raise SystemExit("the served segmenter's mIoU is not the "
                             "loop's")
    print(f"[12 import] phase took {time.perf_counter() - t0:.1f} s")
    return launches, w8_rates


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from apla_tpu_torch.wrapper import set_float32_precision
    set_float32_precision()         # the entry points' setting: no TF32
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs = {}

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        secs[name] = time.perf_counter() - t
        return out

    # 6b, 8b and 9b leave a checkpoint and two artifacts for phase 12
    keep_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_keep_")
    keep = {"dir": keep_dir.name}
    build_s = timed("1", phase_build)
    max_err, gemm_err, fwd_times = timed("2", phase_kernel, device)
    serve_launches, fused_rate, plain_rate = timed("3", phase_slice, device)
    bwd_err, bwd_times = timed("4", phase_bwd, device)
    (fwd_launches, bwd_launches), rates = timed("5", phase_train, device)
    proto_times = timed("6a", phase_proto_ce, device)
    ssl_launches, ssl_rates = timed("6b", phase_ssl, device, keep)
    mha_times = timed("7a", phase_mha, device)
    (full_serve_launches, full_rate, full_plain_rate), \
        ((full_fwd, full_bwd), full_rates, _) = timed("7b", phase_full,
                                                      device)
    swin_times = timed("8a", phase_swin, device)
    det_launches, det_rates = timed("8b", phase_det, device, keep)
    seg_times = timed("9a", phase_seg_kernels, device)
    seg_launches, seg_rates = timed("9b", phase_seg, device, keep)
    int8_err, int8_times = timed("10a", phase_int8, device)
    w8a8_launches, w8a8_rates = timed("10b", phase_w8a8, device)
    v1_times, v1_launches, v1_rates = timed("11", phase_ssl_v1, device)
    p12, w8_rates = timed("12", phase_import, device, rates, keep)
    keep_dir.cleanup()
    print(f"summary: build {build_s:.2f} s; serve b64 img/s fused "
          f"{fused_rate:.1f} plain {plain_rate:.1f} ({serve_launches} "
          f"forward launches); train b64 img/s " + ", ".join(
              f"{name} accum {acc} {r:.1f}"
              for (name, acc), (r, _) in sorted(rates.items()))
          + "; SSL train b64 img/s " + ", ".join(
              f"{name} {r:.1f}" for name, (r, _) in sorted(ssl_rates.items()))
          + f"; full-projection serve b64 img/s kernel {full_rate:.1f} "
          f"plain {full_plain_rate:.1f}, train b64 img/s " + ", ".join(
              f"{name} accum {acc} {r:.1f}"
              for (name, acc), (r, _) in sorted(full_rates.items()))
          + "; detector b16 img/s " + ", ".join(
              f"{what} {name} {r:.1f}"
              for (what, name), (r, _) in sorted(det_rates.items()))
          + "; segmenter b8 img/s " + ", ".join(
              f"{what} {name} {r:.2f}"
              for (what, name), (r, _) in sorted(seg_rates.items()))
          + "; W8A8 classifier b64 img/s " + ", ".join(
              f"{name} {r:.1f}" for name, r in w8a8_rates.items())
          + "; BYOL / SimSiam / DINO v1 train b64 img/s " + ", ".join(
              f"{obj} {name} {r:.1f}" for obj, arms in v1_rates.items()
              for name, (r, _) in sorted(arms.items()))
          + "; W8A8 train b64 img/s " + ", ".join(
              f"{name} accum {acc} {r:.1f}"
              for (name, acc), (r, _) in sorted(w8_rates.items()))
          + f"; whole run {time.perf_counter() - t0:.1f} s (phases: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + " s)")
    print(_gpu_line())
    main_shape = TIMED_SHAPES[0]
    # rows 1 and 5: two launches per call, the attention kernel (mha_fwd.cu)
    # and the projection GEMM written for them (apla_proj_gemm.cu)
    kernels = [
        ("fused_apla_attn_fwd", "apla_proj_gemm.cu",
         "pallas_apla_attn.py:105",
         serve_launches + fwd_launches + ssl_launches[0] + w8a8_launches[1]
         + sum(n[0] for n in v1_launches.values()) + p12["fwd"],
         {**fwd_times[FWD_TIMED[0]],
          "max_abs_err": max(max_err, v1_times["fwd"]["max_abs_err"])}),
        ("fused_apla_attn_bwd", "fused_apla_attn_bwd.cu",
         "pallas_apla_attn.py:131",
         bwd_launches + ssl_launches[1]
         + sum(n[1] for n in v1_launches.values()) + p12["bwd"],
         {**bwd_times[main_shape],
          "max_abs_err": max(bwd_err, v1_times["bwd"]["max_abs_err"])}),
        ("proto_ce_fwd", "proto_ce_fwd.cu", "pallas_proto_ce.py:73",
         ssl_launches[2], proto_times["fwd"]),
        ("proto_ce_dxs", "proto_ce_bwd.cu", "pallas_proto_ce.py:130",
         ssl_launches[3], proto_times["dxs"]),
        ("proto_ce_dws", "proto_ce_bwd.cu", "pallas_proto_ce.py:150",
         ssl_launches[4], proto_times["dws"]),
        ("mha_fwd", "mha_fwd.cu", "pallas_mha.py:66",
         full_serve_launches + full_fwd, mha_times["fwd"]),
        ("mha_bwd", "mha_bwd.cu", "pallas_mha.py:81", full_bwd,
         mha_times["bwd"]),
        # row 3: two launches per call, a head-dim-32 attention and the
        # projection GEMM (gemm_sm90.cuh), both in swin_attn_fwd.cu
        ("fused_swin_attn_fwd", "swin_attn_fwd.cu",
         "pallas_apla_attn.py:197", det_launches[0] + p12["swin_fwd"],
         swin_times["fwd"]),
        # row 4: three launches per call, the dO GEMM, a head-dim-32
        # attention and the dW GEMM with its reduce, all in swin_attn_bwd.cu
        ("fused_swin_attn_bwd", "swin_attn_bwd.cu",
         "pallas_apla_attn.py:203", det_launches[1], swin_times["bwd"]),
        # rows 1/2's kernels where JAX names the q-strip long kernels (TPU
        # rows 5-7): ViT-L/16 at 512, k = C = 1024, on the seg path
        ("fused_apla_attn_fwd_seg", "apla_proj_gemm.cu",
         "pallas_apla_attn_long.py:110", seg_launches[0] + p12["seg_fwd"],
         seg_times["fwd"]),
        ("fused_apla_attn_bwd_seg", "fused_apla_attn_bwd.cu",
         "pallas_apla_attn_long.py:141", seg_launches[1], seg_times["bwd"]),
        # the W8A8 serving path's qkv / fc1 / fc2 (groups = K) in the
        # classifier (10b), the detector (8b) and the segmenter (9b), and
        # W8A8 training's (12c)
        ("int8_matmul", "int8_matmul.cu", "pallas_int8_matmul.py:33",
         w8a8_launches[0] + det_launches[2] + seg_launches[2] + p12["int8"],
         {**int8_times[INT8_MAIN], "max_abs_err": int8_err}),
    ]
    # library_ms: F.scaled_dot_product_attention (autograd through it for
    # the backward) computes the mha kernels' function (the forward's
    # graph_ms and library_graph_ms: both from CUDA graphs, and its times
    # at every MHA_TIMED shape); no single PyTorch
    # call computes the others, and the fused attention and window kernels'
    # two-call yardstick (SDPA, then the projection) is reported beside
    # them; for the fused forward also its two launches apart and
    # torch.matmul on the GEMM's operands (gemm_library_ms).  For the int8
    # GEMM, library_ms is torch._int_mm, the int8 product alone (no
    # quantization, no scales), and the bf16 torch.matmul with the
    # dequantized weight is reported beside it
    from apla_tpu_torch.ops import apla_proj_gemm, mha
    from apla_tpu_torch.ops.fused_apla_attn import _BWD_SOURCE

    def fused_fwd(t):
        return {"sources": [f"apla_tpu_torch/csrc/{src}" for src in
                            (mha.FWD_SOURCE, apla_proj_gemm.SOURCE)],
                "redesigned": "PR 9",
                **{k: t[k] for k in (
                    "graph_ms", "host_ms", "attention_ms",
                    "attention_graph_ms", "gemm_ms", "gemm_graph_ms",
                    "gemm_library_ms", "gemm_bound_ms",
                    "library_two_calls_graph_ms")}}

    def _launch_ms(t):
        return {name: {k: v for k, v in part.items() if k != "bound_by"}
                for name, part in t["parts"].items()}

    # rows 2, 6-7 and 9: the attention backward's two launches
    # (attn_bwd_sm90.cuh), and the fused backward's two GEMMs
    # (gemm_sm90.cuh), each launch timed apart
    def bwd_extra(t, fused):
        srcs = ((_BWD_SOURCE, "attn_bwd_sm90.cuh", "gemm_sm90.cuh")
                if fused else (mha.BWD_SOURCE, "attn_bwd_sm90.cuh"))
        return {"sources": [f"apla_tpu_torch/csrc/{src}" for src in srcs],
                "redesigned": "PR 10", "graph_ms": t["graph_ms"],
                "launches_ms": _launch_ms(t)}

    extra = {"fused_apla_attn_fwd": {
                 **fused_fwd(fwd_times[FWD_TIMED[0]]),
                 "gemm_max_abs_err": gemm_err,
                 "by_shape": [{"shape": [b, n, 2304], **{
                     k: t[k] for k in ("ms", "graph_ms", "host_ms",
                                       "attention_graph_ms", "gemm_graph_ms",
                                       "library_two_calls_graph_ms",
                                       "bound_ms")}}
                     for (b, n), t in list(fwd_times.items())
                     + [(V1_KERNEL_SHAPE[:2], v1_times["fwd"])]],
                 "launches_by_objective": {
                     obj: n[0] for obj, n in v1_launches.items()}},
             "fused_apla_attn_fwd_seg": fused_fwd(seg_times["fwd"]),
             "proto_ce_fwd": {
                 "sources": [f"apla_tpu_torch/csrc/{src}" for src in (
                     "proto_ce_fwd.cu", "proto_ce_sm90.cuh",
                     "sm90_async.cuh")],
                 "redesigned": "TMA/wgmma, the rows in registers as the "
                               "logits' A operand",
                 "library_calls_is": "two bf16 torch.matmul, logsumexp and "
                                     "the softmax-weighted sum in f32 (not "
                                     "the kernel's bits)",
                 **{k: proto_times["fwd"][k] for k in (
                     "graph_ms", "groups1_graph_ms", "groups2_graph_ms",
                     "groups1_l2_tb_s", "groups2_l2_tb_s",
                     "library_calls_graph_ms")}},
             **{name: {"sources": [f"apla_tpu_torch/csrc/{src}" for src in (
                 "proto_ce_bwd.cu", "proto_ce_sm90.cuh", "sm90_async.cuh")],
                 **{k: proto_times[name.removeprefix("proto_ce_")][k]
                    for k in ("graph_ms", "groups1_ms", "groups2_ms",
                              "collate")}}
                for name in ("proto_ce_dxs", "proto_ce_dws")},
             "fused_swin_attn_fwd": {
                 "sources": [f"apla_tpu_torch/csrc/{src}" for src in (
                     "swin_attn_fwd.cu", "swin_sm90.cuh", "attn_fwd_sm90.cuh",
                     "gemm_sm90.cuh", "sm90_async.cuh")],
                 "redesigned": "TMA/wgmma attention, then the projection GEMM",
                 **{k: swin_times["fwd"][k] for k in (
                     "graph_ms", "host_ms", "attention_ms",
                     "attention_graph_ms", "attention_bound_ms",
                     "projection_ms", "projection_graph_ms",
                     "projection_bound_ms", "library_two_calls_graph_ms",
                     "attention_max_abs_err")},
                 "by_shape": [{"stage": stage, **{k: t[k] for k in (
                     "ms", "graph_ms", "host_ms", "attention_graph_ms",
                     "projection_graph_ms", "library_two_calls_ms",
                     "library_two_calls_graph_ms", "bound_ms")}}
                     for (stage, name), t in (
                         kv for kv in swin_times.items()
                         if isinstance(kv[0], tuple))
                     if name == "fwd"],
                 "served_b1": swin_times["fwd_served"]},
             "fused_swin_attn_bwd": {
                 "sources": [f"apla_tpu_torch/csrc/{src}" for src in (
                     "swin_attn_bwd.cu", "swin_sm90.cuh", "gemm_sm90.cuh",
                     "sm90_async.cuh")],
                 "redesigned": "PR 15",
                 "graph_ms": swin_times["bwd"]["graph_ms"],
                 "host_ms": swin_times["bwd"]["host_ms"],
                 "launches_ms": _launch_ms(swin_times["bwd"]),
                 "by_shape": [{"stage": stage, **{k: t[k] for k in (
                     "ms", "graph_ms", "host_ms", "library_two_calls_ms",
                     "bound_ms")}, "launches_ms": _launch_ms(t)}
                     for (stage, name), t in (
                         kv for kv in swin_times.items()
                         if isinstance(kv[0], tuple))
                     if name == "bwd"]},
             "mha_fwd": {
                 "redesigned": "PR 8",
                 "graph_ms": mha_times["fwd"]["graph_ms"],
                 "library_graph_ms": mha_times["fwd"]["library_graph_ms"],
                 "by_shape": [{
                     "shape": [b, n, 2304],
                     **{k: t[k] for k in ("ms", "graph_ms", "host_ms",
                                          "library_ms", "library_graph_ms",
                                          "bound_ms")}}
                     for (_, b, n), t in mha_times["fwd_by_shape"].items()]},
             "fused_apla_attn_bwd": {
                 **bwd_extra(bwd_times[main_shape], fused=True),
                 "by_shape": [{"shape": [b, n, 2304], **{
                     k: t[k] for k in ("ms", "graph_ms", "bound_ms",
                                       "library_two_calls_ms")},
                     "launches_ms": _launch_ms(t)}
                     for (b, n), t in list(bwd_times.items())
                     + [(V1_KERNEL_SHAPE[:2], v1_times["bwd"])]],
                 "launches_by_objective": {
                     obj: n[1] for obj, n in v1_launches.items()}},
             "fused_apla_attn_bwd_seg": {
                 **bwd_extra(seg_times["bwd"], fused=True),
                 "by_shape": [{"shape": [SEG_KERNEL_CASES[0][0],
                                         SEG_KERNEL_CASES[0][1],
                                         3 * SEG_KERNEL_CASES[0][2]],
                               **{k: seg_times["bwd"][k] for k in (
                                   "ms", "graph_ms", "bound_ms",
                                   "library_two_calls_ms")}}],
                 "also_replaces": "apla_tpu/ops/pallas_apla_attn_long.py:191"},
             "mha_bwd": {
                 **bwd_extra(mha_times["bwd"], fused=False),
                 "by_shape": [{"shape": [b, n, 2304], **{
                     k: t[k] for k in ("ms", "graph_ms", "library_ms",
                                       "bound_ms")},
                     "launches_ms": _launch_ms(t)}
                     for (_, b, n), t in mha_times["bwd_by_shape"].items()]},
             "int8_matmul": {
                 "sources": [f"apla_tpu_torch/csrc/{src}" for src in (
                     "int8_matmul.cu", "gemm_s8_sm90.cuh")],
                 "also_replaces": "apla_tpu/ops/quant.py:44 (the XLA "
                                  "dot_general of _int8_forward, at "
                                  "groups = K, and the bias add after it)",
                 "library_is": "torch._int_mm (the int8 product alone)",
                 **{k: int8_times[INT8_MAIN][k] for k in (
                     "graph_ms", "host_ms")},
                 "by_shape": [{"shape": name, **{k: t[k] for k in (
                     "ms", "graph_ms", "host_ms", "library_ms",
                     "library_matmul_ms", "bound_ms")}}
                     for name, t in int8_times.items()]}}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"apla_tpu_torch/csrc/{src}",
        "replaces": f"apla_tpu/ops/{tpu}",
        "launches": launches,
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t.get("library_ms"),
        **({"library_two_calls_ms": t["library_two_calls_ms"]}
           if "library_two_calls_ms" in t else {}),
        **({"library_matmul_ms": t["library_matmul_ms"]}
           if "library_matmul_ms" in t else {}),
        **extra.get(name, {}),
    } for name, src, tpu, launches, t in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
