"""`apla_tpu_torch` imports no jax, flax or optax, and none of the packages
the card's machine lacks (PIL, sklearn, yaml, pandas, wandb: the run
logger imports wandb inside `RunLogger.__init__` alone, when `log_params`
asks for a wandb run, and a failed import means no wandb run).

A fresh interpreter with a `sys.meta_path` blocker on those packages imports
every module of the port, runs a tiny APLA classifier forward through the
fused path, round-trips it through a serving artifact, float and W8A8, runs a tiny APLA
"full" classifier forward and backward through the memory-efficient
attention (`ops.mha`), takes one training step (device augmentation, mixup
targets, accumulation) through `make_train_step`, runs the SSL pieces:
device multi-crop with blur and solarize, the iBOT mask collate, the DINO
head and the prototype CE with its backward, and drives the detection
side-car: PNGs written and read, the APLA-Swin detector trained through
the fused window path, checkpointed, exported (float and W8A8) and
served, and the
segmentation side-car: an ADE20K-layout set written and read, the SETR-PUP
segmenter trained through the fused APLA path with aux heads, checkpointed,
exported and served; and decodes the committed JPEG fixtures with the
port's own decoder and reads an ImageNet tree of them through the recipe's
host transforms and the raw path; decodes the committed PNG fixtures with
the native PNG decoder against their manifest; reads NABirds and ISIC2019
trees (CSV tables, no pandas) and a VTAB tree of PNGs.  A second
interpreter, under the same blocker, drives the detector's mask branch
(polygon and RLE masks, the loop with `masks=True`, a mask export served
float and W8A8, `serve eval`'s mask mAP), the multi-label and LAMB
pieces (`SyntheticMultiLabel`, the multi-label metrics, multi-label kNN,
LAMB steps, the step timer), and the host transforms (a seventh of the
transform manifest's cases through the native ops and their plain
versions, by `chip_smoke.py`'s own loop) and the host multi-crop (the dino strategy through the loader's
collate), and a classifier under FSDP, on a model axis and through a
pipeline of two stages, on two ranks spawned by the port's
launcher, whose rank imports none of the blocked packages and nothing of
the JAX package either.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, importlib.abc, importlib.machinery, pkgutil, sys, tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "PIL", "sklearn", "yaml",
           "pandas", "wandb")


# Fails every import of a blocked package, as if it were not there (a
# find_spec probe, which torch makes for optional packages, still gets a
# spec and goes on).
class Absent(importlib.abc.Loader):
    def create_module(self, spec):
        raise ModuleNotFoundError(f"blocked import of {spec.name}")

    def exec_module(self, module):
        pass


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, Absent())
        return None


sys.meta_path.insert(0, Blocker())
# -- end of the blocker --

import numpy as np
import torch
import apla_tpu_torch

names = [m.name for m in pkgutil.walk_packages(apla_tpu_torch.__path__,
                                               "apla_tpu_torch.")]
for name in names:
    importlib.import_module(name)

from apla_tpu_torch.apla.core import AplaConfig
from apla_tpu_torch.models.classifier import classifier_forward, init_classifier
from apla_tpu_torch.models.vit import ViTConfig
from apla_tpu_torch.serve import export_classifier, load_predictor

cfg = ViTConfig(img_size=32, patch_size=8, embed_dim=128, depth=2,
                num_heads=2, has_layerscale=True, use_fused_apla=True)
model = init_classifier(cfg, 10, AplaConfig(partial_size=16),
                        generator=torch.Generator().manual_seed(0),
                        device=torch.device("cpu"))
x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
with torch.no_grad():
    logits = classifier_forward(model, torch.from_numpy(x), cfg)
assert logits.shape == (3, 10) and torch.isfinite(logits.float()).all()
with tempfile.TemporaryDirectory() as tmp:
    export_classifier(tmp, model, cfg, batch_sizes=(1, 2))
    served = load_predictor(tmp, "cpu").predict(x)
assert np.array_equal(served, logits.float().numpy())
# W8A8: int8 frozen qkv / fc1 / fc2 kernels, the int8 kernel's plain version
with tempfile.TemporaryDirectory() as tmp:
    export_classifier(tmp, model, cfg, batch_sizes=(1, 2),
                      quantize_frozen=True)
    q_served = load_predictor(tmp, "cpu").predict(x)
assert q_served.shape == (3, 10) and np.isfinite(q_served).all()

# APLA "full" on the memory-efficient attention path (ops.mha), forward and
# backward
full_cfg = ViTConfig(img_size=32, patch_size=8, embed_dim=128, depth=2,
                     num_heads=2, use_flash=True)
full = init_classifier(full_cfg, 10, AplaConfig(partial_size="full"),
                       generator=torch.Generator().manual_seed(0),
                       device=torch.device("cpu"))
classifier_forward(full, torch.from_numpy(x), full_cfg).float().sum().backward()
assert all(torch.isfinite(b.attn.proj.kernel.grad).all()
           for b in full.backbone.blocks)

from apla_tpu_torch.data.device_augs import DeviceAugConfig
from apla_tpu_torch.train.losses import cross_entropy
from apla_tpu_torch.train.optim import build_optimizer
from apla_tpu_torch.train.steps import make_train_step
from apla_tpu_torch.train.train_state import TrainState

opt = build_optimizer("AdamW", {"lr": 1e-3, "weight_decay": 1e-5},
                      [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad], grad_clip=1.0)
step = make_train_step(cfg, opt, cross_entropy,
                       device_aug_cfg=DeviceAugConfig(out_size=32),
                       accum_steps=2)
before = model.fc.kernel.detach().clone()
batch = {"image": torch.randint(0, 256, (4, 40, 40, 3), dtype=torch.uint8),
         "label": torch.softmax(torch.randn(4, 10), -1)}
state, m = step(TrainState(0, model, opt), batch, 1e-3,
                torch.Generator().manual_seed(0))
assert state.step == 1 and torch.isfinite(m["loss"])
assert not torch.equal(model.fc.kernel, before)

from apla_tpu_torch.data.device_augs import (crop_cfgs_from_strategy,
                                             device_multicrop)
from apla_tpu_torch.ops.proto_ce import proto_ce
from apla_tpu_torch.ssl.dinov2 import IBotCollate, MaskingGenerator
from apla_tpu_torch.ssl.heads import (dino_head_bottleneck, dino_head_last_w,
                                      init_dino_head)
from apla_tpu_torch.ssl.multicrop import STRATEGIES

cfgs = crop_cfgs_from_strategy(STRATEGIES["dinov2"], (0.5,) * 3, (0.25,) * 3,
                               g_size=32, l_size=16)
raw = torch.randint(0, 256, (2, 36, 36, 3), dtype=torch.uint8)
g_crops, l_crops = device_multicrop(raw, torch.Generator().manual_seed(0),
                                    cfgs, 2, torch.float32)
assert g_crops.shape == (4, 32, 32, 3) and l_crops.shape == (16, 16, 16, 3)
collate = IBotCollate(2, 8, (0.1, 0.5), 0.5, 16,
                      MaskingGenerator((4, 4), max_num_patches=8),
                      raw_mode=True, seed=0, batches_per_epoch=1)
out = collate([{"image": raw[i].numpy(), "label": i} for i in range(2)],
              batch_key=(0, 0))
assert out["collated_masks"].shape == (4, 16)
head = init_dino_head(128, 64, hidden_dim=32, bottleneck_dim=16,
                      generator=torch.Generator().manual_seed(0))
emb = torch.randn(5, 128, requires_grad=True)
xs = dino_head_bottleneck(emb, head)
ce = proto_ce(xs, dino_head_last_w(head, False), xs.detach(),
              dino_head_last_w(head), torch.zeros(64), 0.05, 0.1)
ce.sum().backward()
assert torch.isfinite(emb.grad).all() and head.last_v.grad is not None
# the detection side-car: a synthetic COCO set written and read without
# PIL, the APLA-Swin detector trained through the fused window path (plain
# versions on the CPU), checkpointed, exported and served
import json, os
from apla_tpu_torch.data.detection_data import write_png
from apla_tpu_torch.segdet import load_checkpoint, swin_config, train_detection
from apla_tpu_torch.serve import (DetPredictor, detector_from_state,
                                  export_detector)

with tempfile.TemporaryDirectory() as tmp:
    os.makedirs(os.path.join(tmp, "imgs"))
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(os.path.join(tmp, "imgs", f"{i}.png"),
                  rng.integers(0, 256, (60, 70, 3), dtype=np.uint8))
    with open(os.path.join(tmp, "ann.json"), "w") as f:
        json.dump({"images": [{"id": i, "file_name": f"{i}.png"}
                              for i in range(2)],
                   "annotations": [{"id": 1, "image_id": 0, "category_id": 5,
                                    "bbox": [5, 5, 30, 20]}],
                   "categories": [{"id": 5}]}, f)
    out = train_detection(os.path.join(tmp, "imgs"),
                          os.path.join(tmp, "ann.json"), epochs=1,
                          img_size=56, batch_size=2, embed_dim=32,
                          depths=(2, 2), num_heads=(1, 2), num_workers=0,
                          save_dir=os.path.join(tmp, "ck"), use_fused=True,
                          bf16=True, device="cpu")
    assert out["iters"] == 1
    ckpt = load_checkpoint(os.path.join(tmp, "ck", "det_best.pt"))
    cfg = swin_config(56, 32, (2, 2), (1, 2), 7, bf16=True, use_fused=True)
    det = detector_from_state(cfg, 1, ckpt["trainable"], ckpt["frozen"],
                              torch.device("cpu"))
    export_detector(os.path.join(tmp, "art"), det, cfg, (4, 8), (1, 2))
    pred = load_predictor(os.path.join(tmp, "art"), "cpu")
    assert isinstance(pred, DetPredictor)
    assert len(pred.detect(np.zeros((3, 56, 56, 3), np.float32))) == 3
    export_detector(os.path.join(tmp, "qart"), det, cfg, (4, 8), (1, 2),
                    quantize_frozen=True)
    pred = load_predictor(os.path.join(tmp, "qart"), "cpu")
    assert pred.meta["quantized_frozen"] is True
    assert len(pred.detect(np.zeros((2, 56, 56, 3), np.float32))) == 2

# the segmentation side-car: an ADE20K-layout set (PNG content under .jpg
# names) read without PIL, the SETR-PUP segmenter trained through the fused
# APLA path at k = C (plain versions on the CPU) with aux heads, checkpointed,
# exported and served, plain and sliding-window
from apla_tpu_torch.segdet import seg_vit_config, train_segmentation
from apla_tpu_torch.serve import (SegPredictor, export_segmenter,
                                  segmenter_from_state)

with tempfile.TemporaryDirectory() as tmp:
    rng = np.random.default_rng(0)
    for split in ("training", "validation"):
        os.makedirs(os.path.join(tmp, "images", split))
        os.makedirs(os.path.join(tmp, "annotations", split))
        for i in range(2):
            write_png(os.path.join(tmp, "images", split, f"{i}.jpg"),
                      rng.integers(0, 256, (40, 30, 3), dtype=np.uint8))
            write_png(os.path.join(tmp, "annotations", split, f"{i}.png"),
                      rng.integers(0, 151, (40, 30), dtype=np.uint8))
    out = train_segmentation(tmp, epochs=1, img_size=32, patch_size=16,
                             backbone="vit_tiny", batch_size=2, channels=8,
                             aux_heads=3, head_lr_mult=10.0, use_fused=True,
                             num_workers=0, save_dir=os.path.join(tmp, "ck"),
                             device="cpu")
    assert out["iters"] == 1
    ckpt = load_checkpoint(os.path.join(tmp, "ck", "seg_best.pt"))
    cfg = seg_vit_config("vit_tiny", 32, 16, use_fused=True)
    seg = segmenter_from_state(cfg, ckpt["trainable"], ckpt["frozen"],
                               torch.device("cpu"))
    export_segmenter(os.path.join(tmp, "segart"), seg, cfg, (1, 2))
    pred = load_predictor(os.path.join(tmp, "segart"), "cpu")
    assert isinstance(pred, SegPredictor)
    assert pred.masks(np.zeros((3, 32, 32, 3), np.float32)).shape == (3, 32,
                                                                      32)
    assert pred.predict_slide(np.zeros((1, 40, 48, 3), np.float32)).shape \
        == (1, 40, 48, 150)

# the JPEG fixtures through the port's own decoder, and an ImageNet tree of
# them through the recipe's host transforms and the raw path
import json
import shutil
from apla_tpu_torch.data.datasets import ImageNet
from apla_tpu_torch.data.detection_data import read_image

fixtures = os.path.join("tests", "data", "jpeg")
with open(os.path.join(fixtures, "manifest.json")) as f:
    manifest = json.load(f)["files"]
for name, entry in manifest.items():
    img = read_image(os.path.join(fixtures, name))
    assert img.shape == (entry["height"], entry["width"], 3), name
with tempfile.TemporaryDirectory() as tmp:
    for split in ("train", "val"):
        d = os.path.join(tmp, "ImageNet", split, "n0")
        os.makedirs(d)
        for name in sorted(manifest)[:3]:
            shutil.copy(os.path.join(fixtures, name),
                        os.path.join(d, name.split(".")[0] + ".JPEG"))
    tt = {"Resize": {"apply": True, "height": 40, "width": 40},
          "RandomResizedCrop": {"apply": True, "size": 32,
                                "scale": [0.8, 1.2]},
          "ColorJitter": {"apply": True, "brightness": 0.2, "contrast": 0.2,
                          "saturation": 0.1, "hue": 0.1, "p": 1.0},
          "Normalize": True}
    ds = ImageNet({"data_location": tmp, "train_transforms": tt}, "train")
    sample = ds.__getitem__(0, rng=np.random.default_rng(0))["image"]
    assert sample.shape == (32, 32, 3) and np.isfinite(sample).all()
    ds.raw_mode, ds.raw_size = True, 48
    assert ds[1]["image"].shape == (48, 48, 3)

# the PNG fixtures through the native decoder against their manifest, and
# the shipped recipes' datasets (NABirds, ISIC2019: CSV tables) and a VTAB
# task (PNGs) read from trees of the fixtures
import hashlib
from apla_tpu_torch.data.datasets import get_dataset_class
from apla_tpu_torch.data.detection_data import read_png


def sha(a):
    if a.dtype == bool:
        a = a.astype(np.uint8)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


pngs = os.path.join("tests", "data", "png")
with open(os.path.join(pngs, "manifest.json")) as f:
    png_manifest = json.load(f)["files"]
for name, entry in png_manifest.items():
    path = os.path.join(pngs, name)
    assert sha(read_image(path)) == entry["full"], name
    assert sha(read_png(path, raw=True)) == entry["raw"], name
jpegs = sorted(manifest)[:4]
with tempfile.TemporaryDirectory() as tmp:
    nab = os.path.join(tmp, "NABirds")
    os.makedirs(os.path.join(nab, "images", "0010"))
    ids = [f"id-{i}" for i in range(4)]
    with open(os.path.join(nab, "data_info.csv"), "w") as f:
        f.write("image_id,imagepath,class_id\n")
        for i, name in enumerate(jpegs):
            shutil.copy(os.path.join(fixtures, name),
                        os.path.join(nab, "images", "0010", f"{i}.jpg"))
            f.write(f"{ids[i]},0010/{i}.jpg,{(10, 2)[i % 2]}\n")
    for split, part in (("train", ids[:2]), ("val", ids[2:3]),
                        ("test", ids[3:])):
        with open(os.path.join(nab, f"{split}_image_ids.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    isic = os.path.join(tmp, "ISIC2019")
    os.makedirs(os.path.join(isic, "train"))
    with open(os.path.join(isic, "ISIC_2019_Training_GroundTruth.csv"),
              "w") as f:
        f.write("image,MEL,NV,BCC,AK,BKL,DF,VASC,SCC,UNK\n")
        for i in range(10):
            shutil.copy(os.path.join(fixtures, jpegs[i % 4]),
                        os.path.join(isic, "train", f"ISIC_{i:07d}.jpg"))
            hot = ["0.0"] * 9
            hot[i % 8] = "1.0"
            f.write(f"ISIC_{i:07d}," + ",".join(hot) + "\n")
    for split in ("train", "val", "test"):
        d = os.path.join(tmp, "VTAB_oxford_flowers102", split)
        os.makedirs(d)
        for i, name in enumerate(sorted(png_manifest)[:3]):
            shutil.copy(os.path.join(pngs, name),
                        os.path.join(d, f"img_{i}-label_{i}.png"))
    tt = {"Resize": {"apply": True, "height": 40, "width": 40},
          "CenterCrop": {"apply": True, "height": 32, "width": 32},
          "Normalize": True}
    params = {"data_location": tmp, "train_transforms": tt,
              "val_transforms": tt, "test_transforms": tt}
    nabirds = get_dataset_class("NABirds")(params, "train")
    assert [r["label"] for r in nabirds.data] == [0, 1]   # "10" < "2"
    isic_sets = [get_dataset_class("ISIC2019")(params, m)
                 for m in ("train", "val", "test")]
    assert [len(d) for d in isic_sets] == [8, 1, 1]
    vtab = get_dataset_class("VTAB_flowers")(params, "test")
    for ds in (nabirds, isic_sets[0], vtab):
        sample = ds.__getitem__(0, rng=np.random.default_rng(0))["image"]
        assert sample.shape == (32, 32, 3) and np.isfinite(sample).all()
        ds.raw_mode, ds.raw_size = True, 24
        assert ds[len(ds) - 1]["image"].shape == (24, 24, 3)

leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("MODULES", len(names))
"""


_HEADER = _SCRIPT.split("# -- end of the blocker --")[0]

_SCRIPT_MASKS_MULTILABEL = _HEADER + r"""
import json, os, tempfile
import numpy as np
import torch
from apla_tpu_torch import serve
from apla_tpu_torch.data.detection_data import (polygons_to_mask,
                                                rle_to_mask, write_png)
from apla_tpu_torch.segdet import train_detection

m = polygons_to_mask([[1.5, 1.5, 9.2, 2.0, 5.0, 8.7]], 12, 12)
assert m.dtype == np.uint8 and 0 < m.sum() < 60
assert rle_to_mask({"size": [3, 4], "counts": "12:0"}).shape == (3, 4)
with tempfile.TemporaryDirectory() as tmp:
    os.makedirs(os.path.join(tmp, "imgs"))
    rng = np.random.default_rng(0)
    segs = [[[5, 5, 35, 5, 20, 25]], {"size": [60, 70], "counts": [400, 300]},
            {"size": [60, 70], "counts": "n71Qc0"}, None]
    anns = []
    for i in range(4):
        write_png(os.path.join(tmp, "imgs", f"{i}.png"),
                  rng.integers(0, 256, (60, 70, 3), dtype=np.uint8))
        ann = {"id": i + 1, "image_id": i, "category_id": 5,
               "bbox": [5, 5, 30, 20]}
        if segs[i] is not None:
            ann["segmentation"] = segs[i]
        anns.append(ann)
    ann_file = os.path.join(tmp, "ann.json")
    with open(ann_file, "w") as f:
        json.dump({"images": [{"id": i, "file_name": f"{i}.png"}
                              for i in range(4)],
                   "annotations": anns, "categories": [{"id": 5}]}, f)
    ck = os.path.join(tmp, "ck")
    out = train_detection(os.path.join(tmp, "imgs"), ann_file, epochs=1,
                          img_size=56, batch_size=2, embed_dim=32,
                          depths=(2, 2), num_heads=(1, 2), num_workers=0,
                          save_dir=ck, use_fused=True, bf16=True,
                          masks=True, n_protos=4, device="cpu")
    assert out["iters"] == 2 and "best_mask_map50" in out
    for extra in ([], ["--quantize_frozen"]):
        art = os.path.join(tmp, "art" + "".join(extra))
        serve.main(["export_det", "--ckpt", os.path.join(ck, "det_best.pt"),
                    "--img_size", "56", "--embed_dim", "32", "--depths",
                    "2,2", "--num_heads", "1,2", "--out", art] + extra)
        pred = serve.load_predictor(art, "cpu")
        dets = pred.detect(np.zeros((2, 56, 56, 3), np.float32),
                           score_thresh=0.0, top_k=3)
        assert [d[3].shape for d in dets] == [(3, 14, 14)] * 2
        res = serve.main(["eval", art, "--det_img_dir",
                          os.path.join(tmp, "imgs"), "--det_ann", ann_file,
                          "--device", "cpu", "--num_workers", "0"])
        assert set(res) == {"val_map50", "val_mask_map50"}

# multi-label: the dataset, the metrics, the kNN vote; LAMB; the step timer
from apla_tpu_torch.data.datasets import get_dataset_class
from apla_tpu_torch.train.knn import knn_evaluate
from apla_tpu_torch.train.metrics import MultiLabelClassificationMetrics
from apla_tpu_torch.train.optim import build_optimizer, global_norm
from apla_tpu_torch.utils.profiling import StepTimer, device_memory_stats

ds = get_dataset_class("SyntheticMultiLabel")(
    {"data_location": "/nonexistent", "synthetic_size": 16,
     "synthetic_classes": 4, "val_transforms": {"Normalize": True}}, "val")
labels = np.stack([r["label"] for r in ds.data])
assert labels.shape == (16, 4) and (labels.sum(1) == 2).all()
metric = MultiLabelClassificationMetrics(4, mode="val")
metric.add_preds(rng.standard_normal((16, 4)), labels)
values = metric.get_values()
assert set(values) == {"val_accuracy", "val_mAP", "val_precision",
                       "val_recall", "val_f1", "val_roc_auc"}
batches = [{"image": torch.tensor(rng.standard_normal((8, 6)),
                                  dtype=torch.float32),
            "label": torch.tensor(labels[i:i + 8])} for i in (0, 8)]
knn = knn_evaluate(lambda x: torch.nn.functional.normalize(x, dim=-1),
                   batches, batches,
                   MultiLabelClassificationMetrics(4, mode="knn_val"), 4, 5,
                   0.1, torch.device("cpu"))
assert knn["knn_val_mAP"] == 1.0
named = [("backbone.blocks.0.attn.proj_wt", torch.nn.Parameter(
             torch.randn(6, 2))),
         ("backbone.blocks.1.attn.proj_wt", torch.nn.Parameter(
             torch.randn(6, 2))),
         ("fc.bias", torch.nn.Parameter(torch.zeros(4)))]
opt = build_optimizer("LAMB", {"lr": 1e-2, "weight_decay": 0.1}, named,
                      grad_clip=1.0)
assert len(opt.opt.leaves) == 2
timer = StepTimer(sync_every=2, skip_first=0)
for _ in range(3):
    for _, p in named:
        p.grad = torch.randn_like(p)
    opt.step(global_norm([p.grad for _, p in named]))
    timer.tick(sync_value=torch.tensor(1.0))
assert named[2][1].abs().sum() > 0 and len(timer.summary()) == 4
assert device_memory_stats("cpu") == {}

# the host transforms against their manifest, through the native ops and
# their plain versions; the host multi-crop (the dino strategy) through the
# loader's collate into one batch per crop
import chip_smoke
from apla_tpu_torch.data.loader import DataLoader
from apla_tpu_torch.ssl.multicrop import apply_augmentation_strategy
from apla_tpu_torch.utils.config import EDict

_, bad, _ = chip_smoke._transform_manifest_cases(every=7)
assert not bad, bad
params = EDict({"dataset_params": {
    "dataset": "Synthetic", "synthetic_size": 4, "synthetic_img_size": 32,
    "ssl_global_size": 32, "ssl_local_size": 16,
    "train_transforms": {"Resize": {"apply": True, "height": 32,
                                    "width": 32}, "Normalize": True}}})
params = apply_augmentation_strategy(params, "dino")
crops = get_dataset_class("Synthetic")(params.dataset_params, "train")
views = next(iter(DataLoader(crops, batch_size=2, num_workers=0)))["image"]
assert [tuple(v.shape) for v in views] == \
    [(2, 32, 32, 3)] * 2 + [(2, 16, 16, 3)] * 8
assert all(v.dtype == torch.float32 for v in views)

# data parallel: a classifier under fsdp on two gloo ranks spawned by the
# launcher; a spawned rank imports none of the blocked packages either, nor
# the JAX package
import numpy as np
from apla_tpu_torch.parallel import launch, runs

names = launch.launch(runs.loaded_modules, 2, device="cpu")
assert "apla_tpu_torch.parallel.runs" in names
assert not [m for m in names if m.split(".")[0] in BLOCKED + ("apla_tpu",)]
spec = dict(vit=dict(img_size=32, patch_size=8, embed_dim=32, depth=2,
                     num_heads=2), n_classes=10, partial_size=4,
            device="cpu", policy="fsdp", min_size=1024,
            batches=[{"image": np.zeros((4, 32, 32, 3), np.float32),
                      "label": np.arange(4)}])
run = launch.launch(runs.classifier_run, 2, args=(spec,), device="cpu")
assert run["world"] == 2 and run["plan"] and np.isfinite(run["losses"]).all()
# the model axis: tensor and sequence parallelism, W8A8 at T = 2
from apla_tpu_torch.parallel import tensor  # noqa: F401
for extra in (dict(tensor_parallel=2, sequence_parallel=True),
              dict(tensor_parallel=2, quantize=True)):
    run = launch.launch(runs.classifier_run, 2, args=(
        dict(spec, policy="tp", **extra),), device="cpu")
    assert run["n_model"] == 2 and run["counts"][0]["model"] > 0
    assert np.isfinite(run["losses"]).all()
# the pipeline: two stages of one block each, two microbatches
from apla_tpu_torch.parallel import pipeline  # noqa: F401
run = launch.launch(runs.classifier_run, 2, args=(
    dict(spec, policy="pp", pipeline_parallel=2, pp_microbatches=2),),
    device="cpu")
assert run["n_model"] == 2 and run["counts"][0]["pipeline"] > 0
assert set(run["plan"].values()) == {0, 1}
assert np.isfinite(run["losses"]).all()

leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("OK")
"""


_SCRIPT_FORMATS = _HEADER + r"""
import json, os, shutil, tempfile
import numpy as np
import torch
from apla_tpu_torch.data import image_formats as imf
from apla_tpu_torch.data.datasets import ImageNet
from apla_tpu_torch.models.vit import VIT_BUILDERS
from apla_tpu_torch.utils import flops
from apla_tpu_torch.utils.logging import RunLogger

# the BMP, GIF and TIFF fixtures through the native decoders, RGB, L and
# RGBA against their manifests
import hashlib
def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
n = 0
for kind in ("bmp", "gif", "tiff"):
    d = os.path.join("tests", "data", kind)
    files = json.load(open(os.path.join(d, "manifest.json")))["files"]
    for name, rec in files.items():
        if "refused" in rec:
            continue
        data = open(os.path.join(d, name), "rb").read()
        for key, mode in (("rgb", "RGB"), ("l", "L"), ("rgba", "RGBA")):
            assert sha(imf.decode_image(data, mode)) == rec[key], name
        n += 1
assert n > 50, n

# a grey ImageNet tree of every format through the recipe's host
# transforms (L broadcast to three bands) and the raw path (2-D)
with tempfile.TemporaryDirectory() as tmp:
    d = os.path.join(tmp, "ImageNet", "train", "n0")
    os.makedirs(d)
    for i, kind in enumerate(("jpeg", "png", "bmp", "gif", "tiff")):
        src = os.path.join("tests", "data", kind)
        name = sorted(f for f in os.listdir(src) if f != "manifest.json")[0]
        shutil.copy(os.path.join(src, name), os.path.join(d, f"{i}.JPEG"))
    tt = {"Resize": {"apply": True, "height": 40, "width": 40},
          "RandomResizedCrop": {"apply": True, "size": 32,
                                "scale": [0.8, 1.2]},
          "TrivialAugment": {"apply": True}, "Normalize": True}
    ds = ImageNet({"data_location": tmp, "train_transforms": tt,
                   "img_channels": 1}, "train")
    for i in range(len(ds)):
        sample = ds.__getitem__(i, rng=np.random.default_rng(i))["image"]
        assert sample.shape == (32, 32, 3) and np.isfinite(sample).all()
    ds.raw_mode, ds.raw_size = True, 24
    assert ds[0]["image"].shape == (24, 24)

# the FLOP model, and a run logger asking for wandb: the import is blocked,
# so the JSONL alone
cfg = VIT_BUILDERS["vit_base"](img_size=224, patch_size=14)
assert flops.vit_train_step_flops(cfg, 1000, 64)["total_flops"] > 0
assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
with tempfile.TemporaryDirectory() as tmp:
    logger = RunLogger(tmp, "m", use_wandb=True)
    logger.log({"train_loss": 1.0}, 1)
    logger.finish()
    assert logger.wandb_run is None
    assert os.listdir(tmp) == ["m.metrics.jsonl"]

leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("OK")
"""


def test_formats_grey_flops_and_logger_run_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT_FORMATS],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK"), proc.stdout[-2000:]


def test_mask_branch_multilabel_and_lamb_run_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT_MASKS_MULTILABEL],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK"), proc.stdout[-2000:]


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split("MODULES")[-1])
    assert n_modules >= 40, proc.stdout
