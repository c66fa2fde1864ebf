#!/usr/bin/env python3
"""Write the manifest of the host transforms' outputs on the JPEG fixtures.

    python3 tools/make_transform_manifest.py [--out tests/data/transforms]
                                             [--check]

`manifest.json` names three regions of two committed JPEG fixtures
(`tests/data/jpeg`: a square one, where `Image.rotate` by 90 / 270 is a
transpose, a wider one, and the square one decoded as L, the grey image
of `img_channels: 1`) and a list of cases, each with the sha256,
shape and dtype of its output as the JAX package computes it (Pillow):

- `op`: `_apply_op(img, op, magnitude)` on a region, uint8 out, for every
  op at TrivialAugment's magnitude bins 0, 7, 13, 20 and 30 with both signs
  (bin 20 of Rotate is 90 degrees), each of Posterize's seven values, and
  the ops without a magnitude once;
- `transform`: `build_transform(spec, IMAGENET_MEAN, IMAGENET_STD)(img,
  np.random.default_rng(seed))`, float32 out, for every transform name
  alone (ToArray after it, RandomErasing after ToArray) and the shipped
  pipelines that run on the host (the ImageNet recipe's train transforms
  with RandomErasing's `value` 0, and the DINOv2 strategy's three crop
  kinds), at seeds 0-3.

The port's transforms (`apla_tpu_torch/data/transforms.py`) must give the
same bytes through their native ops and through the plain numpy versions:
`tests/test_torch_transforms.py` holds that on the CPU and holds this file
to what the JAX package computes now; `chip_smoke.py` phase 13k holds it on
the card.  Needs Pillow and the JAX package's data modules, so it runs
where the CPU tests run.  `--check` writes nothing and exits 1 if the
manifest differs from what it would write.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# name -> the fixture and the [height, width] region at its top left
# (and the mode it is decoded in: "L" for `img_channels: 1`)
REGIONS = {"square": {"file": "odd_257x255.jpg", "height": 56, "width": 56},
           "wide": {"file": "n01_500x375.JPEG", "height": 48, "width": 64},
           "grey": {"file": "odd_257x255.jpg", "height": 56, "width": 56,
                    "mode": "L"}}
SEEDS = range(4)
OP_BINS = (0, 7, 13, 20, 30)
# every transform alone, at parameters that make each of its draws matter
SINGLE = {
    "Resize": {"apply": True, "height": 40, "width": 52},
    "CenterCrop": {"apply": True, "height": 40, "width": 40},
    "RandomCrop": {"apply": True, "height": 40, "width": 48, "padding": 4},
    "RandomResizedCrop": {"apply": True, "size": 40, "scale": [0.08, 1.0]},
    "VerticalFlip": {"apply": True, "p": 0.5},
    "HorizontalFlip": {"apply": True, "p": 0.5},
    "RandomRotation": {"apply": True, "angle": 30, "p": 0.8},
    "ColorJitter": {"apply": True, "brightness": 0.4, "contrast": 0.4,
                    "saturation": 0.2, "hue": 0.1, "p": 0.8},
    "RandomGrayscale": {"apply": True, "p": 0.5},
    "RandomGaussianBlur": {"apply": True, "p": 0.8, "radius_min": 0.1,
                           "radius_max": 2.0},
    "RandomAffine": {"apply": True, "degrees": 20, "translate": [0.1, 0.1],
                     "scale": [0.8, 1.2], "shear": 10, "p": 0.8},
    "RandomPerspective": {"apply": True, "distortion_scale": 0.5, "p": 0.7},
    "RandomSolarize": {"apply": True, "threshold": 128, "p": 0.5},
    "AugMix": {"apply": True},
    "RandAugment": {"apply": True},
    "AutoAugment": {"apply": True},
    "TrivialAugment": {"apply": True, "num_magnitude_bins": 31},
    "RandomErasing": {"apply": True, "p": 0.7, "scale": [0.02, 0.33],
                      "ratio": [0.3, 3.3], "value": 0},
}
IMAGENET_RECIPE = os.path.join("params", "finetune", "dinov2", "ImageNet",
                               "vit_b", "apla.yml")


def sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _shipped() -> dict:
    """The host pipelines of the shipped recipes, at the regions' scale:
    the ImageNet train transforms (Resize and RandomResizedCrop to 48 and
    40, RandomErasing's "random" as 0, on which the JAX package raises)
    and the DINOv2 strategy's first global, second global and local crop
    (crop sizes 40 and 16)."""
    sys.path.insert(0, ROOT)
    from apla_tpu.ssl.multicrop import STRATEGIES
    from apla_tpu.utils.config import load_merged_params
    tt = load_merged_params(os.path.join(ROOT, IMAGENET_RECIPE)) \
        .dataset_params.train_transforms
    imagenet = {k: copy.deepcopy(dict(v)) if isinstance(v, dict) else v
                for k, v in tt.items()}
    imagenet["Resize"].update(height=48, width=48)
    imagenet["RandomResizedCrop"]["size"] = 40
    imagenet["RandomErasing"]["value"] = 0
    out = {"imagenet_train": imagenet}
    crops = STRATEGIES["dinov2"]["crops"]
    for name, (kind, crop) in (("dinov2_global0", crops[0]),
                               ("dinov2_global1", crops[1]),
                               ("dinov2_local", crops[2])):
        spec = copy.deepcopy(crop)
        spec["RandomResizedCrop"]["size"] = 40 if kind == "global" else 16
        spec["Normalize"] = True
        out[name] = spec
    return out


def cases() -> list:
    """The cases, without their outputs."""
    sys.path.insert(0, ROOT)
    from apla_tpu.data.transforms import TrivialAugmentWide
    out = []
    for region in REGIONS:
        for op, (mags, signed) in TrivialAugmentWide._OPS.items():
            if mags is None:
                bins = [None]
            elif op == "Posterize":       # each of its 7 values once
                bins = sorted({int(np.flatnonzero(mags == m)[0])
                               for m in mags})
            else:
                bins = list(OP_BINS)
            for b in bins:
                for sign in ((1, -1) if signed and b else (1,)):
                    mag = 0.0 if b is None else sign * float(mags[b])
                    out.append({"id": f"op/{op}/{b}/{sign:+d}/{region}",
                                "image": region, "op": op,
                                "magnitude": mag})
        out.append({"id": f"op/Invert/None/+1/{region}", "image": region,
                    "op": "Invert", "magnitude": 0.0})
        specs = {name: {name: entry} for name, entry in SINGLE.items()}
        specs.update(_shipped())
        for name, spec in specs.items():
            for seed in SEEDS:
                out.append({"id": f"transform/{name}/{seed}/{region}",
                            "image": region, "transform": spec,
                            "seed": seed})
    return out


def regions() -> dict:
    """name -> the uint8 region, decoded by Pillow."""
    from PIL import Image
    out = {}
    for name, r in REGIONS.items():
        with open(os.path.join(FIXTURES, r["file"]), "rb") as f:
            img = np.asarray(Image.open(f).convert(r.get("mode", "RGB")))
        out[name] = np.ascontiguousarray(img[:r["height"], :r["width"]])
    return out


def manifest() -> dict:
    """The cases with the JAX package's outputs."""
    sys.path.insert(0, ROOT)
    from PIL import Image
    from apla_tpu.data import transforms as jt
    imgs = regions()
    out = []
    for case in cases():
        pil = Image.fromarray(imgs[case["image"]])
        if "op" in case:
            arr = np.asarray(jt._apply_op(pil, case["op"], case["magnitude"],
                                          None))
        else:
            arr = np.asarray(jt.build_transform(
                case["transform"], IMAGENET_MEAN, IMAGENET_STD)(
                pil, np.random.default_rng(case["seed"])))
        out.append({**case, "shape": list(arr.shape), "dtype": arr.dtype.str,
                    "sha256": sha(arr)})
    return {"regions": REGIONS, "mean": list(IMAGENET_MEAN),
            "std": list(IMAGENET_STD), "cases": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                   "transforms"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    path = os.path.join(args.out, "manifest.json")
    want = manifest()
    if args.check:
        with open(path) as f:
            same = json.load(f) == want
        print("manifest up to date" if same else "stale")
        return 0 if same else 1
    os.makedirs(args.out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(want, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(want['cases'])} cases in {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
