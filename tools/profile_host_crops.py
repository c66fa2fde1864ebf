#!/usr/bin/env python3
"""Where the host multi-crop's time goes, on this host's CPU, one process.

    python3 tools/profile_host_crops.py [--strategy dinov2] [--images 40]

Decodes a JPEG fixture (tests/data/jpeg) with the port's decoder, resizes
it to 256 x 256 (the shipped recipes' Resize, which the loader runs once
per image), then runs the strategy's per-crop pipelines
(`apla_tpu_torch/ssl/multicrop.py`, ImageNet mean / std) on it under
`--images` generator seeds, timing each step of each pipeline; then times
the host ops the steps rest on, once each on a 224 x 224 crop.  Prints ms
per image by step (summed over the crops), ms per op, and a JSON line of
both.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _ms(fn, n=50) -> float:
    fn()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strategy", default="dinov2")
    ap.add_argument("--images", type=int, default=40)
    ap.add_argument("--fixture", default="n01_500x375.JPEG")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from apla_tpu_torch import native
    from apla_tpu_torch.data import transforms as tt
    from apla_tpu_torch.data.detection_data import read_image
    from apla_tpu_torch.ssl.multicrop import STRATEGIES

    path = os.path.join(ROOT, "tests", "data", "jpeg", args.fixture)
    decode_ms = _ms(lambda: read_image(path), 10)
    img = tt.resize_bicubic(read_image(path), 256, 256)
    # each crop inherits the recipe's Normalize (`apply_augmentation_strategy`)
    pipes = [tt.build_transform({**c, "Normalize": True}, MEAN, STD)
             for _, c in STRATEGIES[args.strategy]["crops"]]
    steps = collections.Counter()
    t0 = time.perf_counter()
    for seed in range(args.images):
        rng = np.random.default_rng(seed)
        for pipe in pipes:
            x = img
            for t in pipe.transforms:
                t1 = time.perf_counter()
                x = t(x, rng)
                steps[repr(t)] += time.perf_counter() - t1
    total_ms = (time.perf_counter() - t0) / args.images * 1e3
    per_step = {k: v / args.images * 1e3 for k, v in steps.most_common()}
    x = tt.resize_bicubic(img, 224, 224)
    mean, std = np.float32(MEAN), np.float32(STD)
    ops = {"brightness": lambda: tt.brightness(x, 1.2),
           "contrast": lambda: tt.contrast(x, 1.2),
           "saturation": lambda: tt.saturation(x, 1.1),
           "hue_shift": lambda: tt.hue_shift(x, 0.05),
           "gaussian_blur r1.5": lambda: tt.gaussian_blur(x, 1.5),
           "grayscale": lambda: tt.grayscale(x),
           "normalize": lambda: native.normalize(x, mean, std),
           "bicubic 190x210 -> 224": lambda: tt.resize_bicubic(
               img[10:200, 20:230], 224, 224)}
    per_op = {name: _ms(fn) for name, fn in ops.items()}
    print(f"{args.strategy}: {len(pipes)} crops an image, "
          f"{total_ms:.1f} ms an image after the decode ({decode_ms:.1f} ms) "
          f"and the resize to 256, over {args.images} seeds")
    for name, ms in per_step.items():
        print(f"  {name:48s} {ms:7.2f} ms an image")
    for name, ms in per_op.items():
        print(f"  op {name:45s} {ms:7.3f} ms at 224")
    print(json.dumps({"strategy": args.strategy, "ms_per_image": total_ms,
                      "decode_ms": decode_ms, "steps_ms": per_step,
                      "ops_ms_224": per_op}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
