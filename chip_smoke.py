#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`apla_tpu_torch`).

Drives the port's serving path once on one CUDA card, in phases that each
print a line and raise on failure:

  1. build   — compile the hand-written kernel from `apla_tpu_torch/csrc`.
  2. kernel  — the fused APLA attention kernel against its plain PyTorch
               version on the card, bf16, at the served length (N=257), the
               518-crop length (N=1370) and a segmented case.
  3. slice   — the ViT-B/14 APLA-128 ImageNet classifier (random weights from
               a seed, the shipped rank-128 index file) exported at batch
               sizes 1/8/64, reloaded, and asked for 1, 9 and 100 images.
               Every block of every call must have run the kernel; outputs
               must be finite and agree with the same model on the plain
               attention path; b64 throughput of both arms is timed.

Phases 2 and 3 also run negative controls: the kernel made to compute what
a broken one would (output zeroed or halved, uniform attention, half the
heads dropped).  Each must fail the phase's bound, so the bounds are shown
to catch a broken kernel in every run.

Then it prints the card's name and power limit, a JSON line describing the
kernel, and the contract line `{"ok": true, "device": {...}}` last.

Run from the repository root:  python3 chip_smoke.py
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# The model fields of params/finetune/dinov2/ImageNet/vit_b/apla.yml merged
# over its __common__.yml (the card's machine has no PyYAML; a CPU test holds
# this dict against the YAML).  The pos-embed grid is the recipe's 518; the
# model is served at the 224 test crop.
RECIPE = {
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
    "training_params": {"use_mixed_precision": True},
}
SERVE_IMG = 224
N_CLASSES = 1000
SEED = 0
BATCH_SIZES = (1, 8, 64)
REQUESTS = (1, 9, 100)
# (qkv shape, segment_len) for the kernel-vs-plain phase: the served calls
# at b1, b8 and b64, the 518-crop length, and packed segments
KERNEL_CASES = (((1, 257, 2304), 0), ((8, 257, 2304), 0),
                ((64, 257, 2304), 0), ((2, 1370, 2304), 0),
                ((8, 200, 2304), 50))
# Kernel vs plain, both bf16 out: they differ by the order of f32 sums and
# the online max/sum of the softmax, i.e. by a bf16 rounding of p, o or the
# output here and there.  Bound: 2e-2 of the reference's largest magnitude.
KERNEL_REL_TOL = 2e-2
# Served model, fused arm vs plain arm (bf16 end to end through 12 blocks;
# the plain arm also rounds its attention logits to bf16): per-image
# embedding cosine, and max |delta logits| relative to max |logits|.  On an
# H100 the fused arm reads cosine 0.999908 and 1.2% of max |logits|; the
# mildest of the faults in `_faults` (uniform p) reads 0.9844 and 16%.
# The bounds sit about 5x above the first and 5x below the second, and the
# script checks every run that each fault still fails them.
MIN_COSINE = 0.9995
LOGITS_REL_TOL = 3e-2


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def phase_build():
    from apla_tpu_torch.ops import cuda_build
    from apla_tpu_torch.ops.fused_apla_attn import _SOURCE
    t0 = time.perf_counter()
    cuda_build.load_library(_SOURCE)
    secs = time.perf_counter() - t0
    print(f"[1 build] {_SOURCE} built and loaded in {secs:.2f} s "
          f"-> {cuda_build.library_path(_SOURCE).relative_to(ROOT)}")
    return secs


def phase_kernel(device):
    from apla_tpu_torch.ops.fused_apla_attn import (
        fused_apla_attn_fwd, fused_apla_attn_fwd_reference)
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
    # times at the served b64 call's shape (N=257, ViT-B)
    qkv = torch.randn((64, 257, 2304), generator=gen).to(device,
                                                         torch.bfloat16)
    w = (torch.randn((768, 768), generator=gen) * 768 ** -0.5).to(
        device, torch.bfloat16)
    ms = _time_ms(lambda: fused_apla_attn_fwd(qkv, w, heads, scale, 0))
    plain_ms = _time_ms(
        lambda: fused_apla_attn_fwd_reference(qkv, w, heads, scale, 0))
    print(f"[2 kernel] b64 N=257 C=768: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return worst, ms, plain_ms


def _agrees(name, outs, ref_outs) -> bool:
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
    print(f"[3 slice] {name} vs plain arm: min embedding cosine "
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


def _with_fault(fault, pred, requests):
    """The predictor's answers with `fault` applied to every block's
    kernel call."""
    from apla_tpu_torch.ops import attention
    real = attention.fused_apla_attention

    def faulty(qkv, w_t, b_t, w_frozen, b_frozen, inds, num_heads, scale,
               segment_len=0):
        qkv, f, scale = fault(qkv, scale)
        return real(qkv, w_t * f, b_t, w_frozen * f, b_frozen, inds,
                    num_heads, scale, segment_len)

    attention.fused_apla_attention = faulty
    try:
        return [pred.predict_and_embed(x) for x in requests]
    finally:
        attention.fused_apla_attention = real


def phase_slice(device):
    from apla_tpu_torch.models.classifier import (classifier_forward,
                                                  init_classifier)
    from apla_tpu_torch.ops.fused_apla_attn import fused_apla_attn_fwd
    from apla_tpu_torch.serve import Predictor, export_classifier, \
        load_predictor
    from apla_tpu_torch.wrapper import build_apla_config, build_vit_config

    grid_cfg = build_vit_config(RECIPE)
    apla_cfg = build_apla_config(RECIPE)
    apla_cfg = dataclasses.replace(
        apla_cfg, inds_path=os.path.join(ROOT, apla_cfg.inds_path))
    t0 = time.perf_counter()
    model = init_classifier(grid_cfg, N_CLASSES, apla_cfg,
                            generator=torch.Generator().manual_seed(SEED),
                            device=device)
    serve_cfg = dataclasses.replace(grid_cfg, img_size=SERVE_IMG)
    depth = serve_cfg.depth
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"[3 slice] {RECIPE['model_params']['backbone_type']}/"
          f"{serve_cfg.patch_size} APLA-{apla_cfg.partial_size} classifier "
          f"({depth} blocks, {n_train:,} trainable) built on {device} in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((n, SERVE_IMG, SERVE_IMG, 3),
                                    dtype=np.float32) for n in REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        export_classifier(tmp, model, serve_cfg, batch_sizes=BATCH_SIZES)
        pred = load_predictor(tmp, device)
    del model
    n_calls = sum(1 for x in requests for _ in pred._iter_chunks(x))

    fused_apla_attn_fwd.launches = 0
    outs = [pred.predict_and_embed(x) for x in requests]
    torch.cuda.synchronize()
    launches = fused_apla_attn_fwd.launches
    print(f"[3 slice] answered {list(REQUESTS)} images in {n_calls} calls; "
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
    ok = _agrees("fused arm", outs, plain_outs)
    # Negative controls: the fused arm with a kernel fault made on purpose.
    # Each must fail the bounds, or the bounds could not tell a broken
    # kernel from a working one.
    caught = all([not _agrees(f"control: {name}",
                              _with_fault(fault, pred, requests), plain_outs)
                  for name, fault in _faults().items()])
    if not ok:
        raise SystemExit("fused arm disagrees with the plain arm")
    if not caught:
        raise SystemExit("a broken kernel passes the slice's bounds")

    x64 = torch.from_numpy(requests[-1][:64]).to(device)
    rates = {}
    with torch.inference_mode():
        for name, cfg in (("plain", plain_cfg), ("fused", serve_cfg),
                          ("fused", serve_cfg), ("plain", plain_cfg)):
            ms = _time_ms(lambda: classifier_forward(pred.model, x64, cfg),
                          iters=10)
            rates.setdefault(name, []).append(64 * 1000.0 / ms)
    fused_rate = max(rates["fused"])
    plain_rate = max(rates["plain"])
    print(f"[3 slice] b64 forward: fused {fused_rate:.1f} img/s, plain "
          f"{plain_rate:.1f} img/s (best of 2 turns each: fused "
          f"{rates['fused']}, plain {rates['plain']})")
    return launches, fused_rate, plain_rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    build_s = phase_build()
    max_err, ms, plain_ms = phase_kernel(device)
    launches, fused_rate, plain_rate = phase_slice(device)
    print(f"summary: build {build_s:.2f} s; b64 img/s fused {fused_rate:.1f} "
          f"plain {plain_rate:.1f}")
    print(_gpu_line())
    print(json.dumps({"kernels": [{
        "name": "fused_apla_attn_fwd",
        "route": "cuda",
        "source": "apla_tpu_torch/csrc/fused_apla_attn_fwd.cu",
        "replaces": "apla_tpu/ops/pallas_apla_attn.py:105",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
