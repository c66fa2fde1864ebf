"""Device-side batched augmentation (the supervised `device_augment` tail).

Counterpart of `apla_tpu/data/device_augs.py:29-101,149-188`: the host ships
resized images (uint8, or float 0..255 after the mixup collate) and the
train step runs, on the device and vectorised over the batch: random
resized crop, horizontal flip, brightness/contrast/saturation jitter with
the YIQ hue rotation, grayscale, normalize.

The crop is `jax.image.scale_and_translate(..., "bilinear")` with its
default antialiasing, written out as separable per-image resampling weights
(`scale_translate_weights`): `F.interpolate` and `grid_sample` do not
antialias a downscale.  Random draws come from a `torch.Generator`
(`sample_aug_params`) and are applied by `apply_device_augment`, so a test
can feed both packages the same draws.  Blur, solarize and multi-crop are
SSL-only and come with the SSL slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class DeviceAugConfig:
    out_size: int = 224
    crop_scale: tuple = (0.8, 1.2)       # RandomResizedCrop area range
    crop_ratio: tuple = (3 / 4, 4 / 3)
    hflip_p: float = 0.5
    jitter_p: float = 0.8
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.1
    hue: float = 0.0                     # YIQ chroma rotation, in turns
    grayscale_p: float = 0.0
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)


def sample_aug_params(batch: int, cfg: DeviceAugConfig,
                      generator: torch.Generator, device) -> dict:
    """Per-image random draws, each [batch]: crop area fraction, log aspect
    ratio and position (uniforms in [0, 1)), flip, jitter apply and
    factors, hue angle (radians), grayscale."""
    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=device)
    return {
        "area": u(*cfg.crop_scale),
        "log_ratio": u(math.log(cfg.crop_ratio[0]),
                       math.log(cfg.crop_ratio[1])),
        "y0": u(), "x0": u(),
        "flip": u() < cfg.hflip_p,
        "jitter": u() < cfg.jitter_p,
        "brightness": 1.0 + u(-cfg.brightness, cfg.brightness),
        "contrast": 1.0 + u(-cfg.contrast, cfg.contrast),
        "saturation": 1.0 + u(-cfg.saturation, cfg.saturation),
        "theta": 2.0 * math.pi * u(-cfg.hue, cfg.hue),
        "gray": u() < cfg.grayscale_p,
    }


def scale_translate_weights(n_in: int, n_out: int, scale, translation):
    """[B, n_in, n_out] float32 weights of `jax.image.scale_and_translate`
    with the triangle (bilinear) kernel and antialiasing, one map per image
    (`scale`, `translation` [B]): the kernel widens by 1/scale when
    downscaling, columns are renormalised, samples outside the input are
    zero."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)[:, None]
    sample = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
              * inv_scale - translation[:, None] * inv_scale - 0.5)
    x = (sample[:, None, :] - torch.arange(n_in, dtype=torch.float32,
                                           device=dev)[None, :, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def _jitter(imgs, p: dict, cfg: DeviceAugConfig):
    """Brightness, contrast, saturation and hue on [B, H, W, 3] in [0, 1],
    applied to the images whose `jitter` draw is set."""
    col = (lambda t: t[:, None, None, None])
    y = imgs * col(p["brightness"])
    mean = y.mean(dim=(1, 2), keepdim=True)
    y = (y - mean) * col(p["contrast"]) + mean
    gray = y.mean(dim=-1, keepdim=True)
    y = (y - gray) * col(p["saturation"]) + gray
    if cfg.hue > 0:
        r, g, b = y[..., 0], y[..., 1], y[..., 2]
        Y = 0.299 * r + 0.587 * g + 0.114 * b
        I = 0.596 * r - 0.274 * g - 0.322 * b
        Q = 0.211 * r - 0.523 * g + 0.312 * b
        c = torch.cos(p["theta"])[:, None, None]
        s = torch.sin(p["theta"])[:, None, None]
        I, Q = I * c - Q * s, I * s + Q * c
        y = torch.stack([Y + 0.956 * I + 0.621 * Q,
                         Y - 0.272 * I - 0.647 * Q,
                         Y - 1.106 * I + 1.703 * Q], dim=-1)
    y = torch.clamp(y, 0.0, 1.0)
    return torch.where(col(p["jitter"]), y, imgs)


def apply_device_augment(images, p: dict, cfg: DeviceAugConfig,
                         compute_dtype=torch.bfloat16):
    """images [B, H, W, C] (0..255) and the draws `p` of `sample_aug_params`
    -> augmented, normalised [B, out, out, C] in compute_dtype."""
    imgs = images.float() / 255.0
    _, H, W, _ = imgs.shape
    area = H * W * p["area"]
    aspect = torch.exp(p["log_ratio"])
    cw = torch.clamp(torch.sqrt(area * aspect), 8.0, W)
    ch = torch.clamp(torch.sqrt(area / aspect), 8.0, H)
    y0 = p["y0"] * (H - ch)
    x0 = p["x0"] * (W - cw)
    out = cfg.out_size
    wy = scale_translate_weights(H, out, out / ch, -y0 * out / ch)
    wx = scale_translate_weights(W, out, out / cw, -x0 * out / cw)
    imgs = torch.einsum("bhwc,bhi,bwj->bijc", imgs, wy, wx)
    imgs = torch.where(p["flip"][:, None, None, None], imgs.flip(2), imgs)
    if cfg.jitter_p > 0:
        imgs = _jitter(imgs, p, cfg)
    if cfg.grayscale_p > 0:
        gray = imgs.mean(dim=-1, keepdim=True).expand_as(imgs)
        imgs = torch.where(p["gray"][:, None, None, None], gray, imgs)
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=imgs.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=imgs.device)
    return ((imgs - mean) / std).to(compute_dtype)


def device_augment(images, generator: torch.Generator, cfg: DeviceAugConfig,
                   compute_dtype=torch.bfloat16):
    """images [B, H, W, C] (0..255) -> augmented normalised [B, out, out, C]
    in compute_dtype, with fresh draws from `generator`."""
    p = sample_aug_params(images.shape[0], cfg, generator, images.device)
    return apply_device_augment(images, p, cfg, compute_dtype)
