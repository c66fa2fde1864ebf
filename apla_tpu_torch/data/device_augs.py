"""Device-side batched augmentation (the supervised `device_augment` tail).

Counterpart of `apla_tpu/data/device_augs.py`: the host ships resized
images (uint8, or float 0..255 after the mixup collate) and the train step
runs, on the device and vectorised over the batch: random resized crop,
horizontal flip, brightness/contrast/saturation jitter with the YIQ hue
rotation, grayscale, and for the SSL crops a per-image-sigma Gaussian blur
and solarize, then normalize.  `device_multicrop` builds every crop of an
SSL multi-crop strategy from one raw batch, crop-major.

The crop is `jax.image.scale_and_translate(..., "bilinear")` with its
default antialiasing, written out as separable per-image resampling weights
(`scale_translate_weights`): `F.interpolate` and `grid_sample` do not
antialias a downscale.  Random draws come from a `torch.Generator`
(`sample_aug_params`) and are applied by `apply_device_augment`, so a test
can feed both packages the same draws.  The blur is the JAX package's
9-tap separable kernel with "SAME" zero padding, as two grouped `conv2d`
calls (one group per image channel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..parallel.mesh import rand_rows


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
    # SSL extras (reference multi-crop recipes): gaussian blur + solarize
    blur_p: float = 0.0
    blur_radius: tuple = (0.1, 2.0)
    solarize_p: float = 0.0
    solarize_threshold: float = 128.0    # on the 0..255 scale
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)


def sample_aug_params(batch: int, cfg: DeviceAugConfig,
                      generator: torch.Generator, device) -> dict:
    """Per-image random draws, each [batch]: crop area fraction, log aspect
    ratio and position (uniforms in [0, 1)), flip, jitter apply and
    factors, hue angle (radians), grayscale; blur sigma and apply, and
    solarize apply, where the config has them."""
    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * rand_rows((batch,), generator=generator,
                                          device=device)
    p = {
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
    if cfg.blur_p > 0:
        p["blur_sigma"] = u(*cfg.blur_radius)
        p["blur"] = u() < cfg.blur_p
    if cfg.solarize_p > 0:
        p["solarize"] = u() < cfg.solarize_p
    return p


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


BLUR_TAPS = 9  # static kernel width; covers sigma up to ~2 (radius_max)


def gaussian_blur(imgs, sigma):
    """Separable Gaussian blur of [B, H, W, C] with one sigma per image
    ([B]), 9 taps, "SAME" zero padding: H then W, as the JAX package's
    depthwise `conv_general_dilated` pair."""
    B, H, W, C = imgs.shape
    x = torch.arange(BLUR_TAPS, dtype=torch.float32, device=imgs.device) \
        - (BLUR_TAPS - 1) / 2
    w = torch.exp(-0.5 * (x[None, :] / sigma.float()[:, None]) ** 2)
    w = (w / w.sum(dim=1, keepdim=True)).repeat_interleave(C, dim=0)
    y = imgs.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    pad = (BLUR_TAPS - 1) // 2
    y = torch.nn.functional.conv2d(y, w.reshape(B * C, 1, BLUR_TAPS, 1),
                                   padding=(pad, 0), groups=B * C)
    y = torch.nn.functional.conv2d(y, w.reshape(B * C, 1, 1, BLUR_TAPS),
                                   padding=(0, pad), groups=B * C)
    return y.reshape(B, C, H, W).permute(0, 2, 3, 1)


def apply_device_augment(images, p: dict, cfg: DeviceAugConfig,
                         compute_dtype=torch.bfloat16):
    """images [B, H, W, C] (0..255) and the draws `p` of `sample_aug_params`
    -> augmented, normalised [B, out, out, C] in compute_dtype.  Other
    shapes raise, as the JAX package's step does when it traces them: a
    raw L batch [B, H, W] (`img_channels: 1`), or bands that the mean does
    not match (RGBA)."""
    if images.ndim != 4 or images.shape[-1] != len(cfg.mean):
        raise ValueError(
            f"device augmentation takes [B, H, W, {len(cfg.mean)}] images "
            f"(the mean's entries), not {tuple(images.shape)}")
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
    if cfg.blur_p > 0:
        imgs = torch.where(p["blur"][:, None, None, None],
                           gaussian_blur(imgs, p["blur_sigma"]), imgs)
    if cfg.solarize_p > 0:
        t = cfg.solarize_threshold / 255.0
        sol = torch.where(imgs >= t, 1.0 - imgs, imgs)
        imgs = torch.where(p["solarize"][:, None, None, None], sol, imgs)
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=imgs.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=imgs.device)
    return ((imgs - mean) / std).to(compute_dtype)


def device_augment(images, generator: torch.Generator, cfg: DeviceAugConfig,
                   compute_dtype=torch.bfloat16):
    """images [B, H, W, C] (0..255) -> augmented normalised [B, out, out, C]
    in compute_dtype, with fresh draws from `generator`."""
    p = sample_aug_params(images.shape[0], cfg, generator, images.device)
    return apply_device_augment(images, p, cfg, compute_dtype)


# --------------------------------------------------------------------------- #
# SSL multi-crop on the device: one raw image per sample, every crop of the
# strategy (n_global global + the local ones) built inside the train step
# --------------------------------------------------------------------------- #

def crop_cfgs_from_strategy(strategy_spec: dict, mean, std,
                            g_size=None, l_size=None):
    """One DeviceAugConfig per crop of a multi-crop strategy spec
    (`ssl/multicrop.py`), with the host pipeline's transform parameters."""
    cfgs = []
    for kind, crop in strategy_spec["crops"]:
        rrc = crop.get("RandomResizedCrop", {})
        cj = crop.get("ColorJitter", {})
        blur = crop.get("RandomGaussianBlur", {})
        sol = crop.get("RandomSolarize", {})
        size = int(rrc.get("size", 224))
        if kind == "global" and g_size:
            size = int(g_size)
        if kind == "local" and l_size:
            size = int(l_size)
        cfgs.append(DeviceAugConfig(
            out_size=size,
            crop_scale=tuple(rrc.get("scale", (0.4, 1.0))),
            hflip_p=float(crop.get("HorizontalFlip", {}).get("p", 0.5)),
            jitter_p=float(cj.get("p", 0.8)) if cj.get("apply") else 0.0,
            brightness=float(cj.get("brightness", 0.4)),
            contrast=float(cj.get("contrast", 0.4)),
            saturation=float(cj.get("saturation", 0.2)),
            hue=float(cj.get("hue", 0.0)),
            grayscale_p=float(crop.get("RandomGrayscale", {}).get("p", 0.0)),
            blur_p=float(blur.get("p", 0.0)) if blur.get("apply",
                                                         True) else 0.0,
            blur_radius=(float(blur.get("radius_min", 0.1)),
                         float(blur.get("radius_max", 2.0))),
            solarize_p=float(sol.get("p", 0.0)) if sol else 0.0,
            solarize_threshold=float(sol.get("threshold", 128)),
            mean=tuple(mean), std=tuple(std)))
    return cfgs


def apply_device_multicrop(images, draws, crop_cfgs, n_global: int,
                           compute_dtype=torch.bfloat16):
    """images [B, H, W, C] and one `sample_aug_params` dict per crop ->
    (global crops [n_global*B, g, g, C], local crops [n_local*B, l, l, C]
    or None), crop-major as the iBOT collate stacks them."""
    outs = [apply_device_augment(images, p, cfg, compute_dtype)
            for p, cfg in zip(draws, crop_cfgs)]
    glob = torch.cat(outs[:n_global], dim=0)
    loc = torch.cat(outs[n_global:], dim=0) if len(outs) > n_global else None
    return glob, loc


def device_multicrop(images, generator: torch.Generator, crop_cfgs,
                     n_global: int, compute_dtype=torch.bfloat16):
    """`apply_device_multicrop` with fresh draws from `generator`."""
    draws = [sample_aug_params(images.shape[0], cfg, generator, images.device)
             for cfg in crop_cfgs]
    return apply_device_multicrop(images, draws, crop_cfgs, n_global,
                                  compute_dtype)
