"""The port's data modules against the JAX package's.

- `Synthetic`: the same records (arrays and labels, exactly), and the same
  transformed samples from the same per-sample generator (identity Resize,
  CenterCrop, HorizontalFlip, Normalize: float32 atol 1e-6, the JAX path
  may normalise in its native helper), and raw-mode uint8 records exactly.
- `DataLoader`: the same index batches and batch contents as the JAX
  loader for (seed, epoch), shuffle and drop_last, with and without worker
  processes; its workers stop when it is dropped.
- `AdvancedAugCollate` (mixup/cutmix) with the same numpy seed: equal.
- `device_augment` against the JAX one with the same random draws fed in
  (the two draw from different generators): the draws are taken from the
  JAX keys the way `apla_tpu/data/device_augs.py` takes them, and both
  outputs compared at float32 rtol = atol = 1e-4 (separable antialiased
  resampling summed in a different order).
"""

import gc
import math
import multiprocessing
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.data import datasets as jdata
from apla_tpu.data import device_augs as jaugs
from apla_tpu.data.loader import DataLoader as JaxLoader
from apla_tpu.data.mixup import AdvancedAugCollate as JaxMixup
from apla_tpu_torch.data import datasets as tdata
from apla_tpu_torch.data import device_augs as taugs
from apla_tpu_torch.data.loader import DataLoader
from apla_tpu_torch.data.mixup import AdvancedAugCollate

_RESIZE = {"apply": True, "height": 40, "width": 40}
PARAMS = {
    "dataset": "Synthetic", "data_location": "/nonexistent",
    "synthetic_classes": 5, "synthetic_size": 24, "synthetic_img_size": 40,
    "train_transforms": {"Resize": _RESIZE,
                         "HorizontalFlip": {"apply": True, "p": 0.5},
                         "Normalize": True},
    "val_transforms": {"Resize": _RESIZE,
                       "CenterCrop": {"apply": True, "height": 32,
                                      "width": 32},
                       "Normalize": True},
    "test_transforms": {"Resize": _RESIZE, "Normalize": False},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_synthetic_records_and_transforms_match_jax(mode):
    ours, ref = tdata.Synthetic(PARAMS, mode), jdata.Synthetic(PARAMS, mode)
    assert len(ours) == len(ref) and ours.n_classes == ref.n_classes
    assert (ours.mean, ours.std, ours.target_metric, ours.task) == \
        (ref.mean, ref.std, ref.target_metric, ref.task)
    for a, b in zip(ours.data, ref.data):
        np.testing.assert_array_equal(a["img_arr"], b["img_arr"])
        assert a["label"] == b["label"]
    for idx in range(len(ours)):
        got = ours.__getitem__(idx, rng=np.random.default_rng((0, 1, idx)))
        want = ref.__getitem__(idx, rng=np.random.default_rng((0, 1, idx)))
        assert got["label"] == want["label"]
        assert got["image"].dtype == np.float32
        np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                                   atol=1e-6)


def test_raw_mode_matches_jax():
    ours, ref = tdata.Synthetic(PARAMS, "train"), jdata.Synthetic(PARAMS,
                                                                   "train")
    for ds in (ours, ref):
        ds.raw_mode, ds.raw_size = True, 40
    for idx in (0, 7):
        got, want = ours[idx], ref[idx]
        assert got["image"].dtype == np.uint8
        np.testing.assert_array_equal(got["image"], want["image"])


def test_unported_transforms_and_datasets_raise():
    """A transform once not ported (TrivialAugment, which raised here until
    every transform was ported) now runs and gives the JAX package's
    sample, and raw mode never runs it; a raw size or a Resize that
    changes the size, raised on before the transforms were ported, gives
    the JAX package's uint8 image and float32 sample; the multi-label
    variant, once an unported dataset, has the JAX records."""
    params = dict(PARAMS, train_transforms={"Resize": _RESIZE,
                                            "TrivialAugment": {"apply": True},
                                            "Normalize": True})
    ds = tdata.Synthetic(params, "train")
    jds = jdata.Synthetic(params, "train")
    for seed in range(6):
        got = ds.__getitem__(0, rng=np.random.default_rng(seed))["image"]
        want = jds.__getitem__(0, rng=np.random.default_rng(seed))["image"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ds.raw_mode, ds.raw_size = True, 40     # raw mode never runs them
    assert ds[0]["image"].shape == (40, 40, 3)
    ref = jdata.Synthetic(PARAMS, "train")
    ds.raw_size = ref.raw_size = 32
    ref.raw_mode = True
    np.testing.assert_array_equal(ds[0]["image"], ref[0]["image"])
    resize = dict(PARAMS, val_transforms={"Resize": {
        "apply": True, "height": 48, "width": 48}})
    got = tdata.Synthetic(resize, "val").__getitem__(
        0, rng=np.random.default_rng(0))["image"]
    want = jdata.Synthetic(resize, "val").__getitem__(
        0, rng=np.random.default_rng(0))["image"]
    assert got.shape == (48, 48, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the multi-label variant: the same images, two labels a record
    ml = tdata.get_dataset_class("SyntheticMultiLabel")(PARAMS, "val")
    ref_ml = jdata.get_dataset_class("SyntheticMultiLabel")(PARAMS, "val")
    for a, b in zip(ml.data, ref_ml.data):
        np.testing.assert_array_equal(a["img_arr"], b["img_arr"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("shuffle,drop_last,workers", [
    (True, True, 0), (False, False, 0), (True, False, 2)])
def test_loader_batches_match_jax(shuffle, drop_last, workers):
    kw = dict(batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=3)
    ours = DataLoader(tdata.Synthetic(PARAMS, "train"), num_workers=workers,
                      **kw)
    ref = JaxLoader(jdata.Synthetic(PARAMS, "train"), num_workers=1, **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours) == len(ref)
        for a, b in zip(got, want):
            assert a["image"].dtype == torch.float32
            assert a["label"].dtype == torch.int64
            np.testing.assert_allclose(a["image"].numpy(), b["image"],
                                       rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a["label"].numpy(), b["label"])


def test_loader_workers_stop_when_the_loader_is_dropped():
    """Dropping the loader frees it at once (no reference cycle left for the
    collector) and its worker processes stop with it."""
    before = set(multiprocessing.active_children())
    loader = DataLoader(tdata.Synthetic(PARAMS, "train"), batch_size=6,
                        num_workers=2)
    assert len(list(loader)) == len(loader)
    workers = set(multiprocessing.active_children()) - before
    assert len(workers) == 2
    gone = weakref.ref(loader)
    gc.disable()
    try:
        del loader
        assert gone() is None
    finally:
        gc.enable()
    assert not any(p.is_alive() for p in workers)


def test_mixup_collate_matches_jax_with_the_same_seed():
    params = {"mixup_alpha": 0.8, "cutmix_alpha": 1.0, "prob": 0.9,
              "label_smoothing": 0.1, "num_classes": 5, "seed": 4}
    ours, ref = AdvancedAugCollate(params), JaxMixup(params)
    ds = tdata.Synthetic(PARAMS, "train")
    ds.raw_mode, ds.raw_size = True, 40
    samples = [ds[i] for i in range(6)]
    for _ in range(6):                 # mixup, cutmix and no-op draws
        got, want = ours(samples), ref(samples)
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
    # a generator handed in replaces the collate's own
    a = ours(samples, rng=np.random.default_rng(9))
    b = AdvancedAugCollate(params)(samples, rng=np.random.default_rng(9))
    np.testing.assert_array_equal(a["label"], b["label"])


def _jax_draws(key, batch, cfg):
    """The draws `apla_tpu.data.device_augs.device_augment` makes from
    `key`, in the port's `sample_aug_params` layout."""
    keys = jax.random.split(key, 3 * batch).reshape(3, batch, -1)
    rows = {k: [] for k in ("area", "log_ratio", "y0", "x0", "jitter",
                            "brightness", "contrast", "saturation", "theta")}
    for b in range(batch):
        k1, k2, k3, k4 = jax.random.split(keys[0][b], 4)
        rows["area"].append(jax.random.uniform(
            k1, (), minval=cfg.crop_scale[0], maxval=cfg.crop_scale[1]))
        rows["log_ratio"].append(jax.random.uniform(
            k2, (), minval=jnp.log(cfg.crop_ratio[0]),
            maxval=jnp.log(cfg.crop_ratio[1])))
        rows["y0"].append(jax.random.uniform(k3, ()))
        rows["x0"].append(jax.random.uniform(k4, ()))
        kb, kc, ks, kh, kp = jax.random.split(keys[1][b], 5)
        rows["jitter"].append(jax.random.uniform(kp, ()) < cfg.jitter_p)
        rows["brightness"].append(1.0 + jax.random.uniform(
            kb, (), minval=-cfg.brightness, maxval=cfg.brightness))
        rows["contrast"].append(1.0 + jax.random.uniform(
            kc, (), minval=-cfg.contrast, maxval=cfg.contrast))
        rows["saturation"].append(1.0 + jax.random.uniform(
            ks, (), minval=-cfg.saturation, maxval=cfg.saturation))
        rows["theta"].append(2.0 * jnp.pi * jax.random.uniform(
            kh, (), minval=-cfg.hue, maxval=cfg.hue))
    out = {k: torch.from_numpy(np.array(jnp.stack(v))) for k, v in
           rows.items()}
    for name, i, p in (("flip", 1, cfg.hflip_p), ("gray", 2, cfg.grayscale_p)):
        u = jax.random.uniform(jax.random.fold_in(key, i), (batch, 1, 1, 1))
        out[name] = torch.from_numpy(np.array(u < p).reshape(batch))
    return out


@pytest.mark.parametrize("scale,out", [((0.3, 1.0), 24), ((0.02, 0.1), 32)])
def test_device_augment_matches_jax_with_the_same_draws(scale, out):
    """Downscaling crops (antialiased) and upscaling ones."""
    kw = dict(out_size=out, crop_scale=scale, hflip_p=0.5, jitter_p=0.6,
              brightness=0.3, contrast=0.3, saturation=0.2, hue=0.1,
              grayscale_p=0.4, mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))
    jcfg, tcfg = jaugs.DeviceAugConfig(**kw), taugs.DeviceAugConfig(**kw)
    images = np.random.default_rng(5).integers(0, 256, (6, 40, 48, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaugs.device_augment(jnp.asarray(images), key, jcfg,
                                           compute_dtype=jnp.float32))
    got = taugs.apply_device_augment(torch.from_numpy(images),
                                     _jax_draws(key, 6, jcfg), tcfg,
                                     compute_dtype=torch.float32)
    assert got.shape == want.shape == (6, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_scale_translate_weights_match_jax():
    scale = np.array([24 / 30.5, 1.7, 0.4], np.float32)
    shift = np.array([-3.25, 2.0, 0.5], np.float32)
    from jax._src.image.scale import _fill_triangle_kernel, \
        compute_weight_mat
    got = taugs.scale_translate_weights(40, 24, torch.from_numpy(scale),
                                        torch.from_numpy(shift))
    for b in range(3):
        want = compute_weight_mat(40, 24, jnp.float32(scale[b]),
                                  jnp.float32(shift[b]),
                                  _fill_triangle_kernel, True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_device_augment_draws_and_shapes():
    cfg = taugs.DeviceAugConfig(out_size=16, hflip_p=1.0, jitter_p=0.0)
    gen = torch.Generator().manual_seed(0)
    p = taugs.sample_aug_params(5, cfg, gen, "cpu")
    assert p["flip"].all() and not p["jitter"].any()
    assert ((p["area"] >= 0.8) & (p["area"] < 1.2)).all()
    assert (p["log_ratio"].abs() <= math.log(4 / 3) + 1e-6).all()
    x = torch.randint(0, 256, (5, 20, 20, 3), dtype=torch.uint8)
    y = taugs.device_augment(x, gen, cfg)
    assert y.shape == (5, 16, 16, 3) and y.dtype == torch.bfloat16
