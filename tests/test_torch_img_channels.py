"""Grey and RGBA datasets (`dataset_params.img_channels` 1 and 4) in the
port against the JAX package, which reads them through Pillow's
`convert("L")` and `convert("RGBA")`.

- `BaseSet.load_image` at 1 and 4 on every committed fixture (JPEG, PNG,
  BMP, GIF, TIFF: each colour type, palette, transparency and depth they
  hold), bit-equal to the JAX package's `np.asarray` of its image; an
  `img_arr` record unconverted in both.
- Every transform on L: `tests/data/transforms/manifest.json` holds the
  square region as L through every op and transform
  (`test_torch_transforms.py` runs them); here, that the manifest covers
  them all.
- The ImageNet recipe's host pipeline (TrivialAugment, RandomErasing with
  `value` 0 as the chip check's HOST_CUTS, at 40 px; mixup off) at
  `img_channels: 1` on a tree of JPEG, PNG, BMP, GIF and TIFF content:
  every batch equal to the JAX loader's (float32 within 1e-6; L broadcast
  to [H, W, 3] by Normalize in both), then the first train step of an APLA
  ViT (2 blocks at vit_tiny's widths) from one init: loss and grad norm
  within 1e-4 (`tests/test_torch_datasets.py`'s tolerance).
- Raw mode (`device_augment`) at 1: the 2-D uint8 samples equal to JAX's;
  the device augmentation refuses the [B, H, W] batch, as the JAX one does
  when its step is traced.
- RGBA: the recipe's transforms raise where the JAX ones raise
  (Normalize's ValueError, an `ImageOps` op's OSError, the same type for
  each draw), a four-entry mean gives the patch embedding four bands and
  both models refuse them, and `compute_stats` of a set with no transform
  equals JAX's.
"""

import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.data import datasets as jdata
from apla_tpu.data import device_augs as jdevice
from apla_tpu.train import losses as jlosses
from apla_tpu.train import steps as jsteps
from apla_tpu.train.optim import build_optimizer as jbuild
from apla_tpu.train.train_state import TrainState as JState
from apla_tpu.utils.config import EDict, load_merged_params
from apla_tpu.wrapper import DefaultWrapper as JaxWrapper
from apla_tpu_torch.data import datasets as tdata
from apla_tpu_torch.data import device_augs as tdevice
from apla_tpu_torch.data import transforms as tt
from apla_tpu_torch.train import losses as tlosses
from apla_tpu_torch.train import steps as tsteps
from apla_tpu_torch.train.optim import build_optimizer
from apla_tpu_torch.train.train_state import TrainState
from apla_tpu_torch.wrapper import DefaultWrapper
from tests.test_torch_datasets import _tiny_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
FORMATS = ("jpeg", "png", "bmp", "gif", "tiff")
TINY_RECIPE = os.path.join(ROOT, "params", "synthetic", "vit_tiny",
                           "apla.yml")
IMAGENET_RECIPE = os.path.join(ROOT, "params", "finetune", "dinov2",
                               "ImageNet", "vit_b", "apla.yml")
CLASSES = ("n01440764", "n01443537")
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixtures(kind):
    d = os.path.join(DATA, kind)
    return [os.path.join(d, n) for n in sorted(os.listdir(d))
            if n != "manifest.json" and not n.startswith("refused_")]


def _bare(module, channels):
    ds = module.BaseSet.__new__(module.BaseSet)
    ds.img_channels = channels
    return ds


@pytest.mark.parametrize("channels", [1, 4])
@pytest.mark.parametrize("kind", FORMATS)
def test_load_image_matches_jax(kind, channels):
    ours, ref = _bare(tdata, channels), _bare(jdata, channels)
    for path in _fixtures(kind):
        rec = {"img_path": path, "label": 0}
        got, want = ours.load_image(rec), np.asarray(ref.load_image(rec))
        assert got.dtype == want.dtype == np.uint8, path
        assert got.shape == want.shape, path
        assert got.ndim == (2 if channels == 1 else 3), path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_array_records_stay_unconverted():
    arr = np.random.default_rng(0).integers(0, 256, (5, 6, 3), np.uint8)
    for channels in (1, 4):
        got = _bare(tdata, channels).load_image({"img_arr": arr})
        want = np.asarray(_bare(jdata, channels).load_image({"img_arr": arr}))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (5, 6, 3)


def test_transform_manifest_covers_l():
    with open(os.path.join(DATA, "transforms", "manifest.json")) as f:
        m = json.load(f)
    assert m["regions"]["grey"]["mode"] == "L"
    grey = [c for c in m["cases"] if c["image"] == "grey"]
    assert {c["op"] for c in grey if "op" in c} == set(tt.OPS)
    names = {n for c in grey if "transform" in c for n in c["transform"]}
    assert set(tt.ORDER) | {"RandomErasing"} <= names
    # the host pipelines end in [H, W, 3] float32 (Normalize's broadcast)
    shipped = [c for c in grey if c["id"].startswith(
        "transform/imagenet_train/")]
    assert shipped and all(c["shape"] == [40, 40, 3] for c in shipped)


# --------------------------------------------------------------------------- #
# the ImageNet recipe on a tree of every format
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """ImageNet's layout, `.JPEG` names over the fixtures of each format
    (round-robin, three per class and split)."""
    root = tmp_path_factory.mktemp("grey")
    files = [p for kind in FORMATS for p in _fixtures(kind)
             if "_224" not in p]
    k = 0
    for split in ("train", "val"):
        for wnid in CLASSES:
            d = root / "ImageNet" / split / wnid
            d.mkdir(parents=True)
            for i in range(3):
                shutil.copy(files[(7 * k) % len(files)],
                            d / f"{wnid}_{i}.JPEG")
                k += 1
    return str(root)


def _transforms():
    """The ImageNet recipe's train and val transforms at 48 / 40 px, with
    RandomErasing's `value` 0 and mixup off."""
    ds = load_merged_params(IMAGENET_RECIPE).dataset_params
    train = copy.deepcopy(dict(ds.train_transforms))
    train["Resize"].update(height=48, width=48)
    train["RandomResizedCrop"]["size"] = 40
    train["RandomErasing"]["value"] = 0
    train["advanced_aug"] = False
    val = copy.deepcopy(dict(ds.val_transforms))
    val["Resize"].update(height=48, width=48)
    val["CenterCrop"].update(height=40, width=40)
    return {"train_transforms": train, "val_transforms": val,
            "test_transforms": val}


def _params(tree, channels, **extra):
    params = load_merged_params(TINY_RECIPE)
    params.dataset_params = EDict({"dataset": "ImageNet",
                                   "data_location": tree,
                                   "img_channels": channels,
                                   **_transforms(), **extra})
    for ld in params.dataloader_params.values():
        ld.update(batch_size=4, num_workers=0)
    params.training_params.update(epochs=1, is_dry=True,
                                  use_mixed_precision=False)
    params.system_params.device = "cpu"
    return params


def _batches(loader):
    loader.set_epoch(0)
    return list(loader)


def test_grey_recipe_batches_and_first_step_match_jax(tree):
    params = _params(tree, 1)
    ours = DefaultWrapper(params).init_dataloaders()
    ref = JaxWrapper(params).init_dataloaders()
    for name in ("trainloader", "valloader"):
        got, want = _batches(ours[name]), _batches(ref[name])
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert tuple(a["image"].shape) == b["image"].shape
            assert b["image"].shape[1:] == (40, 40, 3)
            np.testing.assert_allclose(a["image"].numpy(), b["image"],
                                       rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a["label"].numpy(), b["label"])
    batch = _batches(ours.trainloader)[0]
    jcfg, tcfg, trainable, frozen, model = _tiny_models(1000)
    tx = jbuild("AdamW", {"lr": 1e-3, "weight_decay": 0.05}, trainable,
                grad_clip=1.0)
    jstep = jsteps.make_train_step(jcfg, tx, jlosses.cross_entropy)
    _, jm = jstep(JState.create(trainable, tx), frozen,
                  {"image": jnp.asarray(batch["image"].numpy()),
                   "label": jnp.asarray(batch["label"].numpy())}, 1e-3,
                  jax.random.PRNGKey(0))
    opt = build_optimizer("AdamW", {"lr": 1e-3, "weight_decay": 0.05},
                          [(n, p) for n, p in model.named_parameters()
                           if p.requires_grad], grad_clip=1.0)
    tstep = tsteps.make_train_step(tcfg, opt, tlosses.cross_entropy)
    _, m = tstep(TrainState(0, model, opt), batch, 1e-3,
                 torch.Generator().manual_seed(0))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_grey_raw_mode_matches_jax_and_device_augment_refuses(tree):
    ours = tdata.ImageNet(_params(tree, 1).dataset_params, "train")
    ref = jdata.ImageNet(_params(tree, 1).dataset_params, "train")
    for ds in (ours, ref):
        ds.raw_mode, ds.raw_size = True, 36
    for i in range(len(ref)):
        got, want = ours[i]["image"], ref[i]["image"]
        assert got.shape == want.shape == (36, 36) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want,
                                      err_msg=ref.data[i]["img_path"])
    batch = np.stack([ours[i]["image"] for i in range(4)])
    cfg = tdevice.DeviceAugConfig(out_size=32)
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\]"):
        tdevice.device_augment(torch.from_numpy(batch),
                               torch.Generator().manual_seed(0), cfg)
    with pytest.raises(Exception):
        jdevice.device_augment(jnp.asarray(batch), jax.random.PRNGKey(0),
                               jdevice.DeviceAugConfig(out_size=32))


def test_rgba_raises_where_jax_raises(tree):
    for mode in ("train", "val"):
        ours = tdata.ImageNet(_params(tree, 4).dataset_params, mode)
        ref = jdata.ImageNet(_params(tree, 4).dataset_params, mode)
        kinds = set()
        for i in range(len(ref)):
            for seed in range(3):
                errs = []
                for ds in (ours, ref):
                    try:
                        ds.__getitem__(i, rng=np.random.default_rng(seed))
                        errs.append(None)
                    except (ValueError, OSError) as e:
                        errs.append(type(e))
                assert errs[0] == errs[1] is not None, (mode, i, seed, errs)
                kinds.add(errs[0])
        assert ValueError in kinds
    # four entries in the mean: four bands reach the 3-band patch embedding
    four = dict(mean=(0.5,) * 4, std=(0.25,) * 4)
    ours = tdata.ImageNet(_params(tree, 4, **four).dataset_params, "val")
    ref = jdata.ImageNet(_params(tree, 4, **four).dataset_params, "val")
    x = np.stack([ours[i]["image"] for i in range(2)])
    assert x.shape == (2, 40, 40, 4) == np.stack(
        [ref[i]["image"] for i in range(2)]).shape
    jcfg, tcfg, trainable, frozen, model = _tiny_models(10)
    with pytest.raises(RuntimeError):
        model(torch.from_numpy(x))
    from apla_tpu.models.classifier import classifier_forward
    with pytest.raises(Exception):
        classifier_forward(trainable, frozen, jnp.asarray(x), jcfg)


def test_rgba_compute_stats_matches_jax(tree):
    stats = []
    for module in (tdata, jdata):
        ds = module.ImageNet(_params(tree, 4).dataset_params, "train")
        ds.transform = ds.resizing = None
        loader = [{"image": np.asarray(ds[i]["image"])[None]}
                  for i in range(len(ds))]
        assert loader[0]["image"].shape[-1] == 4
        stats.append(module.compute_stats(loader))
    for a, b in zip(*stats):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
