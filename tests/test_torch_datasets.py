"""The port's ImageNet reader, its datasets' machinery and the supervised
slice on a JPEG tree, against the JAX package.

The test writes an ILSVRC-layout tree (copies of the committed JPEG
fixtures under `.JPEG` and `.jpg` names, CMYK and a PNG stream among
them, and one `.png` twin that both readers prefer) and holds:

- `ImageNet`: the record lists and labels of every mode equal to the JAX
  class's; `__getitem__` raw (at 40 and at 256: the DCT-scaled path and
  the Pillow path) uint8 bit-equal, and through the recipe's transforms
  (Resize, RandomResizedCrop, HorizontalFlip, ColorJitter, Normalize, and
  the val/test Resize + CenterCrop) float32 within 1e-6 from the same
  generator;
- `BaseSet.get_validation_ids`: the split and the `val_ids.json` the JAX
  package writes, reused, rewritten when the sizes change;
- the supervised wrapper (`device_augment` true and false): every batch of
  its train, val and test loaders equal to the JAX wrapper's (uint8 bit for
  bit, float32 within 1e-6); on the host path three train steps of an
  APLA ViT at `params/synthetic/vit_tiny`'s widths (2 blocks) from one
  init, JAX's and the port's, on those batches: loss, grad norm and logits
  within the float32 rtol = atol = 1e-4 of `tests/test_torch_train_step.py`;
  on the raw path the port's `Trainer` takes three steps with finite
  losses (its on-device augmentation draws from torch's generator, so the
  losses are not JAX's; `tests/test_torch_data.py` holds that augmentation
  to JAX's with the draws fed in);
- the side-cars: a COCO set of JPEGs read as the JAX reader reads it, and
  `serve predict`'s image files (a JPEG, a PNG under a `.jpg` name)
  decoded, resized and normalised as the JAX CLI does.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.data import datasets as jdata
from apla_tpu.data.detection_data import CocoDetection as JCoco
from apla_tpu.models import classifier as jclf
from apla_tpu.models import vit as jvit
from apla_tpu.train import losses as jlosses
from apla_tpu.train import steps as jsteps
from apla_tpu.train.optim import build_optimizer as jbuild
from apla_tpu.train.train_state import TrainState as JState
from apla_tpu.utils.config import EDict, load_merged_params
from apla_tpu.wrapper import DefaultWrapper as JaxWrapper
from apla_tpu_torch import serve as tserve
from apla_tpu_torch.data import datasets as tdata
from apla_tpu_torch.data import detection_data as tdd
from apla_tpu_torch.models import classifier as tclf
from apla_tpu_torch.models import vit as tvit
from apla_tpu_torch.train import losses as tlosses
from apla_tpu_torch.train import steps as tsteps
from apla_tpu_torch.train.optim import build_optimizer
from apla_tpu_torch.train.train_state import TrainState
from apla_tpu_torch.train.trainer import Trainer
from apla_tpu_torch.utils.pretrained import params_from_jax
from apla_tpu_torch.wrapper import DefaultWrapper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
TINY_RECIPE = os.path.join(ROOT, "params", "synthetic", "vit_tiny",
                           "apla.yml")
TOL = 1e-4
CLASSES = ("n01440764", "n01443537", "n02102040")

# The ImageNet recipe's transforms (params/finetune/dinov2/ImageNet/vit_b/
# __common__.yml) at the tiny model's sizes
TRANSFORMS = {
    "train_transforms": {
        "Resize": {"apply": True, "height": 40, "width": 40},
        "HorizontalFlip": {"apply": True, "p": 0.5},
        "ColorJitter": {"apply": True, "brightness": 0.2, "contrast": 0.2,
                        "saturation": 0.1, "hue": 0.1, "p": 0.8},
        "RandomResizedCrop": {"apply": True, "size": 32,
                              "scale": [0.8, 1.2]},
        "Normalize": True},
    "val_transforms": {
        "Resize": {"apply": True, "height": 40, "width": 40},
        "CenterCrop": {"apply": True, "height": 32, "width": 32},
        "Normalize": True},
}
TRANSFORMS["test_transforms"] = TRANSFORMS["val_transforms"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_imagenet(root, n_train=4, n_val=2):
    """<root>/ImageNet/{train,val}/<wnid>/: the fixtures copied round-robin
    under new names, `.JPEG` and `.jpg` in turn, plus a `.png` twin of the
    first training image (read instead of it by both packages)."""
    fixtures = sorted(n for n in os.listdir(FIXTURES)
                      if n != "manifest.json")
    k = 0
    for split, n in (("train", n_train), ("val", n_val)):
        for c, wnid in enumerate(CLASSES):
            d = os.path.join(root, "ImageNet", split, wnid)
            os.makedirs(d)
            for i in range(n):
                ext = ".JPEG" if i % 2 == 0 else ".jpg"
                shutil.copy(os.path.join(FIXTURES,
                                         fixtures[k % len(fixtures)]),
                            os.path.join(d, f"{wnid}_{i}{ext}"))
                k += 1
    first = os.path.join(root, "ImageNet", "train", CLASSES[0],
                         f"{CLASSES[0]}_0")
    tdd.write_png(first + ".png", np.full((20, 30, 3), 77, np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_imagenet(tmp_path_factory.mktemp("data"))


def _params(tree, **extra):
    return {"dataset": "ImageNet", "data_location": tree, **TRANSFORMS,
            **extra}


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_imagenet_records_match_jax(tree, mode):
    ours = tdata.get_dataset_class("ImageNet")(_params(tree), mode)
    ref = jdata.ImageNet(_params(tree), mode)
    assert ours.data == ref.data and len(ours) == len(ref) > 0
    assert (ours.n_classes, ours.mean, ours.std) == \
        (ref.n_classes, ref.mean, ref.std)
    assert sorted({r["label"] for r in ours.data}) == [0, 1, 2]


@pytest.mark.parametrize("raw_size", [40, 256])
def test_imagenet_raw_samples_match_jax(tree, raw_size):
    ours = tdata.ImageNet(_params(tree), "train")
    ref = jdata.ImageNet(_params(tree), "train")
    for ds in (ours, ref):
        ds.raw_mode, ds.raw_size = True, raw_size
    for i in range(len(ref)):
        got, want = ours[i], ref[i]
        assert got["image"].dtype == np.uint8
        assert got["image"].shape == (raw_size, raw_size, 3)
        np.testing.assert_array_equal(got["image"], want["image"],
                                      err_msg=ref.data[i]["img_path"])
        assert got["label"] == want["label"]


@pytest.mark.parametrize("mode", ["train", "val"])
def test_imagenet_transformed_samples_match_jax(tree, mode):
    ours = tdata.ImageNet(_params(tree), mode)
    ref = jdata.ImageNet(_params(tree), mode)
    for i in range(len(ref)):
        for seed in (0, 1):
            g1 = np.random.default_rng((seed, i))
            g2 = np.random.default_rng((seed, i))
            got = ours.__getitem__(i, rng=g1)
            want = ref.__getitem__(i, rng=g2)
            assert got["image"].dtype == np.float32
            assert got["image"].shape == (32, 32, 3)
            np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                                       atol=1e-6)
            assert g1.random() == g2.random()


def test_validation_ids_match_jax(tmp_path):
    def both(total, val, name="val_ids.json"):
        a = tdata.BaseSet.get_validation_ids(total, val,
                                             str(tmp_path / "t" / name), "x")
        b = jdata.BaseSet.get_validation_ids(total, val,
                                             str(tmp_path / "j" / name), "x")
        assert a == b
        with open(tmp_path / "t" / name) as f, \
                open(tmp_path / "j" / name) as g:
            assert json.load(f) == json.load(g)
        return a

    train, val = both(50, 0.2)                   # fresh: written
    assert len(val) == 10 and sorted(train + val) == list(range(50))
    assert both(50, 0.2) == (train, val)         # persisted: reused
    assert both(60, 0.2) != (train, val)         # sizes changed: rewritten
    for d in ("t", "j"):                         # an old bare-list file
        with open(tmp_path / d / "old.json", "w") as f:
            json.dump([3, 1, 4], f)
    assert both(10, 3, "old.json") == (
        [0, 2, 5, 6, 7, 8, 9], [3, 1, 4])


def _wrapper_params(tree, device_augment):
    params = load_merged_params(TINY_RECIPE)
    params.dataset_params = EDict(_params(tree,
                                          device_augment=device_augment))
    for ld in params.dataloader_params.values():
        ld.update(batch_size=4, num_workers=0)
    params.training_params.update(epochs=1, log_every=1, is_dry=True,
                                  use_mixed_precision=False)
    params.system_params.device = "cpu"
    return params


def _loaders(params):
    ours = DefaultWrapper(params).init_dataloaders()
    ref = JaxWrapper(params).init_dataloaders()
    return ours, ref


def _same_batches(ours, ref):
    got, want = list(ours), list(ref)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        img = a["image"].numpy()
        if img.dtype == np.uint8:
            np.testing.assert_array_equal(img, b["image"])
        else:
            np.testing.assert_allclose(img, b["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])
    return got


def _tiny_models(n_classes):
    kw = dict(img_size=32, patch_size=8, embed_dim=192, depth=2,
              num_heads=3)
    jcfg = jvit.ViTConfig(compute_dtype=jnp.float32, **kw)
    tcfg = tvit.ViTConfig(compute_dtype=torch.float32, **kw)
    trainable, frozen = jclf.init_classifier(
        jax.random.PRNGKey(0), jcfg, n_classes,
        apla_cfg=JAplaConfig(partial_size=16))
    t_state, f_state = params_from_jax(jax.tree.map(np.asarray, trainable),
                                       jax.tree.map(np.asarray, frozen))
    model = tclf.classifier_from_state(tcfg, t_state, f_state,
                                       torch.device("cpu"))
    return jcfg, tcfg, trainable, frozen, model


def test_host_path_batches_and_losses_match_jax(tree):
    """device_augment false: the recipe's host transforms in the loaders,
    then three train steps from one init."""
    ours, ref = _loaders(_wrapper_params(tree, False))
    for name in ("valloader", "testloader"):
        _same_batches(ours[name], ref[name])
    ours.trainloader.set_epoch(0)
    ref.trainloader.set_epoch(0)
    batches = _same_batches(ours.trainloader, ref.trainloader)[:3]
    assert batches[0]["image"].dtype == torch.float32
    jcfg, tcfg, trainable, frozen, model = _tiny_models(1000)
    tx = jbuild("AdamW", {"lr": 1e-3, "weight_decay": 0.05}, trainable,
                grad_clip=1.0)
    jstate = JState.create(trainable, tx)
    jstep = jsteps.make_train_step(jcfg, tx, jlosses.cross_entropy)
    opt = build_optimizer("AdamW", {"lr": 1e-3, "weight_decay": 0.05},
                          [(n, p) for n, p in model.named_parameters()
                           if p.requires_grad], grad_clip=1.0)
    state = TrainState(0, model, opt)
    tstep = tsteps.make_train_step(tcfg, opt, tlosses.cross_entropy)
    gen, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(0)
    for i, b in enumerate(batches):
        x, y = b["image"].numpy(), b["label"].numpy()
        jstate, jm = jstep(jstate, frozen, {"image": jnp.asarray(x),
                                            "label": jnp.asarray(y)}, 1e-3,
                           key)
        state, m = tstep(state, {"image": b["image"], "label": b["label"]},
                         1e-3, gen)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(m["logits"].numpy(),
                                   np.asarray(jm["logits"]), rtol=TOL,
                                   atol=TOL)


def test_raw_path_batches_match_jax_and_trainer_steps(tree):
    """device_augment true: uint8 images at the Resize size from both
    loaders; then the port's Trainer takes its three steps."""
    params = _wrapper_params(tree, True)
    ours, ref = _loaders(params)
    ours.trainloader.set_epoch(0)
    ref.trainloader.set_epoch(0)
    got = _same_batches(ours.trainloader, ref.trainloader)
    assert got[0]["image"].dtype == torch.uint8
    assert tuple(got[0]["image"].shape) == (4, 40, 40, 3)
    _same_batches(ours.valloader, ref.valloader)
    params.training_params.save_dir = str(os.path.join(tree, "ckpt"))
    wrapper = DefaultWrapper(params)
    wrapper.instantiate()
    trainer = Trainer(wrapper)
    trainer.train()
    losses = [r["train_loss"] for _, r in trainer.history
              if "train_loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_coco_jpeg_set_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    images, anns = [], []
    for i, (h, w, sub) in enumerate([(60, 80, 2), (75, 50, 0), (33, 47, 1)]):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"im{i}.jpg", quality=85,
                                  subsampling=sub)
        images.append({"id": i, "file_name": f"im{i}.jpg", "width": w,
                       "height": h})
        anns.append({"id": i + 1, "image_id": i, "category_id": 5,
                     "bbox": [2.0, 3.0, w / 2, h / 3], "iscrowd": 0})
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": 5, "name": "x"}]}))
    ours = tdd.CocoDetection(str(img_dir), str(ann), img_size=40)
    ref = JCoco(str(img_dir), str(ann), img_size=40)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_serve_predict_reads_jpeg_files(tmp_path):
    """`serve predict`'s image files: decoded by content, resized BICUBIC,
    normalised, as the JAX CLI's Pillow path does (apla_tpu/serve.py)."""
    rng = np.random.default_rng(4)
    paths = [str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")]
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), np.uint8)).save(
        paths[0], format="JPEG", quality=80)
    Image.fromarray(rng.integers(0, 256, (30, 20, 3), np.uint8)).save(
        paths[1], format="PNG")
    mean, std = "0.485,0.456,0.406", "0.229,0.224,0.225"
    got = tserve._load_inputs(paths, 28, mean, std)
    m = np.asarray([float(v) for v in mean.split(",")], np.float32)
    s = np.asarray([float(v) for v in std.split(",")], np.float32)
    want = np.stack([
        (np.asarray(Image.open(p).convert("RGB").resize((28, 28),
                                                        Image.BICUBIC),
                    np.float32) / 255.0 - m) / s for p in paths])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("raw_knob", [None, 48])
def test_ssl_wrappers_decode_at_the_jax_raw_size(tree, raw_knob):
    """The BYOL/DINO/DINOv2 wrappers ship one uint8 image per sample at
    the JAX package's raw size, max(device_raw_size or int(global * 8 /
    7), global), decoded as the JAX package decodes it."""
    from apla_tpu.ssl.byol import BYOLWrapper as JBYOLWrapper
    from apla_tpu_torch.ssl.byol import BYOLWrapper
    params = load_merged_params(os.path.join(ROOT, "params", "synthetic",
                                             "vit_tiny", "byol.yml"))
    params.dataset_params = EDict(_params(tree, device_augment=True,
                                          ssl_global_size=32))
    if raw_knob:
        params.dataset_params.device_raw_size = raw_knob
    for ld in params.dataloader_params.values():
        ld.update(batch_size=4, num_workers=0)
    params.system_params.device = "cpu"
    ours = BYOLWrapper(params).init_dataloaders().trainloader.dataset
    ref = JBYOLWrapper(params).init_dataloaders().trainloader.dataset
    assert ours.raw_mode and ref.raw_mode
    assert ours.raw_size == ref.raw_size == (raw_knob or 36)
    for i in (0, 5):
        np.testing.assert_array_equal(ours[i]["image"], ref[i]["image"])
