"""The port's host multi-crop against the JAX package's, on the CPU.

With `dataset_params.device_augment` off, the SSL wrappers turn the train
transforms into one host pipeline per crop (`ssl/multicrop.py`'s
strategies: BYOL and SimSiam 2 globals; DINO 2 globals and 8 locals;
DINOv2 2 globals and 8 locals), the loader ships one float32 batch per
crop, and the steps take the ready crops.  Held here, on the hermetic
synthetic recipes (`params/synthetic/vit_tiny/*.yml`, 32 px, globals 32,
locals 16):

- one sample's crops from the port's dataset bit-equal to the JAX
  dataset's for the same generator, and the same draws consumed;
- a batch through each package's collate (the per-crop lists; the iBOT
  collate's crop stacks and mask buffers) and through each package's
  loader (the same shuffle and per-sample generators) bit-equal;
- each wrapper on the host path with `device_augment` off (no device crop
  configs, the dataset not in raw mode, the loader's first batch made of
  float32 crops) and on the device path with it on;
- `tools/profile_host_crops.py`, which times the host crops' steps, runs.

One host-crop step of each objective against the JAX step is in the
objectives' own files (`test_host_crop_step_matches_jax` in
`test_torch_byol.py`, `test_torch_dino.py`, `test_torch_dinov2_step.py`).
"""

import copy
import os

import numpy as np
import pytest
import torch

from apla_tpu.data import datasets as jds
from apla_tpu.data import loader as jloader
from apla_tpu.ssl import dinov2 as jd2
from apla_tpu.ssl import multicrop as jmc
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.data import datasets as tds
from apla_tpu_torch.data import loader as tloader
from apla_tpu_torch.ssl import byol as tb
from apla_tpu_torch.ssl import dino as tdino
from apla_tpu_torch.ssl import dinov2 as td2
from apla_tpu_torch.ssl import multicrop as tmc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
# objective -> (recipe, strategy, crops)
OBJECTIVES = {"byol": ("byol.yml", "byol", 2),
              "simsiam": ("byol.yml", "byol", 2),
              "dino": ("dino.yml", "dino", 10),
              "dinov2": ("dinov2.yml", "dinov2", 10)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(objective, device_augment=False):
    path = os.path.join(ROOT, "params", "synthetic", "vit_tiny",
                        OBJECTIVES[objective][0])
    params = load_merged_params(path)
    params.dataset_params.synthetic_size = 2 * B
    params.dataset_params.device_augment = device_augment
    params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.update(batch_size=B, num_workers=0)
    return params


def _datasets(objective):
    """(JAX train set, port train set) under the objective's strategy."""
    strategy = OBJECTIVES[objective][1]
    params = _params(objective)
    jp = jmc.apply_augmentation_strategy(copy.deepcopy(params), strategy)
    tp = tmc.apply_augmentation_strategy(copy.deepcopy(params), strategy)
    assert jp.dataset_params.train_transforms == \
        tp.dataset_params.train_transforms
    return (jds.Synthetic(jp.dataset_params, "train"),
            tds.Synthetic(tp.dataset_params, "train"))


def _ibot_collates(params):
    args = (2, 8, tuple(params.model_params.dinov2.ibot.mask_ratio_min_max),
            float(params.model_params.dinov2.ibot.mask_sample_probability),
            16)
    return (jd2.make_ibot_collate(*args, jd2.MaskingGenerator(
                (4, 4), max_num_patches=8), raw_mode=False, seed=0),
            td2.IBotCollate(*args, td2.MaskingGenerator(
                (4, 4), max_num_patches=8), raw_mode=False, seed=0,
                batches_per_epoch=2))


def _assert_batches_equal(got, want):
    assert set(got) == {k for k, v in want.items() if v is not None}
    for k, v in want.items():
        if v is None:
            continue
        g = got[k]
        if isinstance(v, list):
            assert isinstance(g, list) and len(g) == len(v), k
            for i, (a, b) in enumerate(zip(g, v)):
                np.testing.assert_array_equal(np.asarray(a), b,
                                              err_msg=f"{k}[{i}]")
                assert np.asarray(a).dtype == b.dtype, k
        else:
            np.testing.assert_array_equal(np.asarray(g), v, err_msg=k)


@pytest.mark.parametrize("objective", ["byol", "dino", "dinov2"])
def test_sample_crops_match_jax(objective):
    """Every crop of a sample bit-equal, float32, at the strategy's sizes,
    and the generator left where JAX leaves it."""
    n_crops = OBJECTIVES[objective][2]
    jset, tset = _datasets(objective)
    assert isinstance(tset.transform, list) and len(tset.transform) == \
        len(jset.transform) == n_crops
    def steps(pipelines):
        return [[type(x).__name__ for x in t.transforms] for t in pipelines]
    assert steps(tset.transform) == steps(jset.transform)
    sizes = {"byol": [32, 32], "dino": [32, 32] + [16] * 8,
             "dinov2": [32, 32] + [16] * 8}[objective]
    for i in range(4):
        g1, g2 = np.random.default_rng((0, 0, i)), np.random.default_rng(
            (0, 0, i))
        got = tset.__getitem__(i, rng=g1)
        want = jset.__getitem__(i, rng=g2)
        assert g1.random() == g2.random(), i
        assert got["label"] == want["label"]
        assert [c.shape[0] for c in got["image"]] == sizes
        for c, (a, b) in enumerate(zip(got["image"], want["image"])):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"sample {i} "
                                                        f"crop {c}")


def _numpy(batch):
    return {k: [x.numpy() for x in v] if isinstance(v, list) else v.numpy()
            for k, v in batch.items()}


def _first_batches(objective, params, seed=3):
    """(the port loader's first train batch as numpy, the JAX loader's)
    under the objective's strategy: shuffled, drop_last, the same seed."""
    strategy = OBJECTIVES[objective][1]
    jp = jmc.apply_augmentation_strategy(copy.deepcopy(params), strategy)
    tp = tmc.apply_augmentation_strategy(copy.deepcopy(params), strategy)
    jset = jds.Synthetic(jp.dataset_params, "train")
    tset = tds.Synthetic(tp.dataset_params, "train")
    if objective == "dinov2":
        jcol, tcol = _ibot_collates(params)
    else:
        jcol, tcol = jloader.default_collate, tloader.default_collate
    kw = dict(batch_size=int(params.dataloader_params.trainloader.batch_size),
              shuffle=True, drop_last=True, seed=seed)
    want = next(iter(jloader.DataLoader(jset, num_workers=2,
                                        collate_fn=jcol, **kw)))
    got = next(iter(tloader.DataLoader(tset, num_workers=0, collate_fn=tcol,
                                       **kw)))
    return _numpy(got), want


def host_batch(objective, params):
    """The first train batch of host crops for `params` (`device_augment`
    off) under `objective`'s strategy: the JAX loader's, after holding the
    port loader's to it bit for bit.  The objectives' step tests feed it to
    both steps."""
    got, want = _first_batches(objective, params, seed=0)
    _assert_batches_equal(got, want)
    return want


@pytest.mark.parametrize("objective", ["byol", "dino", "dinov2"])
def test_collate_and_loader_batches_match_jax(objective):
    """The collates on the same samples, then the first batch of each
    package's loader (its shuffle, its per-sample generators): bit-equal,
    the iBOT mask buffers included."""
    jset, tset = _datasets(objective)
    samples = [jset.__getitem__(i, rng=np.random.default_rng(i))
               for i in range(B)]
    if objective == "dinov2":
        jcol, tcol = _ibot_collates(_params(objective))
        _assert_batches_equal(tcol(samples, batch_key=(0, 0)),
                              jcol(samples))
    else:
        got = tloader.default_collate(samples)
        assert isinstance(got["image"], list) and len(got["image"]) == \
            OBJECTIVES[objective][2]
        _assert_batches_equal(got, jloader.default_collate(samples))
    _assert_batches_equal(*_first_batches(objective, _params(objective)))


def _wrapper(objective, device_augment):
    params = _params(objective, device_augment)
    if objective in ("byol", "simsiam"):
        w = tb.BYOLWrapper(params, use_momentum=objective == "byol")
    elif objective == "dino":
        w = tdino.DINOWrapper(params)
    else:
        w = td2.DINOv2Wrapper(params)
    w.dataloaders = w.init_dataloaders()
    return w


@pytest.mark.parametrize("device_augment", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_wrapper_takes_the_host_path_unless_device_augment(objective,
                                                           device_augment):
    """Off: no device crop configs, per-crop host pipelines, the loader's
    first batch float32 crops at the strategy's sizes (the DINOv2 collate's
    crop stacks).  On: crop configs, raw mode, one uint8 image a sample."""
    n_crops = OBJECTIVES[objective][2]
    w = _wrapper(objective, device_augment)
    trainset = w.dataloaders.trainloader.dataset
    batch = next(iter(w.dataloaders.trainloader))
    if not device_augment:
        assert w.ssl_device_crop_cfgs is None and not trainset.raw_mode
        assert isinstance(trainset.transform, list) and \
            len(trainset.transform) == n_crops
        if objective == "dinov2":
            assert "raw_images" not in batch
            assert tuple(batch["collated_global_crops"].shape) == \
                (2 * B, 32, 32, 3)
            assert tuple(batch["collated_local_crops"].shape) == \
                (8 * B, 16, 16, 3)
            assert batch["collated_global_crops"].dtype == torch.float32
        else:
            views = batch["image"]
            assert isinstance(views, list) and len(views) == n_crops
            assert [tuple(v.shape) for v in views] == \
                [(B, 32, 32, 3)] * 2 + [(B, 16, 16, 3)] * (n_crops - 2)
            assert all(v.dtype == torch.float32 for v in views)
    else:
        assert len(w.ssl_device_crop_cfgs) == n_crops and trainset.raw_mode
        images = batch["raw_images" if objective == "dinov2" else "image"]
        assert images.dtype == torch.uint8 and images.shape[0] == B


def test_profile_host_crops_tool_runs(capsys):
    """tools/profile_host_crops.py times every step of the dinov2
    strategy's ten pipelines and the host ops they rest on."""
    import json
    import sys
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import profile_host_crops
    finally:
        sys.path.pop(0)
    assert profile_host_crops.main(["--images", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"RandomResizedCrop", "RandomGaussianBlur", "RandomSolarize",
            "NativeToArrayNormalize"} <= set(out["steps_ms"])
    assert out["ms_per_image"] > 0 and len(out["ops_ms_224"]) == 8
