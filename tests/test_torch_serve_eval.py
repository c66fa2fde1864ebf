"""`serve export --pretrained_path` and `serve eval` of the port, against
the JAX package's CLI on the same weights and on files the test writes.

- *Classifier*: `tests/test_quant.py`'s ViT (2 blocks, C = 64) registered
  as `vit_micro` in both builder tables, APLA-16, f32, from a recipe the
  test writes (`params/synthetic/vit_tiny/apla.yml` cut to 64 images,
  in-process loaders).  One JAX tree is saved as a JAX checkpoint and, by
  `params_from_jax`, as a port checkpoint; each CLI exports it with
  `--pretrained_path`, then `eval --knn` scores the artifact on the test
  split.  The tables must read the same (accuracy, kappa, ..., kNN), the
  served logits within 1e-4, and the port's table must read what the
  trainer's own `--test --knn` of the checkpoint reads.
- *Detector*: `tests/test_torch_quant.py`'s Swin FCOS detector (f32, the
  classification prior and the boxes set so random weights detect),
  exported by each
  package, `eval --det_img_dir --det_ann` over a COCO set of PNGs: the
  same mAP@50.
- *Segmenter*: `tests/test_torch_quant.py`'s "full" SETR-PUP segmenter,
  `eval --seg_root` over an ADE20K-layout set, at the crop and with
  sliding windows (`--eval_img_size`, `--eval_stride`): the same mIoU.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from apla_tpu import serve as jserve
from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.models import classifier as jclf
from apla_tpu.models import vit as jvit
from apla_tpu.train import checkpoint as jckpt
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch import main as tmain
from apla_tpu_torch import serve as tserve
from apla_tpu_torch.data.detection_data import write_png
from apla_tpu_torch.models import vit as tvit
from apla_tpu_torch.train import checkpoint as tckpt
from apla_tpu_torch.utils.pretrained import params_from_jax
from tests.test_torch_quant import _jax_det, _jax_seg, _port_model

TOL = 1e-4
YML = os.path.join(os.path.dirname(__file__), "..", "params", "synthetic",
                   "vit_tiny", "apla.yml")
MICRO = dict(embed_dim=64, depth=2, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def vit_micro(monkeypatch):
    """`vit_micro` in both builder tables: `tests/test_quant.py`'s CFG."""
    for mod in (jvit, tvit):
        def build(_cfg=mod.ViTConfig, **kw):
            kw.setdefault("qkv_bias", True)
            return _cfg(**MICRO, **kw)
        monkeypatch.setitem(mod.VIT_BUILDERS, "vit_micro", build)


def _results(text: str, title: str) -> dict:
    """The `key : value` rows printed under an `EVAL RESULTS` / `TEST
    RESULTS` title."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith(title))
    out = {}
    for ln in lines[start + 1:]:
        if " : " not in ln:
            break
        k, v = ln.split(" : ", 1)
        out[k.strip()] = v.strip()
    return out


def _recipe(tmp_path) -> str:
    params = load_merged_params(YML)
    params.model_params.backbone_type = "vit_micro"
    params.training_params.use_mixed_precision = False
    params.dataset_params.synthetic_size = 64
    for ld in params.dataloader_params.values():
        ld.update(batch_size=16, num_workers=0)
    path = str(tmp_path / "recipe.json")
    with open(path, "w") as f:
        json.dump(params, f)
    return path


def _checkpoints(tmp_path):
    """One seeded APLA-16 classifier tree (its trainables moved off the
    init) saved by both packages: (jax dir, port dir)."""
    jcfg = jvit.ViTConfig(compute_dtype=np.float32, img_size=32,
                          patch_size=8, **MICRO)
    t, f = jclf.init_classifier(jax.random.PRNGKey(1), jcfg, 10,
                                apla_cfg=JAplaConfig(partial_size=16))
    rng = np.random.default_rng(2)
    t = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.standard_normal(
        np.shape(a))).astype(np.float32), t)
    f = jax.tree.map(np.asarray, f)
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jckpt.save_checkpoint(jdir, state=types.SimpleNamespace(
        trainable=t, opt_state={}, step=np.int32(0)), frozen=f,
        best_trainable=t)
    ts, fs = params_from_jax(t, f)
    tckpt.save_checkpoint(tdir, state=types.SimpleNamespace(
        step=0, optimizer=types.SimpleNamespace(state_dict=lambda: {}),
        trainable=lambda: ts, frozen=lambda: fs), best_trainable=ts)
    return jdir, tdir


def test_classifier_eval_matches_jax(tmp_path, vit_micro, capsys):
    recipe = _recipe(tmp_path)
    jdir, tdir = _checkpoints(tmp_path)
    jart, tart = str(tmp_path / "jax_art"), str(tmp_path / "port_art")
    common = ["--params_path", recipe, "--batch_sizes", "1,8",
              "--n_classes", "10"]
    jserve.main(["export", "--pretrained_path", jdir, "--out", jart]
                + common)
    tserve.main(["export", "--pretrained_path", tdir, "--out", tart]
                + common)
    out = capsys.readouterr().out
    assert f"Transfer-loaded full weights from {tdir}" in out
    assert "no checkpoint importer" not in out
    # the served logits and embeddings of the test split
    x = np.random.default_rng(3).standard_normal((11, 32, 32, 3)).astype(
        np.float32)
    j_pred, t_pred = jserve.load_predictor(jart), \
        tserve.load_predictor(tart, "cpu")
    for got, want in zip(t_pred.predict_and_embed(x),
                         j_pred.predict_and_embed(x)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL,
                                   atol=TOL)
    jserve.main(["eval", jart, "--params_path", recipe, "--knn"])
    want = _results(capsys.readouterr().out, "EVAL RESULTS (test, 64")
    results = tserve.main(["eval", tart, "--params_path", recipe, "--knn",
                           "--device", "cpu"])
    got = _results(capsys.readouterr().out, "EVAL RESULTS (test, 64")
    assert "knn_test_accuracy" in got and "test_accuracy" in got
    assert got == want
    assert {k: str(v) for k, v in results.items()} == got
    # the trainer's own --test --knn of the checkpoint reads the same
    tmain.run_cli(["--params_path", recipe, "--test", "--knn",
                   "--pretrained_path", tdir, "--device", "cpu"])
    trained = _results(capsys.readouterr().out, "TEST RESULTS")
    for k, v in got.items():
        assert trained[k] == v, k
    # the val split, no kNN
    jserve.main(["eval", jart, "--params_path", recipe, "--split", "val"])
    want = _results(capsys.readouterr().out, "EVAL RESULTS (val")
    tserve.main(["eval", tart, "--params_path", recipe, "--split", "val",
                 "--device", "cpu"])
    assert _results(capsys.readouterr().out, "EVAL RESULTS (val") == want


def _coco(tmp_path, n_images=6, size=(60, 80)):
    """PNGs with one to three coloured boxes of three categories."""
    img_dir = tmp_path / "coco"
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(n_images):
        img = rng.integers(0, 64, size + (3,), dtype=np.uint8)
        for j in range(1 + i % 3):
            x0, y0 = 5 + 20 * j, 8 + 10 * (i % 2)
            img[y0:y0 + 18, x0:x0 + 16] = (200, 60 * j, 40)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": 3 + j, "bbox": [x0, y0, 16, 18],
                         "iscrowd": 0})
        write_png(str(img_dir / f"im{i}.png"), img)
        images.append({"id": i, "file_name": f"im{i}.png",
                       "width": size[1], "height": size[0]})
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in (3, 4, 5)]}))
    return str(img_dir), str(ann)


def test_detector_eval_matches_jax(tmp_path, capsys):
    from apla_tpu_torch.utils.pretrained import det_state_from_jax
    t, f, jcfg = _jax_det()
    # random weights that detect: the classification tower's gain raised
    # so that scores spread (0.06-0.21) well past the packages' rounding,
    # and every location boxes itself 12 px wide, about the set's boxes
    head = t["head"]
    for conv in head["cls_tower"] + [head["cls"]]:
        conv["kernel"] = conv["kernel"] * 25.0
    head["cls"]["bias"] = np.full_like(head["cls"]["bias"], -2.2)
    head["box"]["kernel"] = np.zeros_like(head["box"]["kernel"])
    head["box"]["bias"] = np.full_like(head["box"]["bias"], 6.0)
    model = _port_model("detector")[2]
    model.load_state_dict({**det_state_from_jax(t, f)[0],
                           **det_state_from_jax(t, f)[1]})
    jart, tart = str(tmp_path / "jax_det"), str(tmp_path / "port_det")
    jserve.export_detector(jart, t, f, jcfg, (4, 8), batch_sizes=(4,))
    tserve.export_detector(tart, model, model.backbone.cfg, (4, 8),
                           batch_sizes=(4,))
    img_dir, ann = _coco(tmp_path)
    jserve.main(["eval", jart, "--det_img_dir", img_dir, "--det_ann", ann])
    want = _results(capsys.readouterr().out, "EVAL RESULTS (val, 6")
    got = tserve.main(["eval", tart, "--det_img_dir", img_dir, "--det_ann",
                       ann, "--device", "cpu", "--num_workers", "0"])
    assert _results(capsys.readouterr().out, "EVAL RESULTS (val, 6") == want
    assert got["val_map50"] > 0
    with pytest.raises(SystemExit):
        tserve.main(["eval", tart, "--det_img_dir", img_dir])


def _ade(root, n=3, size=(40, 50)):
    rng = np.random.default_rng(1)
    for split in ("training", "validation"):
        os.makedirs(root / "images" / split)
        os.makedirs(root / "annotations" / split)
        for i in range(n):
            img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
            lab = np.zeros(size, np.uint8)
            for c in range(3):
                lab[5 + 10 * c:15 + 10 * c, 5:45] = 1 + c + i % 2
            write_png(str(root / "images" / split / f"a{i}.jpg"), img)
            write_png(str(root / "annotations" / split / f"a{i}.png"), lab)
    return str(root)


@pytest.mark.parametrize("slide", [(), ("--eval_img_size", "48",
                                        "--eval_stride", "16")])
def test_segmenter_eval_matches_jax(slide, tmp_path, capsys):
    t, f, jcfg = _jax_seg()
    model = _port_model("segmenter")[2]
    jart, tart = str(tmp_path / "jax_seg"), str(tmp_path / "port_seg")
    jserve.export_segmenter(jart, t, f, jcfg, batch_sizes=(1, 2))
    cfg = tvit.ViTConfig(compute_dtype=torch.float32, use_fused_apla=True,
                         img_size=32, patch_size=8, embed_dim=64, depth=3,
                         num_heads=4)
    tserve.export_segmenter(tart, model, cfg, batch_sizes=(1, 2))
    root = _ade(tmp_path / "ade")
    jserve.main(["eval", jart, "--seg_root", root, *slide])
    want = _results(capsys.readouterr().out, "EVAL RESULTS (val, 3")
    got = tserve.main(["eval", tart, "--seg_root", root, *slide,
                       "--device", "cpu", "--num_workers", "0"])
    assert _results(capsys.readouterr().out, "EVAL RESULTS (val, 3") == want
    assert got["val_miou"] > 0
    x = np.random.default_rng(4).standard_normal((2, 48, 48, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tserve.load_predictor(tart, "cpu").predict_slide(x, stride=16),
        jserve.load_predictor(jart).predict_slide(x, stride=16), rtol=TOL,
        atol=TOL)
