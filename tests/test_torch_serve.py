"""The port's serving artifact and predictor against the JAX package.

`export_classifier` -> `load_predictor` -> `predict_and_embed` on the CPU is
held against the JAX `classifier_forward` on the same weights (float32,
rtol = atol = 1e-4: sum order only), and the request policy
(`_pick_batch`, `_iter_chunks`) against `apla_tpu.serve.Predictor`'s.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.apla.core import AplaConfig
from apla_tpu.models.classifier import classifier_forward, init_classifier
from apla_tpu.models.vit import ViTConfig
from apla_tpu.ops import pallas_apla_attn
from apla_tpu.serve import Predictor as JaxPredictor
from apla_tpu_torch import serve as tserve
from apla_tpu_torch.models.classifier import classifier_from_state
from apla_tpu_torch.models.vit import ViTConfig as TViTConfig
from apla_tpu_torch.ops import quant as tquant
from apla_tpu_torch.utils.pretrained import params_from_jax

KW = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
          has_layerscale=True, layerscale_init=1.0, gelu_tanh=True,
          use_fused_apla=True)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    pallas_apla_attn.INTERPRET = True
    monkeypatch.setenv("APLA_FUSED_MIN_N", "0")
    yield
    pallas_apla_attn.INTERPRET = False


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    jcfg = ViTConfig(compute_dtype=jnp.float32, **KW)
    tcfg = TViTConfig(compute_dtype=torch.float32, **KW)
    trainable, frozen = init_classifier(jax.random.PRNGKey(0), jcfg, 7,
                                        apla_cfg=AplaConfig(partial_size=16))
    trainable = jax.tree.map(np.asarray, trainable)
    frozen = jax.tree.map(np.asarray, frozen)
    model = classifier_from_state(tcfg, *params_from_jax(trainable, frozen),
                                  torch.device("cpu"))
    path = str(tmp_path_factory.mktemp("serve") / "artifact")
    meta = tserve.export_classifier(path, model, tcfg, batch_sizes=(1, 8, 64))
    return path, meta, trainable, frozen, jcfg


def test_meta_contents(artifact):
    path, meta, *_ = artifact
    assert meta["format"] == "apla_tpu_torch.serve/1"
    assert meta["batch_sizes"] == [1, 8, 64]
    assert (meta["img_size"], meta["n_classes"], meta["embed_dim"]) == \
        (32, 7, 128)
    assert meta["vit_config"]["compute_dtype"] == "float32"
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f) == meta
    with np.load(os.path.join(path, "params.npz")) as z:
        trainable = sorted(k for k in z.files if k.startswith("trainable/"))
    assert trainable == sorted(
        [f"trainable/backbone.blocks.{i}.attn.{leaf}" for i in range(2)
         for leaf in ("proj_wt", "proj_bt")]
        + ["trainable/fc.kernel", "trainable/fc.bias"])


@pytest.mark.parametrize("n", [1, 11])
def test_predict_and_embed_matches_jax(artifact, n):
    path, _, trainable, frozen, jcfg = artifact
    pred = tserve.load_predictor(path, "cpu")
    x = np.random.default_rng(n).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)
    logits, emb = pred.predict_and_embed(x)
    j_logits, j_emb = classifier_forward(trainable, frozen, jnp.asarray(x),
                                         jcfg, return_embedding=True)
    np.testing.assert_allclose(logits, np.asarray(j_logits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(emb, np.asarray(j_emb), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(pred.predict(x), logits)
    np.testing.assert_array_equal(pred.embed(x), emb)


def test_loaded_model_state(artifact):
    pred = tserve.load_predictor(artifact[0], "cpu")
    trainable = {n for n, p in pred.model.named_parameters()
                 if p.requires_grad}
    assert "fc.kernel" in trainable and "backbone.blocks.1.attn.proj_wt" \
        in trainable and "backbone.blocks.0.attn.qkv.kernel" not in trainable
    assert pred.model.backbone.blocks[0].attn.inds.dtype == torch.int64


def test_pick_batch_matches_jax():
    jp = JaxPredictor({"img_size": 32}, {}, {1: None, 8: None, 64: None})
    tp = tserve.Predictor({"img_size": 32, "batch_sizes": [64, 1, 8]},
                          torch.nn.Linear(1, 1), None, "cpu")
    assert [tp._pick_batch(n) for n in range(141)] == \
        [jp._pick_batch(n) for n in range(141)]


@pytest.mark.parametrize("n", [0, 1, 9, 63, 100, 137])
def test_chunk_plan_matches_jax(n):
    meta = {"img_size": 4, "batch_sizes": [1, 8, 64]}
    jp = JaxPredictor(meta, {}, {1: None, 8: None, 64: None})
    tp = tserve.Predictor(meta, torch.nn.Linear(1, 1), None, "cpu")
    x = np.random.default_rng(n).standard_normal((n, 4, 4, 3)).astype(
        np.float32)
    for (jb, jm, jc), (tb, tm, tc) in zip(jp._iter_chunks(x),
                                          tp._iter_chunks(x), strict=True):
        assert (jb, jm) == (tb, tm)
        np.testing.assert_array_equal(jc, tc)


def test_empty_and_bad_requests(artifact):
    pred = tserve.load_predictor(artifact[0], "cpu")
    logits, emb = pred.predict_and_embed(np.zeros((0, 32, 32, 3), np.float32))
    assert logits.shape == (0, 7) and emb.shape == (0, 128)
    with pytest.raises(ValueError, match="expected"):
        pred.predict(np.zeros((2, 16, 16, 3), np.float32))


def test_not_an_artifact(tmp_path):
    (tmp_path / "meta.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not an apla_tpu_torch"):
        tserve.load_predictor(str(tmp_path), "cpu")


def test_cli_export_predict_info(tmp_path, capsys):
    """The CLI on the synthetic vit_tiny APLA recipe: export, info, predict
    on a .npy batch."""
    art = str(tmp_path / "art")
    tserve.main(["export", "--params_path",
                 "params/synthetic/vit_tiny/apla.yml", "--n_classes", "10",
                 "--out", art, "--batch_sizes", "1,4"])
    assert "Exported 12-block classifier" in capsys.readouterr().out
    tserve.main(["info", art])
    info = json.loads(capsys.readouterr().out)
    assert info["batch_sizes"] == [1, 4] and info["n_classes"] == 10
    x = np.random.default_rng(0).standard_normal((5, 32, 32, 3)).astype(
        np.float32)
    np.save(tmp_path / "x.npy", x)
    out = str(tmp_path / "logits.npy")
    tserve.main(["predict", art, str(tmp_path / "x.npy"), "--device", "cpu",
                 "--out", out, "--top_k", "2"])
    printed = capsys.readouterr().out
    assert printed.count("image ") == 5
    logits = np.load(out)
    assert logits.shape == (5, 10) and np.isfinite(logits).all()


# ------------------------------------------------------------------ #
# detector artifacts
# ------------------------------------------------------------------ #

def _jax_det_artifact(tmp_path, n_protos=0):
    """A JAX detector (the shape of tests/test_serve.py's; with `n_protos`
    the mask branch) exported by the JAX package, and the same weights in
    a port artifact."""
    from apla_tpu.models.detection import (_conv_init, init_fcos_head,
                                           init_protonet)
    from apla_tpu.models.swin import (SwinConfig, build_apla_swin,
                                      init_swin_params)
    from apla_tpu.serve import export_detector as j_export
    from apla_tpu_torch.models.swin import SwinConfig as TSwinConfig
    from apla_tpu_torch.utils.pretrained import det_state_from_jax

    kw = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
              num_heads=(1, 2), window_size=7)
    jcfg = SwinConfig(compute_dtype=jnp.float32, **kw)
    bb_t, bb_f = build_apla_swin(init_swin_params(jax.random.PRNGKey(0),
                                                  jcfg))
    trainable = {
        "backbone": bb_t,
        "head": init_fcos_head(jax.random.PRNGKey(1), 32, 3, channels=16,
                               n_levels=2, n_protos=n_protos),
        "laterals": [_conv_init(jax.random.PRNGKey(5), 1, 32, 32),
                     _conv_init(jax.random.PRNGKey(6), 1, 64, 32)],
    }
    if n_protos:
        trainable["protonet"] = init_protonet(jax.random.PRNGKey(7), 32,
                                              n_protos=n_protos)
        # coefficients and prototypes large enough that masks show
        trainable["head"]["coef"]["kernel"] *= 30
        trainable["protonet"]["out"]["kernel"] *= 30
    trainable = jax.tree.map(np.asarray, trainable)
    bb_f = jax.tree.map(np.asarray, bb_f)
    j_path = str(tmp_path / "jax_det")
    j_export(j_path, trainable, bb_f, jcfg, (4, 8), batch_sizes=(2,))
    tcfg = TSwinConfig(compute_dtype=torch.float32, use_fused_apla=True,
                       **kw)
    t, f = det_state_from_jax(trainable, bb_f)
    model = tserve.detector_from_state(tcfg, 3, t, f, torch.device("cpu"))
    t_path = str(tmp_path / "torch_det")
    meta = tserve.export_detector(t_path, model, tcfg, (4, 8),
                                  batch_sizes=(1, 2))
    return j_path, t_path, meta, tcfg


def test_detector_artifact_matches_jax(tmp_path):
    """export_detector -> load_predictor -> DetPredictor against the JAX
    artifact's DetPredictor on the same weights: raw maps within float32
    1e-4, and `detect` with the same boxes, scores and labels."""
    from apla_tpu.serve import load_predictor as j_load
    j_path, t_path, meta, tcfg = _jax_det_artifact(tmp_path)
    assert meta["task"] == "detector" and meta["strides"] == [4, 8]
    assert meta["n_classes"] == 3 and meta["with_masks"] is False
    assert meta["swin_config"]["depths"] == [2, 2]
    assert meta["swin_config"]["use_fused_apla"] is True
    assert meta["swin_config"]["compute_dtype"] == "float32"
    pred = tserve.load_predictor(t_path, "cpu")
    assert isinstance(pred, tserve.DetPredictor) and pred.swin_cfg == tcfg
    trainable = {n for n, p in pred.model.named_parameters()
                 if p.requires_grad}
    assert trainable == {n for n, _ in pred.model.named_parameters()
                         if ".attn.proj." in n or not n.startswith(
                             "backbone.")}
    j_pred = j_load(j_path)
    x = np.random.default_rng(2).standard_normal((3, 56, 56, 3)).astype(
        np.float32)
    got, ref = pred.predict(x), j_pred.predict(x)
    for g_lvl, r_lvl in zip(got, ref, strict=True):
        for g, r in zip(g_lvl, r_lvl, strict=True):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)
    dets = pred.detect(x, score_thresh=0.0, top_k=5)
    j_dets = j_pred.detect(x, score_thresh=0.0, top_k=5)
    assert len(dets) == 3
    for (b, s, lab), (jb, js, jl) in zip(dets, j_dets):
        np.testing.assert_allclose(b, jb, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(s, js, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(lab, jl)
    empty = pred.predict(np.zeros((0, 56, 56, 3), np.float32))
    assert [lvl[0].shape for lvl in empty] == [(0, 14, 14, 3), (0, 7, 7, 3)]
    with pytest.raises(NotImplementedError):
        pred.embed(x)
    assert pred.predict_protos(x) is None          # a box-only export


def test_mask_detector_artifact_matches_jax(tmp_path):
    """A detector with the mask branch: `with_masks` in the meta, the
    coefficient maps and `predict_protos` against the JAX artifact's
    within float32 1e-4, and `detect`'s masks against JAX's decode (all
    but pixels whose logit sits within the f32 noise of the threshold)."""
    from apla_tpu.serve import load_predictor as j_load
    j_path, t_path, meta, _ = _jax_det_artifact(tmp_path, n_protos=4)
    assert meta["with_masks"] is True
    pred, j_pred = tserve.load_predictor(t_path, "cpu"), j_load(j_path)
    x = np.random.default_rng(3).standard_normal((3, 56, 56, 3)).astype(
        np.float32)
    got, ref = pred.predict(x), j_pred.predict(x)
    assert [len(lvl) for lvl in got] == [4, 4]
    for g_lvl, r_lvl in zip(got, ref, strict=True):
        for g, r in zip(g_lvl, r_lvl, strict=True):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)
    protos = pred.predict_protos(x)
    assert protos.shape == (3, 14, 14, 4) and protos.max() > 0
    np.testing.assert_allclose(protos, np.asarray(j_pred.predict_protos(x)),
                               rtol=1e-4, atol=1e-4)
    dets = pred.detect(x, score_thresh=0.0, top_k=5)
    j_dets = j_pred.detect(x, score_thresh=0.0, top_k=5)
    n_pix = n_diff = 0
    for det, j_det in zip(dets, j_dets, strict=True):
        assert len(det) == len(j_det) == 4 and det[3].shape == (5, 14, 14)
        np.testing.assert_allclose(det[0], j_det[0], rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(det[2], j_det[2])
        n_pix += det[3].size
        n_diff += int((det[3] != j_det[3]).sum())
    assert any(d[3].any() for d in dets) and n_diff <= n_pix // 1000
    empty = pred.detect(np.zeros((0, 56, 56, 3), np.float32))
    assert empty == [] and pred.predict_protos(x[:0]).shape == (0, 14, 14, 4)


def test_cli_export_det_and_predict(tmp_path, capsys):
    """`export_det` from a segdet det_best checkpoint (f32, unfused, as the
    JAX CLI exports), `info` and `predict` on a detector artifact."""
    from apla_tpu_torch import segdet
    from test_torch_segdet import make_coco
    img_dir, ann = make_coco(tmp_path)
    ck = str(tmp_path / "ck")
    segdet.train_detection(img_dir, ann, epochs=1, img_size=56,
                           batch_size=2, embed_dim=32, depths=(2, 2),
                           num_heads=(1, 2), num_workers=0, save_dir=ck,
                           device="cpu")
    art = str(tmp_path / "art")
    tserve.main(["export_det", "--ckpt", os.path.join(ck, "det_best.pt"),
                 "--img_size", "56", "--embed_dim", "32", "--depths", "2,2",
                 "--num_heads", "1,2", "--out", art, "--batch_sizes", "1,2"])
    assert "Exported detector" in capsys.readouterr().out
    tserve.main(["info", art])
    info = json.loads(capsys.readouterr().out)
    assert info["task"] == "detector" and info["batch_sizes"] == [1, 2]
    assert info["swin_config"]["use_fused_apla"] is False
    assert info["swin_config"]["compute_dtype"] == "float32"
    x = np.random.default_rng(0).standard_normal((3, 56, 56, 3)).astype(
        np.float32)
    np.save(tmp_path / "x.npy", x)
    out = str(tmp_path / "dets.json")
    tserve.main(["predict", art, str(tmp_path / "x.npy"), "--device", "cpu",
                 "--out", out, "--score_thresh", "0.0", "--max_dets", "4"])
    capsys.readouterr()
    recs = json.load(open(out))
    assert [r["image"] for r in recs] == [0, 1, 2]
    assert all(len(r["boxes"]) == len(r["scores"]) == len(r["labels"]) <= 4
               for r in recs)


def _jax_seg_artifact(tmp_path, batch_sizes=(1, 2)):
    """A JAX SETR-PUP segmenter (3 aux heads, weights perturbed) exported
    by the JAX package, and the same weights in a port artifact served
    through the fused attention's plain versions."""
    from apla_tpu.models import seg as jseg
    from apla_tpu.serve import export_segmenter as j_export
    from apla_tpu_torch.utils.pretrained import seg_state_from_jax

    kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4)
    jcfg = ViTConfig(compute_dtype=jnp.float32, **kw)
    t, f = jseg.init_segmenter(jax.random.PRNGKey(0), jcfg, 6, channels=16,
                               n_aux_heads=3, aux_channels=8)
    rng = np.random.default_rng(0)
    t, f = (jax.tree.map(lambda a: np.asarray(a) + (rng.standard_normal(
        np.shape(a)) * 0.05).astype(np.float32), tree) for tree in (t, f))
    j_path = str(tmp_path / "jax_seg")
    j_export(j_path, t, f, jcfg, batch_sizes=batch_sizes)
    tcfg = TViTConfig(compute_dtype=torch.float32, use_fused_apla=True, **kw)
    model = tserve.segmenter_from_state(tcfg, *seg_state_from_jax(t, f),
                                        torch.device("cpu"))
    t_path = str(tmp_path / "torch_seg")
    meta = tserve.export_segmenter(t_path, model, tcfg,
                                   batch_sizes=batch_sizes)
    return j_path, t_path, meta, tcfg, model


def test_segmenter_artifact_matches_jax(tmp_path):
    """export_segmenter -> load_predictor -> SegPredictor against the JAX
    artifact's SegPredictor on the same weights: logits (f32, 1e-4), masks,
    and sliding-window logits over larger images."""
    from apla_tpu.serve import load_predictor as j_load
    j_path, t_path, meta, tcfg, _ = _jax_seg_artifact(tmp_path)
    assert meta["task"] == "segmenter" and meta["n_classes"] == 6
    assert meta["img_size"] == 32 and meta["batch_sizes"] == [1, 2]
    assert meta["vit_config"]["use_fused_apla"] is True
    pred = tserve.load_predictor(t_path, "cpu")
    assert isinstance(pred, tserve.SegPredictor) and pred.vit_cfg == tcfg
    # APLA "full": the backbone trains its projections only, and serves
    # them through the fused path (`attn.inds` = every column)
    assert {n for n, p in pred.model.named_parameters() if p.requires_grad
            and n.startswith("backbone.")} == {
        f"backbone.blocks.{i}.attn.proj.{w}" for i in range(3)
        for w in ("kernel", "bias")}
    assert torch.equal(pred.model.backbone.blocks[0].attn.inds,
                       torch.arange(64))
    j_pred = j_load(j_path)
    x = np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_allclose(pred.predict(x), j_pred.predict(x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(pred.masks(x), j_pred.masks(x))
    big = np.random.default_rng(3).standard_normal((2, 48, 40, 3)).astype(
        np.float32)
    np.testing.assert_allclose(pred.predict_slide(big, stride=10),
                               j_pred.predict_slide(big, stride=10),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(pred.masks_slide(big), j_pred.masks_slide(
        big))
    assert pred.predict(np.zeros((0, 32, 32, 3), np.float32)).shape == (
        0, 32, 32, 6)
    with pytest.raises(ValueError, match="expected"):
        pred.predict_slide(big[:, :16])
    with pytest.raises(NotImplementedError):
        pred.embed(x)


def test_predict_slide_equals_the_slide_forward(tmp_path):
    """The served windows (cut on the host, sent in groups of the largest
    batch) give `segmenter_slide_forward`'s logits."""
    from apla_tpu_torch.models.seg import segmenter_slide_forward
    _, t_path, _, tcfg, model = _jax_seg_artifact(tmp_path,
                                                  batch_sizes=(1, 4))
    pred = tserve.load_predictor(t_path, "cpu")
    big = np.random.default_rng(4).standard_normal((3, 50, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = segmenter_slide_forward(model, torch.from_numpy(big), tcfg)
    np.testing.assert_allclose(pred.predict_slide(big), ref.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pred.predict_slide(big[:, :32, :32]),
                               pred.predict(big[:, :32, :32]))


def test_cli_export_seg_and_predict(tmp_path, capsys):
    """`export_seg` from a segdet seg_best checkpoint (bf16 as the JAX CLI
    exports, served through the fused APLA path), `info`, `predict` (argmax
    masks, sliding windows for larger inputs); the artifact gives the
    checkpoint's unfused logits (bf16 bound: 2e-2 of the largest).  With
    `--quantize_frozen` the artifact holds int8 qkv / fc1 / fc2 kernels and
    `load_predictor` serves exactly what the in-process quantized module
    computes."""
    from apla_tpu_torch import segdet
    from apla_tpu_torch.models.seg import segmenter_forward
    from test_torch_segdet import SEG_KW, make_ade
    root = make_ade(tmp_path / "ade")
    ck = str(tmp_path / "ck")
    segdet.train_segmentation(root, epochs=1, save_dir=ck, **SEG_KW)
    art = str(tmp_path / "art")
    argv = ["export_seg", "--ckpt", os.path.join(ck, "seg_best.pt"),
            "--backbone", "vit_tiny", "--patch_size", "8", "--img_size",
            "32", "--out", art, "--batch_sizes", "1,2"]
    tserve.main(argv)
    assert "Exported segmenter" in capsys.readouterr().out
    tserve.main(["info", art])
    info = json.loads(capsys.readouterr().out)
    assert info["task"] == "segmenter" and info["n_classes"] == 150
    assert info["vit_config"]["use_fused_apla"] is True
    assert info["vit_config"]["compute_dtype"] == "bfloat16"
    for shape in ((3, 32, 32, 3), (1, 40, 48, 3)):
        x = np.random.default_rng(0).standard_normal(shape).astype(
            np.float32)
        np.save(tmp_path / "x.npy", x)
        out = str(tmp_path / "masks.npy")
        tserve.main(["predict", art, str(tmp_path / "x.npy"), "--device",
                     "cpu", "--out", out])
        assert "top classes" in capsys.readouterr().out
        masks = np.load(out)
        assert masks.shape == shape[:3] and masks.dtype == np.int32
    q_art = str(tmp_path / "q_art")
    tserve.main(argv[:-3] + [q_art, "--batch_sizes", "1,2",
                             "--quantize_frozen"])
    q_pred = tserve.load_predictor(q_art, "cpu")
    assert q_pred.meta["quantized_frozen"] is True
    assert isinstance(q_pred.model.backbone.blocks[0].mlp.fc1.kernel,
                      tquant.QuantizedKernel)
    with np.load(os.path.join(q_art, "params.npz")) as z:
        assert z["frozen/backbone.blocks.0.attn.qkv.kernel.w_int8"].dtype \
            == np.int8
    # served through the fused APLA kernels (plain versions here): the
    # checkpoint's logits on the unfused path
    ckpt = segdet.load_checkpoint(os.path.join(ck, "seg_best.pt"))
    cfg = segdet.seg_vit_config("vit_tiny", 32, 8)
    model = tserve.segmenter_from_state(cfg, ckpt["trainable"],
                                        ckpt["frozen"], "cpu")
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        plain = segmenter_forward(model, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(tserve.load_predictor(art, "cpu").predict(x),
                               plain, rtol=0,
                               atol=2e-2 * np.abs(plain).max())
    quantized = tquant.quantize_frozen_backbone(model)
    served_cfg = tserve._cfg_from_echo(q_pred.meta["vit_config"])
    with torch.no_grad():
        ref = segmenter_forward(quantized, torch.from_numpy(x),
                                served_cfg).float().numpy()
    np.testing.assert_array_equal(q_pred.predict(x), ref)


@pytest.mark.parametrize("entry", ["serve", "segdet", "main"])
def test_entry_points_set_float32_precision(entry, monkeypatch):
    """Each CLI entry point sets both TF32 flags to the setting the card
    checks run (off: IEEE f32 products and convolutions) before it parses
    its arguments, whatever they were."""
    from apla_tpu_torch import main as tmain
    from apla_tpu_torch import segdet as tsegdet
    from apla_tpu_torch.wrapper import ALLOW_TF32
    run = {"serve": tserve.main, "segdet": tsegdet.main,
           "main": tmain.run_cli}[entry]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(SystemExit):
        run(["--help"])
    assert ALLOW_TF32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is ALLOW_TF32
    assert torch.backends.cudnn.allow_tf32 is ALLOW_TF32
