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
