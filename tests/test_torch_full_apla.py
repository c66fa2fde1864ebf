"""APLA "full" (the whole output projection trainable) and a full fine-tune
with no adaptation, on the memory-efficient attention path
(`use_flash=True`, the recipes' `is_memory_efficient: true`), against the
JAX package.

A 2-block, C = 128, 2-head ViT classifier (patch 8 at 32 px, LayerScale
on, 10 classes) is built in JAX at `partial_size: "full"` (and with no
adaptation) and carried over by `params_from_jax`.  JAX's `flash_mha` takes
its plain softmax path on the CPU; the port's takes `ops.mha`, whose kernels
run their plain versions on CPU tensors.  Tolerance: float32 rtol = atol =
1e-4 (sum order only) for logits, embeddings, the per-step loss and grad
norm of a three-step trajectory, and the final trainable weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.models import classifier as jclf
from apla_tpu.models import vit as jvit
from apla_tpu.train import losses as jlosses
from apla_tpu.train import steps as jsteps
from apla_tpu.train.optim import build_optimizer as jbuild
from apla_tpu.train.train_state import TrainState as JState
from apla_tpu_torch.models import classifier as tclf
from apla_tpu_torch.models import vit as tvit
from apla_tpu_torch.ops import mha as tmha
from apla_tpu_torch.serve import export_classifier, load_predictor
from apla_tpu_torch.train import losses as tlosses
from apla_tpu_torch.train import steps as tsteps
from apla_tpu_torch.train.optim import build_optimizer
from apla_tpu_torch.train.train_state import TrainState
from apla_tpu_torch.utils.pretrained import params_from_jax

TOL = 1e-4
TINY = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            has_layerscale=True, layerscale_init=0.5, use_flash=True,
            use_fused_apla=True)
N_STEPS, BATCH, LR, WD = 3, 8, 1e-3, 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the kernels' plain versions (what the wrappers
    run on CPU tensors): {'fwd': n, 'bwd': n}."""
    counts = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "mha_fwd_reference"),
                      ("bwd", "mha_bwd_reference")):
        fn = getattr(tmha, name)

        def counted(*args, _fn=fn, _key=key, **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(tmha, name, counted)
    return counts


def _setup(mode):
    """JAX (cfg, trainable, frozen) and the port's (cfg, Classifier) on the
    same weights; `mode` "full" (APLA full) or "none" (full fine-tune)."""
    jcfg = jvit.ViTConfig(compute_dtype=jnp.float32, **TINY)
    tcfg = tvit.ViTConfig(compute_dtype=torch.float32, **TINY)
    apla = JAplaConfig(partial_size="full") if mode == "full" else None
    trainable, frozen = jclf.init_classifier(jax.random.PRNGKey(0), jcfg, 10,
                                             apla_cfg=apla)
    trainable = jax.tree.map(np.asarray, trainable)
    frozen = jax.tree.map(np.asarray, frozen)
    t_state, f_state = params_from_jax(trainable, frozen)
    model = tclf.classifier_from_state(tcfg, t_state, f_state,
                                       torch.device("cpu"))
    return jcfg, tcfg, trainable, frozen, model


def _trainable_names(mode):
    names = {"fc.kernel", "fc.bias"}
    if mode == "full":
        return names | {f"backbone.blocks.{i}.attn.proj.{leaf}"
                        for i in range(2) for leaf in ("kernel", "bias")}
    return None     # everything


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", ["full", "none"])
def test_forward_matches_jax(mode, calls):
    jcfg, tcfg, trainable, frozen, model = _setup(mode)
    live = {n for n, p in model.named_parameters() if p.requires_grad}
    want = _trainable_names(mode)
    assert live == (want if want is not None
                    else {n for n, _ in model.named_parameters()})
    assert all(blk.attn.inds is None for blk in model.backbone.blocks)
    x = _images(3, seed=1)
    j_logits, j_emb = jclf.classifier_forward(
        trainable, frozen, jnp.asarray(x), jcfg, return_embedding=True)
    with torch.no_grad():
        t_logits, t_emb = tclf.classifier_forward(
            model, torch.from_numpy(x), tcfg, return_embedding=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=TOL,
                               atol=TOL)
    assert calls == {"fwd": 2, "bwd": 0}      # every block through ops.mha


@pytest.mark.parametrize("mode", ["full", "none"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_trajectory_matches_jax(mode, accum, calls):
    """Three AdamW steps (weight-decay mask, clip 1.0) on the same batches
    and learning rates.  Backward launches: every block of every micro-step
    for a full fine-tune; block 0's attention has no trainable input under
    APLA "full" (its input and its qkv are frozen), so autograd, like XLA,
    runs no backward there."""
    jcfg, tcfg, trainable, frozen, model = _setup(mode)
    tx = jbuild("AdamW", {"lr": LR, "weight_decay": WD}, trainable,
                grad_clip=1.0)
    jstate = JState.create(trainable, tx)
    jstep = jsteps.make_train_step(jcfg, tx, jlosses.cross_entropy,
                                   accum_steps=accum)
    opt = build_optimizer("AdamW", {"lr": LR, "weight_decay": WD},
                          [(n, p) for n, p in model.named_parameters()
                           if p.requires_grad], grad_clip=1.0)
    state = TrainState(0, model, opt)
    tstep = tsteps.make_train_step(tcfg, opt, tlosses.cross_entropy,
                                   accum_steps=accum)
    rng = np.random.default_rng(2)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for i in range(N_STEPS):
        x = _images(BATCH, seed=10 + i)
        y = rng.integers(0, 10, BATCH)
        lr = LR * (i + 1) / N_STEPS
        jstate, jm = jstep(jstate, frozen, {"image": jnp.asarray(x),
                                            "label": jnp.asarray(y)}, lr, key)
        state, m = tstep(state, {"image": torch.from_numpy(x),
                                 "label": torch.from_numpy(y)}, lr, gen)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    bwd_blocks = 1 if mode == "full" else 2
    assert calls == {"fwd": 2 * accum * N_STEPS,
                     "bwd": bwd_blocks * accum * N_STEPS}
    t_final, _ = params_from_jax(jax.tree.map(np.asarray, jstate.trainable),
                                 {"backbone": {}})
    live = dict(model.named_parameters())
    assert set(t_final) == {n for n, p in live.items() if p.requires_grad}
    for name, want in t_final.items():
        np.testing.assert_allclose(live[name].detach().numpy(), want.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("mode", ["full", "none"])
def test_served_artifact_keeps_the_flash_path(mode, tmp_path, calls):
    """Export, reload and `Predictor`: the artifact's config echo keeps
    use_flash, the reloaded model answers through ops.mha in every block of
    every call, and its answers are the JAX model's."""
    jcfg, tcfg, trainable, frozen, model = _setup(mode)
    meta = export_classifier(str(tmp_path), model, tcfg, batch_sizes=(1, 4))
    assert meta["vit_config"]["use_flash"] is True
    pred = load_predictor(str(tmp_path), "cpu")
    assert pred.vit_cfg == tcfg
    assert sorted(os.listdir(tmp_path)) == ["meta.json", "params.npz"]
    x = _images(5, seed=3)
    logits = pred.predict(x)
    calls_per_request = sum(1 for _ in pred._iter_chunks(x))
    assert calls["fwd"] == 2 * calls_per_request
    j_logits = jclf.classifier_forward(trainable, frozen, jnp.asarray(x),
                                       jcfg)
    np.testing.assert_allclose(logits, np.asarray(j_logits), rtol=TOL,
                               atol=TOL)
    live = {n for n, p in pred.model.named_parameters() if p.requires_grad}
    assert live == {n for n, p in model.named_parameters() if p.requires_grad}
