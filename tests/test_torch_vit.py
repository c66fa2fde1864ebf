"""The port's ViT and classifier forward against the JAX package's.

Same weights (JAX init, carried over by `params_from_jax`) and the same
numpy images go through `apla_tpu.models` and `apla_tpu_torch.models` on a
tiny config: depth 2, C = 128, H = 2, patch 8, img 32, APLA k = 16, 10
classes, LayerScale and register tokens on.  JAX runs the fused path in the
Pallas interpreter (`use_fused_apla=True`), as its own tests do.

Tolerances: float32 rtol = atol = 1e-4 (sum order only); bfloat16
rtol = atol = 6e-2 on LayerNorm-scaled outputs of order 1-4 (the two
frameworks round GELU, the residual adds and LayerScale to bf16 at slightly
different points, i.e. a few bf16 ulps after two blocks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.apla import core as jcore
from apla_tpu.models import classifier as jclf
from apla_tpu.models import vit as jvit
from apla_tpu.ops import pallas_apla_attn
from apla_tpu_torch.apla import core as tcore
from apla_tpu_torch.models import classifier as tclf
from apla_tpu_torch.models import vit as tvit
from apla_tpu_torch.utils.pretrained import params_from_jax

TOL = {"float32": 1e-4, "bfloat16": 6e-2}
TINY = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            has_layerscale=True, layerscale_init=0.5, num_register_tokens=2,
            use_fused_apla=True)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    pallas_apla_attn.INTERPRET = True
    monkeypatch.setenv("APLA_FUSED_MIN_N", "0")
    yield
    pallas_apla_attn.INTERPRET = False


def _configs(dtype, **over):
    kw = {**TINY, **over}
    return (jvit.ViTConfig(compute_dtype=getattr(jnp, dtype), **kw),
            tvit.ViTConfig(compute_dtype=getattr(torch, dtype), **kw))


def _pair(jcfg, tcfg, apla=True):
    """JAX (trainable, frozen) and the port's Classifier on the same
    weights (LayerScale drawn away from its constant init)."""
    trainable, frozen = jclf.init_classifier(
        jax.random.PRNGKey(0), jcfg, 10,
        apla_cfg=jcore.AplaConfig(partial_size=16) if apla else None)
    trainable = jax.tree.map(np.asarray, trainable)
    frozen = jax.tree.map(np.asarray, frozen)
    rng = np.random.default_rng(1)
    params = frozen["backbone"] if apla else trainable["backbone"]
    for ls in ("ls1", "ls2"):
        g = params["blocks"][ls]["gamma"]
        params["blocks"][ls]["gamma"] = (
            g + 0.1 * rng.standard_normal(g.shape)).astype(np.float32)
    t_state, f_state = params_from_jax(trainable, frozen)
    model = tclf.classifier_from_state(tcfg, t_state, f_state,
                                       torch.device("cpu"))
    return trainable, frozen, model


def _images(n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _close(got, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu_tanh", [True, False])
def test_classifier_forward_matches_jax(dtype, gelu_tanh):
    jcfg, tcfg = _configs(dtype, gelu_tanh=gelu_tanh)
    trainable, frozen, model = _pair(jcfg, tcfg)
    x = _images()
    j_logits, j_emb = jclf.classifier_forward(
        trainable, frozen, jnp.asarray(x), jcfg, return_embedding=True)
    with torch.no_grad():
        t_logits, t_emb = tclf.classifier_forward(
            model, torch.from_numpy(x), tcfg, return_embedding=True)
    assert t_logits.dtype == getattr(torch, dtype)
    _close(t_logits.float(), j_logits, dtype)
    _close(t_emb.float(), j_emb, dtype)


@pytest.mark.parametrize("path", ["unfused", "flash", "plain_vit",
                                  "logits_f32"])
def test_attention_paths_match_jax(path):
    """The non-fused attention paths, float32: qkv_and_attend + apla_proj,
    the CPU flash_mha path, a ViT with no APLA (multi_head_attention), and
    f32 attention logits."""
    over = {"use_fused_apla": False}
    if path == "flash":
        over["use_flash"] = True
    if path == "logits_f32":
        over["attn_logits_f32"] = True
    jcfg, tcfg = _configs("float32", **over)
    trainable, frozen, model = _pair(jcfg, tcfg, apla=path != "plain_vit")
    x = _images(seed=2)
    j_logits = jclf.classifier_forward(trainable, frozen, jnp.asarray(x),
                                       jcfg)
    with torch.no_grad():
        t_logits = tclf.classifier_forward(model, torch.from_numpy(x), tcfg)
    _close(t_logits, j_logits, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_block_matches_jax(dtype):
    jcfg, tcfg = _configs(dtype)
    trainable, frozen, model = _pair(jcfg, tcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 19, 128)).astype(np.float32)
    bp = jax.tree.map(lambda a: jnp.asarray(a[0]), frozen["backbone"]["blocks"])
    tb = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      trainable["backbone"]["blocks"])
    ref = jvit._block_forward(jnp.asarray(x, jcfg.compute_dtype), bp, tb, 0.0,
                              jcfg, None, True)
    with torch.no_grad():
        got = tvit._block_forward(torch.from_numpy(x).to(tcfg.compute_dtype),
                                  model.backbone.blocks[0], tcfg)
    _close(got.float(), np.asarray(ref.astype(jnp.float32)), dtype)


def test_vit_features_all_tokens_matches_jax():
    jcfg, tcfg = _configs("float32")
    trainable, frozen, model = _pair(jcfg, tcfg)
    x = _images(seed=4)
    ref = jvit.vit_features(frozen["backbone"], jnp.asarray(x), jcfg,
                            trainable=trainable["backbone"],
                            return_all_tokens=True)
    with torch.no_grad():
        got = tvit.vit_features(model.backbone, torch.from_numpy(x), tcfg,
                                return_all_tokens=True)
    assert got.shape == (3, 1 + 2 + 16, 128)
    _close(got, ref, "float32")


def test_served_at_another_grid_matches_jax():
    """pos_embed trained on a 64-px grid (8x8 patches), served at 32 px:
    both forwards interpolate it the same way."""
    jcfg_grid, tcfg_grid = _configs("float32", img_size=64)
    trainable, frozen, model = _pair(jcfg_grid, tcfg_grid)
    jcfg = dataclasses.replace(jcfg_grid, img_size=32)
    tcfg = dataclasses.replace(tcfg_grid, img_size=32)
    x = _images(seed=5)
    ref = jclf.classifier_forward(trainable, frozen, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = tclf.classifier_forward(model, torch.from_numpy(x), tcfg)
    _close(got, ref, "float32")


@pytest.mark.parametrize("old,new", [(37, 16), (16, 37), (5, 5)])
def test_interpolate_pos_embed_matches_jax_resize(old, new):
    """jax.image.resize bicubic (Keys a = -0.5, no antialias), not torch's
    F.interpolate (a = -0.75): the 518 -> 224 ViT-B/14 case and back."""
    pos = np.random.default_rng(old * 100 + new).standard_normal(
        (1, 1 + old * old, 24)).astype(np.float32)
    ref = jvit.interpolate_pos_embed(jnp.asarray(pos), new * new)
    got = tvit.interpolate_pos_embed(torch.from_numpy(pos), new * new)
    assert got.shape == (1, 1 + new * new, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_indices_match_jax():
    np.testing.assert_array_equal(tcore.sample_indices(7, 4, 64, 8),
                                  jcore.sample_indices(7, 4, 64, 8))
    path = "params/finetune/dinov2/ImageNet/vit_b/inds-vit_b-rand_128.json"
    np.testing.assert_array_equal(tcore.load_indices(path, 12, 768),
                                  jcore.load_indices(path, 12, 768))
    with pytest.raises(ValueError, match="out of range"):
        tcore.load_indices(path, 12, 192)


@pytest.mark.parametrize("partial", [16, "full"])
def test_build_apla_matches_jax(partial):
    """build_apla on the port's module picks the JAX package's columns, and
    merge_apla_params gives back the plain projection."""
    jcfg, tcfg = _configs("float32")
    params = jvit.init_vit_params(jax.random.PRNGKey(2), jcfg)
    acfg = jcore.AplaConfig(partial_size=partial, seed=3)
    j_tr, j_fr = jcore.build_apla(params, jcfg, acfg)
    _, plain = params_from_jax({}, jax.tree.map(np.asarray, params))
    vit = tvit.ViT(tcfg)
    vit.load_state_dict(plain)
    tcore.build_apla(vit, tcore.AplaConfig(partial_size=partial, seed=3))
    trainable = {n for n, p in vit.named_parameters() if p.requires_grad}
    if partial == "full":
        assert trainable == {f"blocks.{i}.attn.proj.{leaf}"
                             for i in range(2) for leaf in ("kernel", "bias")}
        return
    assert trainable == {f"blocks.{i}.attn.{leaf}"
                         for i in range(2) for leaf in ("proj_wt", "proj_bt")}
    assert tcore.count_params(vit.parameters()) - tcore.count_params(
        p for p in vit.parameters() if not p.requires_grad) == \
        jcore.count_params(j_tr)
    for i, blk in enumerate(vit.blocks):
        np.testing.assert_array_equal(
            blk.attn.inds.numpy(), np.asarray(j_fr["blocks"]["attn"]["inds"][i]))
        np.testing.assert_array_equal(
            blk.attn.proj_wt.detach().numpy(),
            np.asarray(j_tr["blocks"]["proj_wt"][i]))
    merged = tcore.merge_apla_params(vit.state_dict())
    assert not any("inds" in n or "proj_wt" in n for n in merged)
    np.testing.assert_array_equal(
        merged["blocks.1.attn.proj.kernel"].numpy(),
        np.asarray(params["blocks"]["attn"]["proj"]["kernel"][1]))


def test_recipe_configs_match_jax_wrapper():
    """build_vit_config / build_apla_config agree with the JAX wrapper's on
    the shipped recipes (TPU-only fields aside)."""
    from apla_tpu.utils.config import load_merged_params
    from apla_tpu.wrapper import DefaultWrapper
    from apla_tpu_torch import wrapper as twrapper

    for path in ("params/finetune/dinov2/ImageNet/vit_b/apla.yml",
                 "params/synthetic/vit_tiny/apla.yml"):
        params = load_merged_params(path)
        jw = DefaultWrapper(params)
        jcfg = dataclasses.asdict(jw.build_vit_config())
        tcfg = dataclasses.asdict(twrapper.build_vit_config(params))
        assert str(tcfg.pop("compute_dtype")).endswith(
            jnp.dtype(jcfg.pop("compute_dtype")).name)
        for tpu_only in ("remat", "scan_unroll"):
            jcfg.pop(tpu_only)
        assert tcfg == jcfg
        ja, ta = jw.build_apla_config(), twrapper.build_apla_config(params)
        assert (ta.partial_size, ta.inds_path, ta.seed) == \
            (ja.partial_size, ja.inds_path, ja.seed)


def test_attn_drop_rate_keeps_fused_path(monkeypatch):
    """A config with attention dropout (e.g. a recipe's `attn_drop_rate`)
    still runs every block through fused_apla_attention: the forward
    applies no dropout, so the rate changes neither the path nor the
    output."""
    from apla_tpu_torch.ops import attention as tattn

    calls = []
    fused = tattn.fused_apla_attention

    def counting(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)

    monkeypatch.setattr(tattn, "fused_apla_attention", counting)
    _, tcfg = _configs("float32")
    model = tclf.init_classifier(
        tcfg, 10, tcore.AplaConfig(partial_size=16),
        generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu"))
    x = torch.from_numpy(_images(seed=6))
    with torch.no_grad():
        ref = tclf.classifier_forward(model, x, tcfg)
        assert len(calls) == tcfg.depth
        got = tclf.classifier_forward(
            model, x, dataclasses.replace(tcfg, attn_drop_rate=0.1))
    assert len(calls) == 2 * tcfg.depth
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_unported_paths_raise():
    """An int8 frozen leaf and use_flash off the CPU raise instead of
    silently taking another path."""
    from apla_tpu_torch.ops.flash_attention import flash_mha
    from apla_tpu_torch.ops.quant import maybe_quantized_dot

    with pytest.raises(NotImplementedError, match="ROADMAP B6"):
        maybe_quantized_dot(torch.zeros(2, 4), {"w_int8": None, "scale": None})
    q = torch.empty(1, 17, 2, 64, device="meta")
    with pytest.raises(NotImplementedError, match="B5"):
        flash_mha(q, q, q, scale=0.125)
