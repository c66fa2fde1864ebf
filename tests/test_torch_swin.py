"""The port's Swin backbone against the JAX package's.

`apla_tpu.models.swin.swin_features` and the port's, with the JAX weights
carried over by `utils.pretrained.swin_state_from_tree` (and, for the APLA
split, `det_state_from_jax`): every pyramid level at float32, rtol = atol =
1e-4 (only the order of f32 sums differs), for two to four stages with
shifted windows and patch merging, on the plain and the fused window path
(the fused path runs the kernels' plain versions on the CPU).  Gradients of
the APLA-trainable projections against `jax.grad`.  The Hugging Face Swin
key maps against the JAX package's on a generated state dict.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.models import swin as jswin
from apla_tpu.utils import pretrained as jpre
from apla_tpu_torch.models import swin as tswin
from apla_tpu_torch.utils import pretrained as tpre

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = {
    "two_stages": dict(img_size=56, embed_dim=32, depths=(2, 2),
                       num_heads=(2, 4)),
    "three_stages": dict(img_size=112, embed_dim=24, depths=(2, 2, 2),
                         num_heads=(2, 2, 4)),
    "four_stages": dict(img_size=224, embed_dim=16, depths=(2, 2, 2, 2),
                        num_heads=(1, 2, 2, 4)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kw, fused=False):
    j = jswin.SwinConfig(patch_size=4, window_size=7,
                         compute_dtype=jnp.float32, **kw)
    t = tswin.SwinConfig(patch_size=4, window_size=7,
                         compute_dtype=torch.float32, use_fused_apla=fused,
                         **kw)
    return j, t


def _jax_params(jcfg, seed=0):
    params = jswin.init_swin_params(jax.random.PRNGKey(seed), jcfg)
    # non-trivial norms and biases, so that a swapped leaf shows
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.02, params)


def _port_swin(tcfg, tree):
    model = tswin.Swin(tcfg)
    model.load_state_dict(tpre.swin_state_from_tree(tree))
    return model


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_swin_features_match_jax(case, fused):
    jcfg, tcfg = _cfgs(CASES[case], fused)
    tree = _jax_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    ref = jax.jit(lambda t, im: jswin.swin_features(t, im, jcfg))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = tswin.swin_features(_port_swin(tcfg, tree), torch.tensor(x),
                                  tcfg)
    assert len(got) == len(ref) == len(jcfg.depths)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_apla_split_and_proj_grads_match_jax(fused):
    """`build_apla_swin`: the same tensors trainable as the JAX split, and
    the gradients of a loss over the pyramid reach them as in JAX (the
    shifted blocks and the merging included)."""
    jcfg, tcfg = _cfgs(CASES["two_stages"], fused)
    tree = _jax_params(jcfg, seed=2)
    j_t, j_f = jswin.build_apla_swin(tree)
    x = np.random.default_rng(3).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)

    def loss(t, frozen, im):
        return sum(jnp.sum(f ** 2) for f in
                   jswin.swin_features(frozen, im, jcfg, trainable=t))

    j_grads = jax.jit(jax.grad(loss))(j_t, j_f, jnp.asarray(x))
    model = tswin.build_apla_swin(_port_swin(tcfg, tree))
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    want = set(tpre.det_state_from_jax({"backbone": j_t}, {})[0])
    assert {f"backbone.{n}" for n in trainable} == want
    sum(torch.sum(f ** 2) for f in tswin.swin_features(
        model, torch.tensor(x), tcfg)).backward()
    got = {f"backbone.{n}": p.grad for n, p in model.named_parameters()
           if p.requires_grad}
    ref = tpre.det_state_from_jax({"backbone": j_grads}, {})[0]
    for name, g in ref.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()),
                                   err_msg=name)


def test_helpers_match_jax():
    """Window partition / reverse, the shift mask and the relative-position
    index: the same arrays as the JAX helpers."""
    np.testing.assert_array_equal(tswin._rel_pos_index(7),
                                  jswin._rel_pos_index(7))
    np.testing.assert_array_equal(tswin._shift_mask(14, 14, 7, 3),
                                  jswin._shift_mask(14, 14, 7, 3))
    x = np.random.default_rng(0).standard_normal((2, 14, 21, 5)).astype(
        np.float32)
    wins = tswin._window_partition(torch.tensor(x), 7)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(
        tswin._window_reverse(wins, 7, 2, 14, 21).numpy(), x)


@pytest.fixture(scope="module")
def hf_state():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.SwinModel(transformers.SwinConfig(
        image_size=56, patch_size=4, embed_dim=32, depths=[2, 2],
        num_heads=[2, 4], window_size=7), add_pooling_layer=False)
    return {k: v.detach().clone() for k, v in hf.state_dict().items()}


def test_hf_key_maps_match_jax(hf_state):
    assert tpre.swin_arch_from_hf_state_dict(hf_state) == \
        jpre.swin_arch_from_hf_state_dict(hf_state)
    got = tpre.convert_swin_hf_state_dict(hf_state, depths=(2, 2))
    ref = jpre.convert_swin_hf_state_dict(hf_state, depths=(2, 2))
    got_flat = tpre.swin_state_from_tree(got)
    ref_flat = tpre.swin_state_from_tree(ref)
    assert set(got_flat) == set(ref_flat)
    for name in ref_flat:
        np.testing.assert_array_equal(got_flat[name].numpy(),
                                      ref_flat[name].numpy(), err_msg=name)
    back = tpre.export_swin_hf_state_dict(got)
    assert set(back) <= set(hf_state)
    for name, v in back.items():
        np.testing.assert_array_equal(v, hf_state[name].numpy(),
                                      err_msg=name)


def test_state_tree_round_trip():
    jcfg, tcfg = _cfgs(CASES["three_stages"])
    model = tswin.init_swin_params(tcfg, torch.Generator().manual_seed(0))
    tree = tpre.swin_tree_from_state(model.state_dict())
    assert isinstance(tree["stages"], list) and len(tree["stages"]) == 3
    assert "downsample" not in tree["stages"][-1]
    again = tpre.swin_state_from_tree(tree)
    for name, t in model.state_dict().items():
        assert torch.equal(again[name], t), name
    # the same tree runs through the JAX model
    x = np.zeros((1, 112, 112, 3), np.float32)
    assert len(jax.jit(lambda t, im: jswin.swin_features(t, im, jcfg))(
        tree, jnp.asarray(x))) == 3


def test_fused_path_refuses_attention_dropout_in_training():
    _, tcfg = _cfgs(CASES["two_stages"], fused=True)
    tcfg = dataclasses.replace(tcfg, attn_drop_rate=0.1)
    model = tswin.init_swin_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no attention dropout"):
        tswin.swin_features(model, torch.zeros(1, 56, 56, 3), tcfg,
                            generator=torch.Generator().manual_seed(0),
                            deterministic=False)


@pytest.mark.parametrize("fused", [False, True])
def test_trains_after_a_first_forward_in_inference_mode(fused):
    """The device copies of the shift mask and the relative-position index
    are cached on first use; when that use is a served or evaluated forward
    (inference mode), a later training step must still run its backward."""
    _, tcfg = _cfgs(CASES["two_stages"], fused=fused)
    model = tswin.build_apla_swin(tswin.init_swin_params(
        tcfg, torch.Generator().manual_seed(0)))
    x = torch.randn(2, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    tswin._device_shift_mask.cache_clear()
    tswin._device_rel_index.cache_clear()
    with torch.inference_mode():
        tswin.swin_features(model, x, tcfg)
    sum(f.sum() for f in tswin.swin_features(model, x, tcfg)).backward()
    proj = model.stages[0].blocks[1].attn.proj
    assert proj.kernel.grad is not None and proj.bias.grad is not None
