"""The port's DINOv2 pieces against the JAX package's, on the CPU.

Inputs are numpy draws from a seed, handed to both.  Tolerances, per
check:

- schedules, the masking generator and the iBOT collate: exact (the same
  numpy arithmetic; the collate's masks, indices and weights bit-equal
  over two epochs of batches collated out of order);
- the DINO head and the losses: float32 on both sides, differing only in
  the order of f32 sums: 1e-5 relative (1e-4 where a softmax over 512
  prototypes or a log amplifies it);
- multi-crop with blur and solarize, with the JAX draws fed to the port:
  1e-4, as the supervised `device_augment` check in `test_torch_data.py`
  (the resampling weights and the blur are the same f32 sums in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.data import device_augs as jaugs
from apla_tpu.ssl import dinov2 as jd
from apla_tpu.ssl import heads as jheads
from apla_tpu.ssl import multicrop as jmc
from apla_tpu.utils.config import EDict as JEDict
from apla_tpu_torch.data import device_augs as taugs
from apla_tpu_torch.ssl import dinov2 as td
from apla_tpu_torch.ssl import heads as theads
from apla_tpu_torch.ssl import multicrop as tmc
from apla_tpu_torch.utils.pretrained import params_from_jax
from tests.test_torch_data import _jax_draws


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-12), err


# --------------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------------- #

def _sched_params():
    opt = {"optimizer": {"params": {"lr": 1e-3, "weight_decay": 1e-5}},
           "scheduler": {"params": {"CosineAnnealingLR": {"eta_min": 1e-6},
                                    "LinearWarmup": {"warmup_epochs": 2}}}}
    teacher = {"momentum_teacher": 0.994, "final_momentum_teacher": 1,
               "warmup_teacher_temp": 0.04, "teacher_temp": 0.07,
               "warmup_teacher_temp_epochs": 3}
    return opt, {"freeze_last_layer_epochs": 1}, teacher


def test_schedules_are_exact():
    from apla_tpu_torch.utils.config import EDict
    opt, tp, teacher = _sched_params()
    want = jd.build_schedulers(JEDict(opt), JEDict(tp), JEDict(teacher),
                               7, 50)
    got = td.build_schedulers(EDict(opt), EDict(tp), EDict(teacher), 7, 50)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.schedule, b.schedule)
        assert [a[i] for i in range(60)] == [b[i] for i in range(60)]
    a = td.CosineScheduler(1.0, 0.1, 20, warmup_iters=5, freeze_iters=3,
                           start_warmup_value=0.2)
    b = jd.CosineScheduler(1.0, 0.1, 20, warmup_iters=5, freeze_iters=3,
                           start_warmup_value=0.2)
    np.testing.assert_array_equal(a.schedule, b.schedule)


# --------------------------------------------------------------------------- #
# masking + collate
# --------------------------------------------------------------------------- #

def test_masking_generator_is_exact():
    for size, n in (((4, 4), 6), ((16, 16), 100), ((7, 9), 20)):
        a = td.MaskingGenerator(size, max_num_patches=int(0.5 * size[0]
                                                          * size[1]))
        b = jd.MaskingGenerator(size, max_num_patches=int(0.5 * size[0]
                                                          * size[1]))
        for seed in range(5):
            np.testing.assert_array_equal(
                a(n, rng=np.random.default_rng(seed)),
                b(n, rng=np.random.default_rng(seed)))


@pytest.mark.parametrize("raw_mode", [True, False])
def test_ibot_collate_is_bit_equal_over_two_epochs(raw_mode):
    """The JAX collate counts its calls in batch order; the port's is keyed
    by (epoch, batch index) and may be called in any order."""
    B, n_batches, grid, ng, nl = 6, 4, 8, 2, 3
    rng = np.random.default_rng(0)

    def sample(i):
        if raw_mode:
            img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        else:
            img = [rng.standard_normal((8, 8, 3)).astype(np.float32)
                   for _ in range(ng + nl)]
        return {"image": img, "label": i % 5}

    batches = [[sample(i) for i in range(B)] for _ in range(2 * n_batches)]
    args = (ng, nl, (0.1, 0.5), 0.5, grid * grid)
    ours = td.IBotCollate(*args, td.MaskingGenerator(
        (grid, grid), max_num_patches=32), raw_mode=raw_mode, seed=3,
        batches_per_epoch=n_batches)
    theirs = jd.make_ibot_collate(*args, jd.MaskingGenerator(
        (grid, grid), max_num_patches=32), raw_mode=raw_mode, seed=3)
    want = [theirs(b) for b in batches]               # in order
    order = list(range(2 * n_batches))[::-1]          # out of order
    got = {i: ours(batches[i], rng=np.random.default_rng(99),
                   batch_key=divmod(i, n_batches)) for i in order}
    for i, w in enumerate(want):
        g = got[i]
        assert set(g) == {k for k, v in w.items() if v is not None}
        for k, v in w.items():
            if v is not None:
                np.testing.assert_array_equal(g[k], v, err_msg=k)
        assert g["collated_masks"].any()


# --------------------------------------------------------------------------- #
# DINO head
# --------------------------------------------------------------------------- #

def _heads(in_dim=48, out_dim=512, nlayers=3, hidden=64, bott=32):
    jp = jheads.init_dino_head(jax.random.PRNGKey(0), in_dim, out_dim,
                               nlayers=nlayers, hidden_dim=hidden,
                               bottleneck_dim=bott)
    rng = np.random.default_rng(1)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32)), jp)                 # non-trivial biases and g
    head = theads.DINOHead(in_dim, out_dim, nlayers, hidden, bott)
    state, _ = params_from_jax({"dino_head": jax.tree.map(np.asarray, jp)},
                               {})
    head.load_state_dict({k[len("dino_head."):]: v for k, v in state.items()})
    return jp, head


@pytest.mark.parametrize("nlayers", [1, 3])
def test_dino_head_matches_jax(nlayers):
    jp, head = _heads(nlayers=nlayers)
    x = np.random.default_rng(2).standard_normal((9, 48)).astype(np.float32)
    _close(theads.dino_head_bottleneck(_t(x), head),
           jheads.dino_head_bottleneck(jnp.asarray(x), jp), 1e-5)
    for norm in (True, False):
        _close(theads.dino_head_last_w(head, norm),
               jheads.dino_head_last_w(jp, norm), 1e-5)
        _close(theads.dino_head_forward(_t(x), head, norm),
               jheads.dino_head_forward(jnp.asarray(x), jp, norm), 1e-5)
    _close(theads.dino_head_forward(_t(x), head, matmul_bf16=True),
           jheads.dino_head_forward(jnp.asarray(x), jp, matmul_bf16=True),
           1e-5)


def test_last_w_gradient_reaches_g_only_without_norm_last_layer():
    jp, head = _heads()
    x = np.random.default_rng(3).standard_normal((5, 48)).astype(np.float32)
    for norm in (True, False):
        head.zero_grad()
        theads.dino_head_forward(_t(x), head, norm).square().sum().backward()

        def f(p):
            return jnp.sum(jheads.dino_head_forward(jnp.asarray(x), p,
                                                    norm) ** 2)
        g = jax.grad(f)(jp)
        if norm:
            assert head.last_g.grad is None or \
                float(head.last_g.grad.abs().max()) == 0.0
        else:
            _close(head.last_g.grad, g["last_g"], 1e-4)
        _close(head.last_v.grad, g["last_v"], 1e-4)
        _close(head.mlp[0].kernel.grad, g["mlp"][0]["kernel"], 1e-4)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #

def _logits(seed, rows, k=512, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (rows, k))).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_knopp_matches_jax(masked):
    t = _logits(0, 12, scale=0.5)
    mask = np.array([1] * 9 + [0] * 3, np.float32) if masked else None
    want = jd.sinkhorn_knopp_teacher(
        jnp.asarray(t), 0.07, sample_mask=None if mask is None
        else jnp.asarray(mask))
    got = td.sinkhorn_knopp_teacher(_t(t), 0.07,
                                    sample_mask=None if mask is None
                                    else _t(mask))
    _close(got, want, 1e-4)


def test_softmax_center_and_dino_loss_match_jax():
    t, c = _logits(1, 8), _logits(2, 1, scale=0.1)
    s = [_logits(3 + i, 8) for i in range(3)]
    tw = jd.softmax_center_teacher(jnp.asarray(t), jnp.asarray(c), 0.04)
    tt = td.softmax_center_teacher(_t(t), _t(c), 0.04)
    _close(tt, tw, 1e-5)
    _close(td.dinov2_dino_loss([_t(x) for x in s], [tt, tt * 0.5]),
           jd.dinov2_dino_loss([jnp.asarray(x) for x in s], [tw, tw * 0.5]),
           1e-5)


def test_ibot_patch_loss_matches_jax():
    s, t = _logits(5, 20), _logits(6, 20)
    tw = np.asarray(jax.nn.softmax(jnp.asarray(t) / 0.07, axis=-1))
    w = np.random.default_rng(7).uniform(size=20).astype(np.float32)
    w[15:] = 0                                      # padding rows
    _close(td.ibot_patch_loss(_t(s), _t(tw), _t(w), 6),
           jd.ibot_patch_loss(jnp.asarray(s), jnp.asarray(tw),
                              jnp.asarray(w), 6), 1e-5)


def test_koleo_loss_and_gradient_match_jax():
    x = _logits(8, 16, k=24, scale=1.0)
    x[5] = x[3]                                     # identical neighbours
    xt = _t(x).requires_grad_()
    loss = td.koleo_loss(xt)
    loss.backward()
    _close(loss, jd.koleo_loss(jnp.asarray(x)), 1e-5)
    _close(xt.grad, jax.grad(jd.koleo_loss)(jnp.asarray(x)), 1e-4)


# --------------------------------------------------------------------------- #
# multi-crop
# --------------------------------------------------------------------------- #

def _jax_crop_draws(key, batch, cfg):
    """`_jax_draws` plus the blur and solarize draws of `device_augment`."""
    out = _jax_draws(key, batch, cfg)
    if cfg.blur_p > 0:
        kr, kp = jax.random.split(jax.random.fold_in(key, 3))
        out["blur_sigma"] = torch.from_numpy(np.array(jax.random.uniform(
            kr, (batch,), minval=cfg.blur_radius[0],
            maxval=cfg.blur_radius[1])))
        out["blur"] = torch.from_numpy(np.array(
            jax.random.uniform(kp, (batch, 1, 1, 1)) < cfg.blur_p
        ).reshape(batch))
    if cfg.solarize_p > 0:
        out["solarize"] = torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(key, 4), (batch, 1, 1, 1))
            < cfg.solarize_p).reshape(batch))
    return out


def test_crop_configs_match_jax():
    params = {"dataset_params": {"train_transforms": {}}}
    jspec = jmc.STRATEGIES["dinov2"]
    tspec = tmc.STRATEGIES["dinov2"]
    assert tmc.resolve_strategy_spec(tmc.EDict(params), "dinov2") == tspec
    j = jaugs.crop_cfgs_from_strategy(jspec, (0.5,) * 3, (0.25,) * 3,
                                      g_size=24, l_size=12)
    t = taugs.crop_cfgs_from_strategy(tspec, (0.5,) * 3, (0.25,) * 3,
                                      g_size=24, l_size=12)
    assert [vars(c) for c in t] == [vars(c) for c in j]
    assert len(t) == 10 and t[1].solarize_p == 0.2 and t[0].blur_p == 1.0


def test_device_multicrop_with_blur_and_solarize_matches_jax():
    spec = jmc.STRATEGIES["dinov2"]
    jcfgs = jaugs.crop_cfgs_from_strategy(spec, (0.5, 0.4, 0.3),
                                          (0.2, 0.25, 0.3), g_size=24,
                                          l_size=12)[:4]
    tcfgs = taugs.crop_cfgs_from_strategy(tmc.STRATEGIES["dinov2"],
                                          (0.5, 0.4, 0.3), (0.2, 0.25, 0.3),
                                          g_size=24, l_size=12)[:4]
    images = np.random.default_rng(4).integers(0, 256, (5, 28, 28, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    wg, wl = jaugs.device_multicrop(jnp.asarray(images), key, jcfgs, 2,
                                    compute_dtype=jnp.float32)
    draws = [_jax_crop_draws(jax.random.fold_in(key, i), 5, c)
             for i, c in enumerate(jcfgs)]
    assert draws[0]["blur"].any() and draws[1]["solarize"].any()
    gg, gl = taugs.apply_device_multicrop(torch.from_numpy(images), draws,
                                          tcfgs, 2,
                                          compute_dtype=torch.float32)
    assert gg.shape == (10, 24, 24, 3) and gl.shape == (10, 12, 12, 3)
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-4,
                               atol=1e-4)
    # and with fresh draws from a generator: the shapes, crop-major
    g2, l2 = taugs.device_multicrop(torch.from_numpy(images),
                                    torch.Generator().manual_seed(0), tcfgs,
                                    2, compute_dtype=torch.float32)
    assert g2.shape == gg.shape and l2.shape == gl.shape


def test_gaussian_blur_matches_jax():
    imgs = np.random.default_rng(6).uniform(size=(3, 11, 13, 3)).astype(
        np.float32)
    cfg = jaugs.DeviceAugConfig(blur_p=1.0)
    key = jax.random.PRNGKey(0)
    # the JAX function draws its own sigmas: read them back from its key
    kr, _ = jax.random.split(key)
    sigma = np.array(jax.random.uniform(kr, (3,), minval=0.1, maxval=2.0))
    want = jaugs._gaussian_blur_batch(jnp.asarray(imgs), key, cfg)
    got = taugs.gaussian_blur(torch.from_numpy(imgs), torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
