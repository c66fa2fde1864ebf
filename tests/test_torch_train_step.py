"""The port's train / eval / embed steps against the JAX package's.

An N-step trajectory: the JAX `make_train_step` (optax AdamW with the
weight-decay mask, LinearWarmup + cosine, clip 1.0) and the port's
`make_train_step` start from one init (the JAX one, carried over by
`params_from_jax`) and take the same batches and learning rates, at
`accum_steps` 1 and 2, on the plain attention path and on the fused one
(JAX runs its Pallas kernels in interpret mode; the port's kernels run
their plain versions on CPU tensors).  Per-step loss and grad norm, and the
final trainable weights, must agree at float32 rtol = atol = 1e-4 (sum
order only).  Also the eval step's per-sample losses and logits and the
embed step against the JAX ones, and the non-finite guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.models import classifier as jclf
from apla_tpu.models import vit as jvit
from apla_tpu.ops import pallas_apla_attn
from apla_tpu.train import losses as jlosses
from apla_tpu.train import steps as jsteps
from apla_tpu.train.optim import build_optimizer as jbuild
from apla_tpu.train.schedules import LRScheduler
from apla_tpu.train.train_state import TrainState as JState
from apla_tpu_torch.models import classifier as tclf
from apla_tpu_torch.models import vit as tvit
from apla_tpu_torch.train import losses as tlosses
from apla_tpu_torch.train import steps as tsteps
from apla_tpu_torch.train.optim import build_optimizer
from apla_tpu_torch.train.train_state import TrainState
from apla_tpu_torch.utils.pretrained import params_from_jax

TOL = 1e-4
TINY = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            has_layerscale=True, layerscale_init=0.5)
N_STEPS, BATCH, LR, WD = 5, 8, 1e-3, 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    pallas_apla_attn.INTERPRET = True
    monkeypatch.setenv("APLA_FUSED_MIN_N", "0")
    yield
    pallas_apla_attn.INTERPRET = False


def _setup(fused):
    kw = dict(TINY, use_fused_apla=fused)
    jcfg = jvit.ViTConfig(compute_dtype=jnp.float32, **kw)
    tcfg = tvit.ViTConfig(compute_dtype=torch.float32, **kw)
    trainable, frozen = jclf.init_classifier(
        jax.random.PRNGKey(0), jcfg, 10, apla_cfg=JAplaConfig(partial_size=16))
    t_state, f_state = params_from_jax(jax.tree.map(np.asarray, trainable),
                                       jax.tree.map(np.asarray, frozen))
    model = tclf.classifier_from_state(tcfg, t_state, f_state,
                                       torch.device("cpu"))
    return jcfg, tcfg, trainable, frozen, model


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, BATCH)) for _ in range(N_STEPS)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_trajectory_matches_jax(accum, fused):
    jcfg, tcfg, trainable, frozen, model = _setup(fused)
    sched = LRScheduler(["LinearWarmup", "CosineAnnealingLR"],
                        {"LinearWarmup": {"warmup_iters": 2},
                         "CosineAnnealingLR": {"eta_min": 1e-6}},
                        max_lr=LR, steps_per_epoch=N_STEPS, epochs=1)
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
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for i, (x, y) in enumerate(_batches()):
        lr = sched.lr(i)
        jstate, jm = jstep(jstate, frozen, {"image": jnp.asarray(x),
                                            "label": jnp.asarray(y)}, lr, key)
        state, m = tstep(state, {"image": torch.from_numpy(x),
                                 "label": torch.from_numpy(y)}, lr, gen)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(m["logits"].numpy(),
                                   np.asarray(jm["logits"]), rtol=TOL,
                                   atol=TOL)
    assert state.step == int(jstate.step) == N_STEPS
    t_final, _ = params_from_jax(jax.tree.map(np.asarray, jstate.trainable),
                                 {"backbone": {}})
    live = dict(model.named_parameters())
    assert set(t_final) == {n for n, p in live.items() if p.requires_grad}
    for name, want in t_final.items():
        np.testing.assert_allclose(live[name].detach().numpy(), want.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_eval_and_embed_steps_match_jax():
    jcfg, tcfg, trainable, frozen, model = _setup(fused=False)
    x, y = _batches(1)[0]
    j_losses, j_logits = jsteps.make_eval_step(jcfg, jlosses.cross_entropy)(
        trainable, frozen, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    t_losses, t_logits = tsteps.make_eval_step(tcfg, tlosses.cross_entropy)(
        model, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert t_losses.shape == (BATCH,)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)
    j_emb = jsteps.make_embed_step(jcfg)(trainable, frozen, jnp.asarray(x))
    t_emb = tsteps.make_embed_step(tcfg)(model, torch.from_numpy(x))
    assert t_emb.dtype == torch.float32
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=TOL,
                               atol=TOL)


def test_nonfinite_step_keeps_params_and_optimizer_state():
    _, tcfg, _, _, model = _setup(fused=False)
    opt = build_optimizer("AdamW", {"lr": LR, "weight_decay": WD},
                          [(n, p) for n, p in model.named_parameters()
                           if p.requires_grad], grad_clip=1.0)
    state = TrainState(0, model, opt)
    step = tsteps.make_train_step(tcfg, opt, tlosses.cross_entropy,
                                  skip_nonfinite=True)
    gen = torch.Generator().manual_seed(0)
    x, y = _batches(2)[0]
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    state, m = step(state, batch, LR, gen)
    assert m["nonfinite"] == 0
    before = {n: p.detach().clone() for n, p in state.trainable().items()}
    opt_before = {k: v["exp_avg"].clone()
                  for k, v in opt.opt.state_dict()["state"].items()}
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 0, 0, 0] = float("nan")
    state, m = step(state, bad, LR, gen)
    assert m["nonfinite"] == 1 and state.step == 2
    for n, p in state.trainable().items():
        assert torch.equal(p, before[n]), n
    for k, v in opt.opt.state_dict()["state"].items():
        assert torch.equal(v["exp_avg"], opt_before[k])
