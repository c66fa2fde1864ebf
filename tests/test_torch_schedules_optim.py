"""The port's LR schedules, losses and optimizers against the JAX package's.

- `LRScheduler.lr(it)` for every scheduler type (and their recipes'
  compositions), with the plateau feedback, against the JAX
  `LRScheduler`: exactly equal (the port's copy is line for line).
- `cosine_with_warmup_table`: exactly equal.
- Each optimizer's update, with the weight-decay mask (a decayed kernel,
  not-decayed bias/scale/gamma/proj_bt leaves) and the global-norm clip,
  against its optax chain over a 20-step gradient sequence with a varying
  lr: float32 rtol 2e-5, atol 2e-6 (the two sum and divide in different
  orders; that is the tolerance tests/test_optimizer_parity.py holds the
  JAX chain to against torch.optim).
- cross entropy (integer and soft targets) and BCE against the JAX losses:
  rtol = atol = 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apla_tpu.train import losses as jlosses
from apla_tpu.train import schedules as jsched
from apla_tpu.train.optim import build_optimizer as jbuild, set_lr
from apla_tpu_torch.train import losses as tlosses
from apla_tpu_torch.train import schedules as tsched
from apla_tpu_torch.train.optim import build_optimizer, global_norm

SCHEDULES = [
    (["LinearWarmup", "CosineAnnealingLR"],
     {"LinearWarmup": {"warmup_iters": 7}, "CosineAnnealingLR":
      {"eta_min": 1e-6}}),
    (["LinearWarmup"], {"LinearWarmup": {"warmup_epochs": 2}}),
    (["CosineAnnealingLR"], {"CosineAnnealingLR": {"eta_min": 1e-5}}),
    (["MultiStepLR"], {"MultiStepLR": {"milestones": [1, 3], "gamma": 0.5}}),
    (["PolynomialLR"], {"PolynomialLR": {"power": 2.0}}),
    (["OneCycleLR"], {"OneCycleLR": {"anneal_strategy": "linear",
                                     "final_div_factor": 1e-4}}),
    (["LinearWarmup", "OneCycleLR"],
     {"LinearWarmup": {"warmup_iters": 5}, "OneCycleLR": {}}),
    (["ReduceLROnPlateau"], {"ReduceLROnPlateau": {"mode": "max",
                                                   "patience": 1,
                                                   "factor": 0.1}}),
    (["LinearWarmup", "ReduceLROnPlateau"],
     {"LinearWarmup": {"warmup_iters": 3},
      "ReduceLROnPlateau": {"mode": "min", "patience": 0}}),
    ([None], {}),
]


@pytest.mark.parametrize("types,params", SCHEDULES)
def test_lr_schedule_matches_jax(types, params):
    kw = dict(max_lr=1e-3, steps_per_epoch=6, epochs=5)
    ours = tsched.LRScheduler(types, params, **kw)
    ref = jsched.LRScheduler(types, params, **kw)
    vals = [0.5, 0.6, 0.55, 0.5, 0.7]
    for epoch in range(5):
        for i in range(6):
            it = epoch * 6 + i
            assert ours.lr(it) == ref.lr(it), (it, types)
        ours.epoch_feedback(val_target=vals[epoch], val_loss=1 - vals[epoch])
        ref.epoch_feedback(val_target=vals[epoch], val_loss=1 - vals[epoch])
        assert ours.state_dict() == ref.state_dict()


def test_cosine_table_matches_jax():
    np.testing.assert_array_equal(
        tsched.cosine_with_warmup_table(0.04, 0.4, 50, warmup_iters=7,
                                        warmup_init_val=0.01),
        jsched.cosine_with_warmup_table(0.04, 0.4, 50, warmup_iters=7,
                                        warmup_init_val=0.01))


WD, CLIP, STEPS = 0.1, 0.5, 20
# leaf -> shape; the names exercise the no-WD rule
LEAVES = {"kernel": (4, 3), "bias": (3,), "proj_wt": (4, 2),
          "proj_bt": (2,), "scale": (3,), "gamma": (3,)}


def _run_pair(opt_type, opt_params):
    rng = np.random.default_rng(0)
    p0 = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
          for k, s in LEAVES.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i % 3 else 0.05))
              .astype(np.float32) for k, s in LEAVES.items()}
             for i in range(STEPS)]   # some steps above the clip, some below
    lrs = np.linspace(1e-2, 1e-3, STEPS)

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tx = jbuild(opt_type, dict(opt_params), jp, grad_clip=CLIP)
    state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        state = set_lr(state, float(lr))
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = build_optimizer(opt_type, dict(opt_params),
                          [(f"blocks.0.attn.{k}", p) for k, p in tp.items()],
                          grad_clip=CLIP)
    for g, lr in zip(grads, lrs):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.set_lr(float(lr))
        opt.step(global_norm([p.grad for p in tp.values()]))

    for k in LEAVES:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=2e-5, atol=2e-6,
                                   err_msg=k)


@pytest.mark.parametrize("opt_type,opt_params", [
    ("AdamW", {"lr": 1e-2, "weight_decay": WD}),
    ("AdamW", {"lr": 1e-2, "weight_decay": WD, "betas": (0.8, 0.99),
               "eps": 1e-6}),
    ("Adam", {"lr": 1e-2, "weight_decay": WD}),
    ("SGD", {"lr": 1e-2, "weight_decay": WD}),
    ("SGD", {"lr": 1e-2, "weight_decay": WD, "momentum": 0.9}),
    ("SGD", {"lr": 1e-2, "weight_decay": WD, "momentum": 0.9,
             "nesterov": True}),
    ("RMSprop", {"lr": 1e-2, "weight_decay": WD}),
    ("RMSprop", {"lr": 1e-2, "weight_decay": WD, "momentum": 0.9,
                 "alpha": 0.95}),
])
def test_optimizer_update_matches_optax(opt_type, opt_params):
    _run_pair(opt_type, opt_params)


def test_weight_decay_groups():
    params = [(n, torch.nn.Parameter(torch.zeros(s)))
              for n, s in [("fc.kernel", (4, 3)), ("fc.bias", (3,)),
                           ("blocks.0.attn.proj_wt", (4, 2)),
                           ("blocks.0.attn.proj_bt", (2,)),
                           ("blocks.0.norm1.scale", (3,)),
                           ("blocks.0.ls1.gamma", (3,)),
                           ("cls_token", (1, 1, 3)), ("odd", (5,))]]
    opt = build_optimizer("AdamW", {"lr": 1e-3, "weight_decay": 0.05},
                          params)
    groups = {g["decay"]: {id(p) for p in g["params"]}
              for g in opt.opt.param_groups}
    names = {id(p): n for n, p in params}
    assert sorted(names[i] for i in groups[True]) == [
        "blocks.0.attn.proj_wt", "cls_token", "fc.kernel"]
    opt.set_lr(0.5, wd=0.2)
    assert [(g["lr"], g["weight_decay"]) for g in opt.opt.param_groups] == \
        [(0.5, 0.2), (0.5, 0.0)]
    assert opt.get_lr() == 0.5


def test_lamb_names_its_roadmap_item():
    """LAMB is ported: the 20-step harness above against optax.lamb (each
    name its own leaf here; tests/test_torch_multilabel.py holds the
    block-stacked leaves of the APLA classifier)."""
    _run_pair("LAMB", {"lr": 1e-2, "weight_decay": WD})
    _run_pair("LAMB", {"lr": 1e-2, "weight_decay": WD, "betas": (0.8, 0.99),
                       "eps": 1e-6})


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 6)
    soft = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    tl, j = torch.from_numpy(logits), jnp.asarray(logits)
    pairs = [
        (tlosses.cross_entropy(tl.bfloat16(), torch.from_numpy(labels)),
         jlosses.cross_entropy(j.astype(jnp.bfloat16), jnp.asarray(labels))),
        (tlosses.cross_entropy(tl, torch.from_numpy(soft)),
         jlosses.cross_entropy(j, jnp.asarray(soft))),
        (tlosses.bce_with_logits(tl[:, :1], torch.from_numpy(labels % 2)),
         jlosses.bce_with_logits(j[:, :1], jnp.asarray(labels % 2))),
        (tlosses.bce_with_logits(tl, torch.from_numpy(soft)),
         jlosses.bce_with_logits(j, jnp.asarray(soft))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-6)
    assert tlosses.get_criterion("classification", True) is \
        tlosses.cross_entropy
    with pytest.raises(NotImplementedError):
        tlosses.get_criterion("segmentation", True)
