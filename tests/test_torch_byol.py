"""The port's BYOL and SimSiam objective against the JAX package's.

- The BatchNorm heads (`ssl/heads.py`): `batch_norm` in training (over
  three updates with the running stats carried, and its gradients) and in
  eval, the BYOL projection head at 2 and 3 layers and the prediction MLP
  with their stats carried across calls, and what `init_*` builds.
- The losses `byol_loss` and `simsiam_loss`.
- Three-step trajectories of `make_byol_train_step`.  Recipe:
  `params/synthetic/vit_tiny/byol.yml` in float32 (a 12-block ViT-Ti/8 at
  32 px, APLA-16; the heads at the JAX defaults: BYOL 256 / 4096 / 2
  layers / predictor 4096, SimSiam 2048 / 2048 / 3 / 512), b8, built by
  the JAX `BYOLWrapper`; its state goes to the port's through
  `byol_state_from_jax`.  Both steps get the same ready views (the JAX
  step's non-raw branch), the same lr and EMA momentum.  BYOL at
  accumulation 1 and 2 with the fused APLA path on (the JAX kernel in
  interpret mode, the port's plain version on CPU tensors) and at 2 with
  it off; SimSiam at accumulation 1 with it on and at 2 with it off.  Not
  SimSiam's fused path at accumulation 2: there the JAX package's fused
  path reads 0.6% of the APLA columns' update (4% of `head.fc1.kernel`'s)
  away from its own plain path, where elsewhere the two read ~1e-5
  apart, and the port's two paths agree to 4e-6 and sit 5e-5 from JAX's
  plain path.  They step with SGD, for the reason
  `test_torch_dinov2_step.py` gives: AdamW moves an element whose gradient
  is at rounding level by +-lr either way, SGD's update is linear in the
  gradient.
- One BYOL and one SimSiam step on the host multi-crop
  (`test_host_crop_step_matches_jax`): the byol strategy's two global
  crops from each package's loader, held bit-equal
  (`test_torch_multicrop.host_batch`), at the trajectories' tolerances.
- The slice end to end: `BYOLWrapper` -> `BYOLTrainer.train()` with a
  checkpoint that reloads the trainables, the teacher and the BN running
  stats, and a resumed run that continues `iters`.  (The CLI runs of
  `--byol` and `--simsiam` are `test_torch_trainer.py`'s
  `test_cli_ssl_flags_run`.)

Tolerance: float32 on both sides, differing in the order of sums.  The
heads and losses: 1e-5 relative.  The trajectories: the loss and the BN
running stats 1e-4 relative; each weight tensor, trainable and teacher,
|delta| within 1e-4 of its largest magnitude (a tensor that starts at
zero, the APLA bias columns, is all update: 1e-3 of its largest update
where that is larger, as `test_torch_dino.py` holds it); each trainable's
update (after minus before) within 1e-2 of its own norm; the gradient norm
1e-3 relative.  The BatchNorm heads make a few quantities 0 in exact
arithmetic, so that both sides hold only their own rounding there and
cannot be held to each other: the Linear biases that a BatchNorm follows
and the bias of the projection head's last BatchNorm (whose output goes
into the predictor's first Linear and BatchNorm) get no gradient, and the
predictor's BatchNorm takes a batch mean of 0 into its running mean.  The
port is held to exact arithmetic there instead: each such bias, trainable
and teacher, moves by at most RESIDUE_TOL of the step's largest update
(JAX's), and that running mean stays within RESIDUE_TOL of the largest
running mean.  (Both sides move those biases by ~1e-7 of the largest
update or less.)
"""

from __future__ import annotations

import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn
from apla_tpu.parallel.mesh import replicated_sharding
from apla_tpu.ssl import byol as jb
from apla_tpu.ssl import heads as jh
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.ssl import byol as tb
from apla_tpu_torch.ssl import heads as th
from apla_tpu_torch.utils.pretrained import byol_state_from_jax
from tests.test_torch_multicrop import host_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(ROOT, "params", "synthetic", "vit_tiny", "byol.yml")
B = 8
LR = 0.05
MOMENTA = (0.99, 0.993, 0.996)
HEAD_TOL = 1e-5
GRAD_NORM_TOL = 1e-3
RESIDUE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    old = pallas_apla_attn.INTERPRET
    pallas_apla_attn.INTERPRET = True
    monkeypatch.setenv("APLA_FUSED_MIN_N", "0")
    yield
    pallas_apla_attn.INTERPRET = old


def _close(got, want, tol=HEAD_TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stats_to_torch(tree):
    return {k: _stats_to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _load_jax_params(module, params):
    """Copy a JAX head's params tree into the port module."""
    flat = {}
    for name, val in tb._tree_items(_np_tree(params)):
        flat[name] = torch.from_numpy(np.array(val))
    module.load_state_dict(flat, strict=True)


# --------------------------------------------------------------------------- #
# heads
# --------------------------------------------------------------------------- #

def test_batch_norm_train_updates_and_eval_match_jax():
    rng = np.random.default_rng(0)
    d = 24
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    bn = th.BatchNorm(d)
    bn.load_state_dict({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    js = {"mean": jnp.zeros(d), "var": jnp.ones(d)}
    ts = {"mean": torch.zeros(d), "var": torch.ones(d)}
    for i in range(3):
        x = (rng.standard_normal((16, d)) * (1 + i)
             + rng.standard_normal(d)).astype(np.float32)
        jy, js = jh.batch_norm(jnp.asarray(x), jp, js, train=True)
        ty, ts = th.batch_norm(torch.from_numpy(x), bn, ts, train=True)
        _close(ty, jy, name=f"y {i}")
        for k in ("mean", "var"):
            _close(ts[k], js[k], name=f"{k} {i}")
    # biased variance, momentum on the old stats: not F.batch_norm's rule
    assert not np.allclose(ts["var"].numpy(),
                           0.9 ** 3 + 0.1 * np.var(x, axis=0, ddof=1))
    ey, es = th.batch_norm(torch.from_numpy(x), bn, ts, train=False)
    jey, _ = jh.batch_norm(jnp.asarray(x), jp, js, train=False)
    _close(ey, jey, name="eval y")
    assert es is ts
    # gradients through the batch statistics and the affine part
    g = rng.standard_normal((16, d)).astype(np.float32)

    def jloss(x, p):
        return jnp.sum(jh.batch_norm(x, p, js, train=True)[0] * g)

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    (th.batch_norm(tx, bn, ts, train=True)[0]
     * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jgx, name="dx")
    _close(bn.scale.grad, jgp["scale"], name="dscale")
    _close(bn.bias.grad, jgp["bias"], name="dbias")


@pytest.mark.parametrize("num_layers", [2, 3])
def test_byol_head_and_predictor_match_jax(num_layers):
    rng = np.random.default_rng(num_layers)
    d_in, d_out, hidden = 32, 16, 48
    k1, k2 = jax.random.split(jax.random.PRNGKey(num_layers))
    jhp, jhs = jh.init_byol_head(k1, d_in, d_out, hidden, num_layers)
    jpp, jps = jh.init_prediction_mlp(k2, d_out, d_out, hidden)
    # non-trivial affine parts
    jhp = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), jhp)
    head = th.BYOLHead(d_in, d_out, hidden, num_layers)
    pred = th.PredictionMLP(d_out, d_out, hidden)
    _load_jax_params(head, jhp)
    _load_jax_params(pred, jpp)
    ths, tps = _stats_to_torch(_np_tree(jhs)), _stats_to_torch(_np_tree(jps))
    for i, train in enumerate((True, True, False)):
        x = rng.standard_normal((12, d_in)).astype(np.float32)
        jproj, jhs = jh.byol_head_forward(jnp.asarray(x), jhp, jhs, train)
        jq, jps = jh.prediction_mlp_forward(jproj, jpp, jps, train)
        tproj, ths = th.byol_head_forward(torch.from_numpy(x), head, ths,
                                          train)
        tq, tps = th.prediction_mlp_forward(tproj, pred, tps, train)
        _close(tproj, jproj, name=f"projection {i}")
        _close(tq, jq, name=f"prediction {i}")
        want = dict(tb._tree_items(_np_tree({"head": jhs, "pred": jps})))
        got = dict(tb._tree_items({"head": ths, "pred": tps}))
        assert set(got) == set(want)
        for name, t in got.items():
            _close(t, want[name], name=f"{name} {i}")


@pytest.mark.parametrize("num_layers", [2, 3])
def test_init_shapes_and_values_match_jax(num_layers):
    jhp, jhs = jh.init_byol_head(jax.random.PRNGKey(0), 64, 32, 128,
                                 num_layers)
    jpp, jps = jh.init_prediction_mlp(jax.random.PRNGKey(1), 32, 32, 96)
    gen = torch.Generator().manual_seed(0)
    head, hs = th.init_byol_head(64, 32, 128, num_layers, generator=gen)
    pred, ps = th.init_prediction_mlp(32, 32, 96, generator=gen)
    for module, params, stats, jstats in ((head, jhp, hs, jhs),
                                          (pred, jpp, ps, jps)):
        want = dict(tb._tree_items(_np_tree(params)))
        got = dict(module.named_parameters())
        assert {n: tuple(p.shape) for n, p in got.items()} == \
            {n: v.shape for n, v in want.items()}
        for n, p in got.items():
            if n.endswith("kernel"):
                assert 0.01 < float(p.detach().std()) < 0.03, n
                assert float(p.detach().abs().max()) <= 0.04 + 1e-6, n
            else:                              # biases 0, BN scale 1
                np.testing.assert_array_equal(p.detach().numpy(), want[n])
        want = dict(tb._tree_items(_np_tree(jstats)))
        got = dict(tb._tree_items(stats))
        assert set(got) == set(want)
        for n, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[n])


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    preds = [rng.standard_normal((8, 16)).astype(np.float32)
             for _ in range(2)]
    targets = [rng.standard_normal((8, 16)).astype(np.float32)
               for _ in range(2)]
    tp = [torch.from_numpy(p) for p in preds]
    tt = [torch.from_numpy(t) for t in targets]
    jp = [jnp.asarray(p) for p in preds]
    jt = [jnp.asarray(t) for t in targets]
    _close(tb.byol_loss(tp, tt), jb.byol_loss(jp, jt), name="byol")
    _close(tb.simsiam_loss(tp, tt), jb.simsiam_loss(jp, jt), name="simsiam")
    # identical pairs: BYOL 0, SimSiam -1 (two pairs of -1/2)
    assert abs(float(tb.byol_loss(tp, tp))) < 1e-6
    assert abs(float(tb.simsiam_loss(tp, tp)) + 1.0) < 1e-6


# --------------------------------------------------------------------------- #
# three-step trajectories
# --------------------------------------------------------------------------- #

def _params(accum, fused):
    params = load_merged_params(YML)
    params.dataset_params.synthetic_size = 16
    for ld in params.dataloader_params.values():
        ld.update(batch_size=B, num_workers=0)
    params.training_params.update(is_dry=True, accum_steps=accum,
                                  use_mixed_precision=False)
    params.model_params.transformers_params.use_fused_apla = fused
    params.optimization_params.default.optimizer.type = "SGD"
    return params


def _views(n):
    rng = np.random.default_rng(0)
    return [[rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
             for _ in range(2)] for _ in range(n)]


def _jax_run(params, use_momentum, batches):
    w = jb.BYOLWrapper(params, use_momentum=use_momentum)
    w.instantiate()
    t = jb.BYOLTrainer(w)
    init = _np_tree((t.state, t.frozen))
    # the views replicated, not split over the test mesh's devices: a
    # sharded batch changes the JAX step's reduction order
    repl = replicated_sharding(w.mesh)
    state, out = t.state, []
    for views, mom in zip(batches, MOMENTA):
        state, m = t.train_step(state, t.frozen,
                                jax.device_put(list(views), repl), LR, mom,
                                t.rng)
        out.append((_np_tree(state), {k: float(v) for k, v in m.items()}))
    return init, out


def _port_state(wrapper, st):
    """The port wrapper's state, loaded with a `byol_state_from_jax`
    state (weights, teacher, BN running stats: `load_aux`)."""
    wrapper.model.load_state_dict({**st["frozen"], **st["trainable"]},
                                  strict=True)
    state = wrapper.state
    assert set(state.teacher) == set(st["teacher"])
    assert set(n for n, _ in tb._tree_items(state.model_state)) == \
        set(st["model_state"])
    state.load_aux({**{f"teacher.{n}": v for n, v in st["teacher"].items()},
                    **{f"model_state.{n}": v
                       for n, v in st["model_state"].items()}})
    return state


def _port_run(params, use_momentum, init, batches):
    """The port's three steps from the JAX init."""
    params = copy.deepcopy(params)
    params.system_params.device = "cpu"
    w = tb.BYOLWrapper(params, use_momentum=use_momentum)
    w.instantiate()
    st = byol_state_from_jax(*init)
    state = _port_state(w, st)
    step = tb.make_byol_train_step(
        w.vit_cfg, w.optimizer, use_momentum,
        accum_steps=int(params.training_params.accum_steps))
    out = []
    for views, mom in zip(batches, MOMENTA):
        state, m = step(state, [torch.from_numpy(v) for v in views], LR,
                        mom, torch.Generator().manual_seed(0))
        out.append(({n: p.detach().clone()
                     for n, p in state.trainable().items()},
                    {n: t.clone() for n, t in state.teacher.items()},
                    {n: t.clone() for n, t in
                     tb._tree_items(state.model_state)},
                    {k: float(v) for k, v in m.items()}))
    return st, out


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float64)


def _residue(name, names) -> bool:
    """A bias with no gradient in exact arithmetic: a Linear bias that a
    BatchNorm follows, or the bias of the projection head's last
    BatchNorm."""
    last = sum(1 for n in names if re.fullmatch(r"head\.fc\d+\.kernel", n)) - 1
    return (re.fullmatch(r"(head\.fc\d+|predictor\.fc0)\.bias", name)
            is not None or name == f"head.bn{last}.bias")


def check_weight(name, got, want, before=None, update_norm=True):
    """`got` against `want` (the JAX tensor) within 1e-4 of max|want|, or
    1e-3 of the largest element of the update where that is larger; with
    `before` and `update_norm` the update itself within 1e-2 of its
    norm."""
    got = _np(got)
    want = _np(want).reshape(got.shape)
    bound = 1e-4 * np.abs(want).max()
    if before is not None:
        before = _np(before)
        bound = max(bound, 1e-3 * np.abs(want - before).max())
    assert np.abs(got - want).max() <= max(bound, 1e-12), name
    if before is not None and update_norm:
        assert np.linalg.norm(got - want) \
            <= 1e-2 * np.linalg.norm(want - before), name


def check_residue(name, got, before, scale):
    """`got` within RESIDUE_TOL * `scale` of `before`: a quantity that
    exact arithmetic leaves where it was."""
    moved = np.abs(_np(got) - _np(before)).max()
    assert moved <= RESIDUE_TOL * scale, (name, moved, scale)


def check_metrics(i, got, want):
    assert set(got) == set(want), i
    for k, v in want.items():
        tol = GRAD_NORM_TOL if k == "grad_norm" else 1e-4
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-3), (i, k, got[k], v)


@pytest.mark.parametrize("use_momentum,accum,fused", [
    (True, 1, True), (True, 2, True), (True, 2, False), (False, 1, True),
    (False, 2, False)],
    ids=["byol-accum1-fused", "byol-accum2-fused", "byol-accum2-plain",
         "simsiam-accum1-fused", "simsiam-accum2-plain"])
def test_three_steps_match_jax(use_momentum, accum, fused):
    params = _params(accum, fused)
    batches = _views(3)
    init, jax_states = _jax_run(params, use_momentum, batches)
    st, port = _port_run(params, use_momentum, init, batches)
    _check_steps(use_momentum, st, port, jax_states)


@pytest.mark.parametrize("use_momentum", [True, False],
                         ids=["byol", "simsiam"])
def test_host_crop_step_matches_jax(use_momentum):
    """One step on the host multi-crop's first batch (the byol strategy's
    two global crops, made by each package's loader and held bit-equal),
    the fused path on, at the trajectories' tolerances."""
    params = _params(1, True)
    views = host_batch("byol", params)["image"]
    assert len(views) == 2 and views[0].shape == (B, 32, 32, 3)
    init, jax_states = _jax_run(params, use_momentum, [views])
    st, port = _port_run(params, use_momentum, init, [views])
    _check_steps(use_momentum, st, port, jax_states)


def _check_steps(use_momentum, st, port, jax_states):
    """The port's steps (`_port_run`) against JAX's (`_jax_run`) from the
    same start `st`, under the tolerances of the module docstring."""
    names = list(st["trainable"])
    residues = [n for n in names if _residue(n, names)]
    assert len(residues) == (4 if use_momentum else 5), residues
    for i, ((jstate, jm), (tr, te, ms, tm)) in enumerate(
            zip(jax_states, port)):
        check_metrics(i, tm, jm)
        jst = byol_state_from_jax(jstate, {})
        assert set(tr) == set(jst["trainable"])
        largest_update = max(
            np.abs(_np(jst["trainable"][n]) - _np(st["trainable"][n])).max()
            for n in names if n not in residues)
        for n, t in tr.items():
            if n in residues:
                check_residue(f"step {i} trainable {n}", t,
                              st["trainable"][n], largest_update)
            else:
                check_weight(f"step {i} trainable {n}", t,
                             jst["trainable"][n], st["trainable"][n])
        for n, t in te.items():
            if n in residues:
                check_residue(f"step {i} teacher {n}", t, st["teacher"][n],
                              largest_update)
            else:
                check_weight(f"step {i} teacher {n}", t, jst["teacher"][n],
                             st["teacher"][n], update_norm=False)
        largest_mean = max(np.abs(_np(v)).max()
                           for n, v in jst["model_state"].items()
                           if n.endswith(".mean"))
        for n, t in ms.items():
            if n == "student.predictor.bn0.mean":
                check_residue(f"step {i} {n}", t, torch.zeros_like(t),
                              largest_mean)
            else:
                check_weight(f"step {i} {n}", t, jst["model_state"][n])
    # SimSiam's teacher never moves; BYOL's does
    moved = any(not torch.equal(t, st["teacher"][n])
                for n, t in port[-1][1].items())
    assert moved == use_momentum


# --------------------------------------------------------------------------- #
# the slice end to end
# --------------------------------------------------------------------------- #

def _run_params(save_dir, epochs=1):
    params = load_merged_params(YML)
    params.dataset_params.synthetic_size = 64
    params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.update(batch_size=16, num_workers=0)
    params.training_params.update(epochs=epochs, log_every=1, val_every=1.0,
                                  save_dir=str(save_dir))
    return params


def test_trains_checkpoints_and_resumes(tmp_path):
    """One BYOL epoch: finite losses, frozen weights kept bit for bit, the
    trainables, the teacher and every BN running stat moved; the checkpoint
    reloads the trainables, teacher and stats into a wrapper of other
    weights; a second epoch resumed from it continues `iters`."""
    wrapper = tb.BYOLWrapper(_run_params(tmp_path), use_momentum=True)
    wrapper.instantiate()
    trainer = tb.BYOLTrainer(wrapper)
    state = trainer.state
    frozen = {n: t.clone() for n, t in state.frozen().items()}
    trainable = {n: p.detach().clone() for n, p in state.trainable().items()}
    teacher = {n: t.clone() for n, t in state.teacher.items()}
    stats = {n: t.clone() for n, t in tb._tree_items(state.model_state)}
    trainer.train()
    losses = [r["train_loss"] for _, r in trainer.history
              if "train_loss" in r]
    assert len(losses) == trainer.iters == 4 and np.isfinite(losses).all()
    for n, t in state.frozen().items():
        assert torch.equal(t, frozen[n]), n
    for n, p in state.trainable().items():
        assert not torch.equal(p, trainable[n]), n
    for n, t in state.teacher.items():
        assert not torch.equal(t, teacher[n]), n
    for n, t in tb._tree_items(state.model_state):
        assert not torch.equal(t, stats[n]), n

    other = tb.BYOLWrapper(_run_params(tmp_path, epochs=2),
                           use_momentum=True)
    other.instantiate(seed=1)                  # other weights, replaced
    resumed = tb.BYOLTrainer(other)
    resumed._restore(trainer.checkpoint_path)
    for n, p in resumed.state.trainable().items():
        assert torch.equal(p, state.trainable()[n]), n
    for n, t in resumed.state.teacher.items():
        assert torch.equal(t, state.teacher[n]), n
    want = dict(tb._tree_items(state.model_state))
    for n, t in tb._tree_items(resumed.state.model_state):
        assert torch.equal(t, want[n]), n
    resumed.restore_session = True
    resumed.train()
    assert resumed.iters == 8
    assert [it for it, r in resumed.history if "train_loss" in r] == \
        [5, 6, 7, 8]
