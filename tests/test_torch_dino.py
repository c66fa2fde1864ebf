"""The port's DINO v1 objective against the JAX package's.

- `make_teacher_temp_schedule` (exact), `dino_pair_ce` and `dino_loss` with
  the center EMA (1e-5 relative, and their gradients).
- Three-step trajectories of `make_dino_train_step`.  Recipe:
  `params/synthetic/vit_tiny/dino.yml` in float32 (a 12-block ViT-Ti/8 at
  32 px, APLA-16, 2 global 32-px + 8 local 16-px crops, the DINO head over
  1024 prototypes), b4, built by the JAX `DINOWrapper`; its state goes to
  the port's through `dino_state_from_jax`.  Both steps get the same ready
  crops (the JAX step's non-raw branch) and the same lr, wd, EMA momentum
  and teacher temperature per step, and take the first step with the last
  layer frozen.  Accumulation 1 and 2, each with the fused APLA path on
  (the JAX kernel in interpret mode, the port's plain version on CPU
  tensors) and off.  They step with SGD, for the reason
  `test_torch_dinov2_step.py` gives.
- One step on the host multi-crop (`test_host_crop_step_matches_jax`):
  the dino strategy's crops from each package's loader, held bit-equal
  (`test_torch_multicrop.host_batch`), stacked by `DINOTrainer.
  stack_views`, at the same tolerances.
- The slice end to end: `DINOWrapper` -> `DINOTrainer.train()`, a
  checkpoint that reloads the trainables, the teacher and the center, and
  a resumed second epoch that continues `iters` with the last layer
  trained and the teacher temperature past its warm-up.  (The CLI run of
  `--dino` is `test_torch_trainer.py`'s `test_cli_ssl_flags_run`.)

Tolerance: float32 on both sides, differing in the order of sums.  The
loss, the center: 1e-4 relative; each weight tensor, trainable and
teacher, |delta| within 1e-4 of its largest magnitude (a tensor that
starts at zero, the APLA bias columns, is all update: 1e-3 of its largest
update where that is larger); each trainable's update within 1e-2 of its
own norm; the gradient norm 1e-3 relative.
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn
from apla_tpu.parallel.mesh import replicated_sharding
from apla_tpu.ssl import dino as jd
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.ssl import dino as td
from apla_tpu_torch.utils.pretrained import dino_state_from_jax
from tests.test_torch_multicrop import host_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(ROOT, "params", "synthetic", "vit_tiny", "dino.yml")
B = 4
LR = 0.05
# (EMA momentum, wd, teacher temperature, last layer frozen) per step
SCHEDULE = [(0.99, 0.04, 0.04, True), (0.993, 0.05, 0.055, False),
            (0.996, 0.06, 0.07, False)]
TOL = 1e-5
GRAD_NORM_TOL = 1e-3


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


def _close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol,
                               atol=tol * np.abs(np.asarray(want)).max(),
                               err_msg=name)


# --------------------------------------------------------------------------- #
# schedule and losses
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("args", [(0.04, 0.07, 30, 100), (0.04, 0.07, 1, 1),
                                  (0.04, 0.07, 5, 3), (0.03, 0.05, 0, 4)])
def test_teacher_temp_schedule_is_jax(args):
    got = td.make_teacher_temp_schedule(*args)
    want = jd.make_teacher_temp_schedule(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _outs(rng, n, k=64, b=6, scale=3.0):
    return [(rng.standard_normal((b, k)) * scale).astype(np.float32)
            for _ in range(n)]


def test_pair_ce_and_loss_with_center_match_jax():
    rng = np.random.default_rng(0)
    student, teacher = _outs(rng, 10), _outs(rng, 2)
    center = (rng.standard_normal((1, 64)) * 0.5).astype(np.float32)
    for tt in (0.04, 0.07):
        jl, jc = jd.dino_loss([jnp.asarray(s) for s in student],
                              [jnp.asarray(t) for t in teacher],
                              jnp.asarray(center), tt)
        ts = [torch.from_numpy(s).requires_grad_() for s in student]
        tl, tc = td.dino_loss(ts, [torch.from_numpy(t) for t in teacher],
                              torch.from_numpy(center), tt)
        _close(tl, jl, name=f"loss {tt}")
        _close(tc, jc, name=f"center {tt}")
        assert tl.dtype == tc.dtype == torch.float32
        # the gradient reaches the student chunks only
        tl.backward()
        jgrads = jax.grad(lambda ss: jd.dino_loss(
            ss, [jnp.asarray(t) for t in teacher], jnp.asarray(center),
            tt)[0])([jnp.asarray(s) for s in student])
        for i, (t, j) in enumerate(zip(ts, jgrads)):
            _close(t.grad, j, name=f"d student {i}")
    # same-view pairs are skipped: 2 teacher chunks x 9 other views
    q = [torch.softmax(torch.from_numpy(t), -1) for t in teacher]
    s = [torch.from_numpy(x) for x in student]
    want = sum(torch.mean(torch.sum(-qi * torch.log_softmax(sj / 0.1, -1),
                                    -1))
               for i, qi in enumerate(q) for j, sj in enumerate(s)
               if i != j) / 18
    _close(td.dino_pair_ce(s, q), want.numpy(), name="pair count")


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


def _crops(n):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((2 * B, 32, 32, 3)).astype(np.float32),
             rng.standard_normal((8 * B, 16, 16, 3)).astype(np.float32))
            for _ in range(n)]


def _jax_run(params, batches):
    w = jd.DINOWrapper(params)
    w.instantiate()
    t = jd.DINOTrainer(w)
    init = jax.tree.map(np.asarray, (t.state, t.frozen))
    # the crops replicated, not split over the test mesh's devices: a
    # sharded batch changes the JAX step's reduction order
    repl = replicated_sharding(w.mesh)
    state, out = t.state, []
    for (g, loc), (mom, wd, tt, freeze) in zip(batches, SCHEDULE):
        state, m = t._get_step(freeze)(
            state, t.frozen, jax.device_put(g, repl),
            jax.device_put(loc, repl), LR, wd, mom, tt, t.rng)
        out.append((jax.tree.map(np.asarray, state),
                    {k: float(v) for k, v in m.items()}))
    return init, out


def _port_run(params, init, batches):
    params = copy.deepcopy(params)
    params.system_params.device = "cpu"
    w = td.DINOWrapper(params)
    w.instantiate()
    st = dino_state_from_jax(*init)
    w.model.load_state_dict({**st["frozen"], **st["trainable"]}, strict=True)
    state = w.state
    assert set(state.teacher) == set(st["teacher"])
    state.load_aux({**{f"teacher.{n}": v for n, v in st["teacher"].items()},
                    "center": st["center"]})
    steps = {f: td.make_dino_train_step(
        w.vit_cfg, w.optimizer, 2, 8, freeze_last_layer=f,
        accum_steps=int(params.training_params.accum_steps))
        for f in (True, False)}
    out = []
    for (g, loc), (mom, wd, tt, freeze) in zip(batches, SCHEDULE):
        state, m = steps[freeze](state, torch.from_numpy(g),
                                 torch.from_numpy(loc), LR, wd, mom, tt,
                                 torch.Generator().manual_seed(0))
        out.append(({n: p.detach().clone()
                     for n, p in state.trainable().items()},
                    {n: t.clone() for n, t in state.teacher.items()},
                    state.center.clone(),
                    {k: float(v) for k, v in m.items()}))
    return st, out


def _check(name, got, want, before=None, update_norm=True):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64).reshape(got.shape)
    bound = 1e-4 * np.abs(want).max()
    if before is not None:
        before = before.numpy().astype(np.float64)
        bound = max(bound, 1e-3 * np.abs(want - before).max())
    assert np.abs(got - want).max() <= max(bound, 1e-12), name
    if before is not None and update_norm:
        d_want = np.linalg.norm(want - before)
        if d_want > 0:
            assert np.linalg.norm((got - before) - (want - before)) \
                <= 1e-2 * d_want, name


@pytest.mark.parametrize("accum,fused", [(1, True), (1, False), (2, True),
                                         (2, False)])
def test_three_steps_match_jax(accum, fused):
    params = _params(accum, fused)
    batches = _crops(3)
    init, jax_states = _jax_run(params, batches)
    st, port = _port_run(params, init, batches)
    _check_steps(st, port, jax_states)
    # the first step froze the last layer: its gradient was zeroed, so only
    # SGD's coupled weight decay moved `last_v`; the later steps trained it
    v0 = st["trainable"]["head.last_v"]
    wd0 = SCHEDULE[0][1]
    torch.testing.assert_close(port[0][0]["head.last_v"], v0 * (1 - LR * wd0),
                               rtol=1e-6, atol=1e-9)
    moved = port[1][0]["head.last_v"] \
        - port[0][0]["head.last_v"] * (1 - LR * SCHEDULE[1][1])
    assert float(moved.abs().max()) > 1e-6
    # norm_last_layer: the magnitude g gets no gradient and no decay
    assert torch.equal(port[-1][0]["head.last_g"],
                       st["trainable"]["head.last_g"])


def test_host_crop_step_matches_jax():
    """One step on the host multi-crop's first batch (the dino strategy's
    2 global and 8 local crops, made by each package's loader and held
    bit-equal; the port's through `DINOTrainer.stack_views`), at the
    trajectories' tolerances; the fused path on."""
    params = _params(1, True)
    views = host_batch("dino", params)["image"]
    assert [v.shape[1] for v in views] == [32] * 2 + [16] * 8
    g = np.concatenate(views[:2])
    loc = np.concatenate(views[2:])
    trainer = types.SimpleNamespace(device=torch.device("cpu"), n_global=2)
    tg, tl = td.DINOTrainer.stack_views(
        trainer, [torch.from_numpy(v) for v in views])
    assert np.array_equal(tg.numpy(), g) and np.array_equal(tl.numpy(), loc)
    init, jax_states = _jax_run(params, [(g, loc)])
    st, port = _port_run(params, init, [(g, loc)])
    _check_steps(st, port, jax_states)


def _check_steps(st, port, jax_states):
    """The port's steps (`_port_run`) against JAX's (`_jax_run`) from the
    same start `st`: the metrics, every trainable, teacher tensor and the
    center, under the module docstring's tolerances."""
    for i, ((jstate, jm), (tr, te, center, tm)) in enumerate(
            zip(jax_states, port)):
        assert set(tm) == set(jm), i
        for k, v in jm.items():
            tol = GRAD_NORM_TOL if k == "grad_norm" else 1e-4
            assert abs(tm[k] - v) <= tol * max(abs(v), 1e-3), (i, k, tm[k], v)
        jst = dino_state_from_jax(jstate, {})
        assert set(tr) == set(jst["trainable"])
        for n, t in tr.items():
            _check(f"step {i} trainable {n}", t, jst["trainable"][n],
                   st["trainable"][n])
        for n, t in te.items():
            _check(f"step {i} teacher {n}", t, jst["teacher"][n],
                   st["teacher"][n], update_norm=False)
        _check(f"step {i} center", center, jst["center"])


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
    """One DINO epoch: finite losses, frozen weights kept bit for bit, the
    trainables (not `last_g`, which norm_last_layer fixes) and the teacher
    moved, the center moved off zero; the kNN validation on the teacher's
    backbone; the checkpoint reloads the trainables, teacher and center
    into a wrapper of other weights; a resumed second epoch continues
    `iters` at the post-warm-up teacher temperature, with `last_v`
    trained."""
    wrapper = td.DINOWrapper(_run_params(tmp_path))
    wrapper.instantiate()
    trainer = td.DINOTrainer(wrapper)
    assert (trainer.n_global, trainer.n_local) == (2, 8)
    state = trainer.state
    frozen = {n: t.clone() for n, t in state.frozen().items()}
    trainable = {n: p.detach().clone() for n, p in state.trainable().items()}
    teacher = {n: t.clone() for n, t in state.teacher.items()}
    trainer.train()
    records = [r for _, r in trainer.history if "train_loss" in r]
    assert len(records) == trainer.iters == 4
    assert np.isfinite([r["train_loss"] for r in records]).all()
    assert all(r["teacher_temp"] == pytest.approx(0.04) for r in records)
    assert any("knn_val_accuracy" in r for _, r in trainer.history)
    for n, t in state.frozen().items():
        assert torch.equal(t, frozen[n]), n
    for n, p in state.trainable().items():
        assert torch.equal(p, trainable[n]) == (n == "head.last_g"), n
    for n, t in state.teacher.items():
        if n != "head.last_g":
            assert not torch.equal(t, teacher[n]), n
    assert float(state.center.abs().max()) > 0

    other = td.DINOWrapper(_run_params(tmp_path, epochs=2))
    other.instantiate(seed=1)                  # other weights, replaced
    resumed = td.DINOTrainer(other)
    resumed._restore(trainer.checkpoint_path)
    for n, p in resumed.state.trainable().items():
        assert torch.equal(p, state.trainable()[n]), n
    for n, t in resumed.state.teacher.items():
        assert torch.equal(t, state.teacher[n]), n
    assert torch.equal(resumed.state.center, state.center)
    v_before = resumed.state.trainable()["head.last_v"].detach().clone()
    resumed.restore_session = True
    resumed.train()
    records = [(it, r) for it, r in resumed.history if "train_loss" in r]
    assert [it for it, _ in records] == [5, 6, 7, 8]
    assert all(r["teacher_temp"] == pytest.approx(0.07) for _, r in records)
    # epoch 2 trains the last layer (AdamW's decay alone moves it by
    # lr * wd * |v|, far less)
    step = (resumed.state.trainable()["head.last_v"].detach()
            - v_before).abs().max()
    assert float(step) > 1e-5
