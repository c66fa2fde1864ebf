"""The port's DINOv2 train step against the JAX package's, three steps.

Recipe: `params/synthetic/vit_tiny/dinov2.yml` in float32 (a 12-block
ViT-Ti/8 at 32 px, APLA-16, 2 global + 8 local crops, DINO + iBOT heads
with 256 prototypes, KoLeo) with LayerScale at 1.0 instead of 1e-5 (at a
random init 1e-5 leaves the images' cls tokens nearly equal, and KoLeo's
nearest-neighbour distances then cancel to a few f32 ulps), built by the
JAX `DINOv2Wrapper`; its weights
go to the port's `DINOv2Wrapper` through `dinov2_state_from_jax`.  Both
steps get the same batch dicts with ready crops (the JAX step's non-raw
branch), the same schedule values, and take the first step with the
prototype layer frozen.  They step with SGD: AdamW divides each gradient
element by its own running magnitude, so an element whose gradient is at
the level of bf16 rounding noise (the prototype CE rounds ds to bf16 on
both sides, at boundaries that f32 sums in another order can cross) moves
by +-lr either way; SGD's update is linear in the gradient.  AdamW's own
parity is held by `test_torch_schedules_optim.py`.  Every `fused_proto_ce` mode at accumulation 1 and
2, and APLA "full" mode.  The JAX prototype-CE kernel runs in interpret
mode.  One more step on the host multi-crop (`test_host_crop_step_
matches_jax`): the dinov2 strategy's crops through each package's loader
and iBOT collate, held bit-equal (`test_torch_multicrop.host_batch`), at
the same tolerances.

Tolerance: float32 on both sides, differing in the order of sums; the
prototype CE rounds its inputs and ds to bf16 on both.  Loss terms and the
centers: 1e-4 relative.  Weights (trainable and teacher): |delta| within
1e-4 of the tensor's largest magnitude, per tensor; for the trainable
tensors also the update itself (after minus before) within 1e-2 of its own
norm.  (The teacher's per-step change, (1 - m)(s - t), is small enough that
the rounding of the EMA itself is a few percent of it.)  A tensor that
starts at zero (the APLA bias columns) is all update: its |delta| bound is
1e-3 of its largest update where that is larger.  The gradient norm:
1e-3 relative.  Where the DINO sites run the prototype CE too, a few of
their rows carry large cotangents, and an element of ds at a bf16 rounding
boundary rounds one bf16 step (2^-8 of itself) apart on the two sides; the
norm then moves by ~1.5e-4 of itself by step 3 (the weights' updates by
~3e-4 of their norms, inside the 1e-2 bound above).
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_proto_ce as ppc
from apla_tpu.parallel.mesh import replicated_sharding
from apla_tpu.ssl import dinov2 as jd
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.ssl import dinov2 as td
from apla_tpu_torch.utils.pretrained import dinov2_state_from_jax
from tests.test_torch_multicrop import host_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(ROOT, "params", "synthetic", "vit_tiny", "dinov2.yml")
B = 4
LR, WD = 0.03, 0.04
SCHEDULE = [(0.994, 0.04, True), (0.995, 0.05, False), (0.996, 0.06, False)]
GRAD_NORM_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret():
    old = ppc.INTERPRET
    ppc.INTERPRET = True
    yield
    ppc.INTERPRET = old


def _params(fused, accum, partial):
    params = load_merged_params(YML)
    params.dataset_params.synthetic_size = 16
    for ld in params.dataloader_params.values():
        ld.update(batch_size=B, num_workers=0)
    tp = params.training_params
    tp.update(is_dry=True, accum_steps=accum, use_mixed_precision=False)
    d2 = params.model_params.dinov2
    d2.fused_proto_ce = fused
    d2.dino.head_n_prototypes = d2.ibot.head_n_prototypes = 256
    params.model_params.adaptation.params.partial_size = partial
    params.model_params.transformers_params.student.layerscale = 1.0
    params.optimization_params.default.optimizer.type = "SGD"
    return params


def _batches(n):
    rng = np.random.default_rng(0)
    collate = jd.make_ibot_collate(2, 8, (0.1, 0.5), 0.5, 16,
                                   jd.MaskingGenerator((4, 4),
                                                       max_num_patches=8),
                                   seed=1)
    out = []
    for _ in range(n):
        samples = [{"image": [rng.standard_normal((32, 32, 3)).astype(np.float32)
                       for _ in range(2)]
                    + [rng.standard_normal((16, 16, 3)).astype(np.float32)
                       for _ in range(8)], "label": i}
                   for i in range(B)]
        out.append(collate(samples))
    return out


def _jax_run(params, batches):
    w = jd.DINOv2Wrapper(params)
    w.instantiate()
    t = jd.Dinov2Trainer(w)
    init = jax.tree.map(np.asarray, (t.state, t.frozen))
    states = []
    state = t.state
    # the batch replicated, not split over the test mesh's 8 devices: a
    # sharded batch changes the JAX step's reduction order
    repl = replicated_sharding(w.mesh)
    for batch, (mom, tt, freeze) in zip(batches, SCHEDULE):
        dbatch = jax.device_put(
            {k: v for k, v in batch.items()
             if v is not None and k not in ("label", "n_masked_patches")},
            repl)
        state, m = t._get_step(freeze)(state, t.frozen, dbatch, LR, WD, mom,
                                       tt, t.rng)
        states.append((jax.tree.map(np.asarray, state),
                       {k: float(v) for k, v in m.items()}))
    return init, states


def _port_run(params, init, batches):
    params = copy.deepcopy(params)
    params.system_params.device = "cpu"
    w = td.DINOv2Wrapper(params)
    w.instantiate()
    jstate, jfrozen = init
    st = dinov2_state_from_jax(jstate, jfrozen)
    w.model.load_state_dict({**st["frozen"], **st["trainable"]}, strict=True)
    state = w.state
    assert set(state.teacher) == set(st["teacher"])
    with torch.no_grad():
        for n, v in st["teacher"].items():
            state.teacher[n].copy_(v)
        state.dino_center.copy_(st["dino_center"])
        state.ibot_center.copy_(st["ibot_center"])
    d2 = params.model_params.dinov2
    steps = {f: td.make_dinov2_train_step(
        w.vit_cfg, w.optimizer, d2, 2, 8, freeze_last_layer=f,
        accum_steps=int(params.training_params.accum_steps))
        for f in (True, False)}
    out = []
    for batch, (mom, tt, freeze) in zip(batches, SCHEDULE):
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
              if v is not None and k not in ("label", "n_masked_patches")}
        state, m = steps[freeze](state, tb, LR, WD, mom, tt,
                                 torch.Generator().manual_seed(0))
        out.append(({n: p.detach().clone()
                     for n, p in state.trainable().items()},
                    {n: t.clone() for n, t in state.teacher.items()},
                    state.dino_center.clone(), state.ibot_center.clone(),
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


@pytest.mark.parametrize("fused,accum,partial", [
    (False, 1, 16), ("ibot", 1, 16), (True, 1, 16),
    (False, 2, 16), ("ibot", 2, 16), (True, 2, 16),
    (False, 1, "full"),
])
def test_three_steps_match_jax(fused, accum, partial):
    params = _params(fused, accum, partial)
    batches = _batches(3)
    init, jax_states = _jax_run(params, batches)
    st, port = _port_run(params, init, batches)
    _check_steps(st, port, jax_states)
    # the first step froze the prototype layer: its gradient was zeroed, so
    # only SGD's coupled weight decay moved it; the later steps trained it
    v0 = st["trainable"]["dino_head.last_v"]
    torch.testing.assert_close(port[0][0]["dino_head.last_v"],
                               v0 * (1 - LR * WD),
                               rtol=1e-6, atol=1e-9)
    moved = port[1][0]["dino_head.last_v"] - port[0][0][
        "dino_head.last_v"] * (1 - LR * WD)
    assert float(moved.abs().max()) > 1e-6


def test_host_crop_step_matches_jax():
    """One step on the host multi-crop's first batch (the dinov2 strategy's
    2 global and 8 local crops through each package's iBOT collate, crop
    stacks and mask buffers held bit-equal), the iBOT site fused, at the
    trajectories' tolerances."""
    params = _params("ibot", 1, 16)
    batch = host_batch("dinov2", params)
    assert batch["collated_global_crops"].shape == (2 * B, 32, 32, 3)
    assert batch["collated_local_crops"].shape == (8 * B, 16, 16, 3)
    init, jax_states = _jax_run(params, [batch])
    st, port = _port_run(params, init, [batch])
    _check_steps(st, port, jax_states)


def _check_steps(st, port, jax_states):
    """The port's steps (`_port_run`) against JAX's (`_jax_run`) from the
    same start `st`: the metrics, every trainable and teacher tensor and
    both centers, under the module docstring's tolerances."""
    for i, ((jstate, jm), (tr, te, dc, ic, tm)) in enumerate(
            zip(jax_states, port)):
        assert set(tm) == set(jm), i
        for k, v in jm.items():
            tol = GRAD_NORM_TOL if k == "grad_norm" else 1e-4
            assert abs(tm[k] - v) <= tol * max(abs(v), 1e-3), (i, k, tm[k], v)
        jst = dinov2_state_from_jax(jstate, {})
        assert set(tr) == set(jst["trainable"])
        for n, t in tr.items():
            _check(f"step {i} trainable {n}", t, jst["trainable"][n],
                   st["trainable"][n])
        for n, t in te.items():
            _check(f"step {i} teacher {n}", t, jst["teacher"][n],
                   st["teacher"][n], update_norm=False)
        _check(f"step {i} dino_center", dc, jst["dino_center"])
        _check(f"step {i} ibot_center", ic, jst["ibot_center"])


def test_fused_mode_typo_rejected():
    from apla_tpu_torch.utils.config import EDict
    for bad in ("iBOT", "true", "dino"):
        cfg = EDict({"dino": {"loss_weight": 1.0, "koleo_loss_weight": 0.1},
                     "ibot": {"loss_weight": 1.0}, "fused_proto_ce": bad})
        with pytest.raises(ValueError, match="fused_proto_ce"):
            td.make_dinov2_train_step(None, None, cfg, 2, 8, False)
