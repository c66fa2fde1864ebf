"""The port's prototype CE (`apla_tpu_torch/ops/proto_ce.py`) against the
JAX package's Pallas kernel (`apla_tpu.ops.pallas_proto_ce.proto_ce`), run
in interpret mode as the JAX package's own tests run it on the CPU.

On CPU tensors the port's wrappers run the plain versions, so this holds
the plain forward, `ProtoCE`'s custom backward and the wrappers' contract
(the teacher side gets no gradient, the teacher temperature changes from
call to call) against the TPU kernel's function.  Inputs are numpy draws
from a seed.  Tolerance: both sides round the inputs to bf16 and take f32
products and logits, so they differ by the order of f32 sums: 1e-4
relative to the largest magnitude of each output (ce, dxs, dws; ds is
rounded to bf16 on both sides from f32 values that agree to ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_proto_ce as ppc
from apla_tpu_torch.ops import proto_ce as tpc

TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret():
    old = ppc.INTERPRET
    ppc.INTERPRET = True
    yield
    ppc.INTERPRET = old


def _inputs(seed, R, D, K):
    rng = np.random.default_rng(seed)

    def unit(shape, axis):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=axis, keepdims=True)

    return (unit((R, D), -1), unit((D, K), 0), unit((R, D), -1),
            unit((D, K), 0), (0.1 * rng.standard_normal(K)).astype(np.float32),
            rng.uniform(size=R).astype(np.float32))


def _jax(xs, ws, xt, wt, c, w_rows, tt):
    def loss(xs, ws):
        ce = ppc.proto_ce(xs, ws, xt, wt, c, jnp.float32(tt), 0.1)
        return jnp.sum(ce * w_rows), ce

    (_, ce), (dxs, dws) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(xs, ws)
    return [np.asarray(a) for a in (ce, dxs, dws)]


def _torch(xs, ws, xt, wt, c, w_rows, tt):
    xs_t = torch.from_numpy(xs).requires_grad_()
    ws_t = torch.from_numpy(ws).requires_grad_()
    ce = tpc.proto_ce(xs_t, ws_t, torch.from_numpy(xt), torch.from_numpy(wt),
                      torch.from_numpy(c), tt, 0.1)
    (ce * torch.from_numpy(w_rows)).sum().backward()
    return [a.detach().numpy() for a in (ce, xs_t.grad, ws_t.grad)]


def _close(got, ref, names=("ce", "dxs", "dws")):
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= TOL * np.abs(b).max(), (name, err, np.abs(b).max())


@pytest.mark.parametrize("R,D,K", [
    (10, 16, 300),       # one block, ragged in every dim
    (24, 256, 512),      # the recipe's bottleneck width
    (37, 64, 1000),      # ragged R and K
])
def test_matches_jax_kernel(R, D, K):
    args = _inputs(R + K, R, D, K)
    for tt in (0.04, 0.07):       # the teacher temperature changes per call
        _close(_torch(*args, tt), _jax(*args, tt))


@pytest.mark.parametrize("R,D,K,live", [
    (40, 256, 512, 13),   # the bottleneck width, a zero tail inside a tile
    (37, 64, 1000, 10),   # ragged R and K
    (70, 32, 200, 64),    # the tail starts on a 64-row boundary
])
def test_matches_jax_with_zero_g_tail(R, D, K, live):
    """The collate's layout: the iBOT buffer's real rows come first and the
    rest carry weight 0 (g = 0 exactly), which the CUDA backward skips."""
    xs, ws, xt, wt, c, w_rows = _inputs(R * K + live, R, D, K)
    w_rows[live:] = 0
    args = (xs, ws, xt, wt, c, w_rows)
    for tt in (0.04, 0.07):
        got, ref = _torch(*args, tt), _jax(*args, tt)
        _close(got, ref)
        assert not got[1][live:].any()            # dxs of a g = 0 row


def test_matches_jax_on_a_multi_block_grid(monkeypatch):
    """Rows and prototypes over several of the TPU kernel's tiles (its
    online rescaling and both accumulator revisits)."""
    monkeypatch.setattr(ppc, "_BR", 16)
    monkeypatch.setattr(ppc, "_BK", 256)
    args = _inputs(7, 50, 32, 900)
    _close(_torch(*args, 0.04), _jax(*args, 0.04))


def test_wrappers_match_the_plain_versions_and_each_other():
    xs, ws, xt, wt, c, g = (torch.from_numpy(a)
                            for a in _inputs(3, 20, 32, 200))
    ce, lse_s, lse_t = tpc.proto_ce_fwd(xs, ws, xt, wt, c, 0.05, 0.1)
    bf = torch.bfloat16
    s = xs.to(bf).float() @ ws.to(bf).float() / 0.1
    t = (xt.to(bf).float() @ wt.to(bf).float() - c) / 0.05
    assert torch.allclose(lse_s, torch.logsumexp(s, -1), rtol=1e-6)
    assert torch.allclose(lse_t, torch.logsumexp(t, -1), rtol=1e-6)
    ref = -(torch.softmax(t, -1) * torch.log_softmax(s, -1)).sum(-1)
    assert torch.allclose(ce, ref, rtol=1e-5, atol=1e-5)
    dxs = tpc.proto_ce_dxs(xs, ws, xt, wt, c, 0.05, 0.1, lse_s, lse_t, g)
    dws = tpc.proto_ce_dws(xs, ws, xt, wt, c, 0.05, 0.1, lse_s, lse_t, g)
    assert dxs.shape == (20, 32) and dws.shape == (32, 200)
    assert dxs.dtype == dws.dtype == torch.float32
    # CPU calls run the plain versions and launch nothing
    assert tpc.proto_ce_fwd.launches == tpc.proto_ce_dxs.launches == \
        tpc.proto_ce_dws.launches == 0


def test_teacher_side_gets_no_gradient():
    xs, ws, xt, wt, c, _ = (torch.from_numpy(a).requires_grad_()
                            for a in _inputs(4, 8, 16, 256))
    ce = tpc.ProtoCE.apply(xs, ws, xt, wt, c, 0.07, 0.1)
    ce.sum().backward()
    assert xs.grad is not None and ws.grad is not None
    assert xt.grad is None and wt.grad is None and c.grad is None
    # the public entry detaches the teacher side outright
    out = tpc.proto_ce(xs, ws, xt, wt, c, 0.07, 0.1)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), ce.detach())


def test_split_work_covers_every_tile_without_empty_splits():
    for n_own, n_loop in ((256, 1024), (2, 1024), (16, 1024), (16, 16),
                          (1, 1), (3, 5), (1024, 256)):
        per, n = tpc.split_work(n_own, n_loop, 132)
        assert per * n >= n_loop and per * (n - 1) < n_loop
        assert n_own * n <= max(132, n_own) + n_own


@pytest.mark.parametrize("bad,match", [
    ((10, 128, 256), "bottleneck dim 256"),
    ((10, 256, 260), "multiple of 8"),
])
def test_cuda_contract_is_checked_before_any_launch(bad, match):
    """The checks the CUDA path makes run on any tensors: what the kernels
    cannot take raises instead of falling back."""
    R, D, K = bad
    xs, ws, xt, wt, c, _ = (torch.from_numpy(a) for a in _inputs(5, R, D, K))
    with pytest.raises(ValueError, match=match):
        tpc._cuda_inputs(xs, ws, xt, wt, c)


# The launch plan of the CUDA backward (`proto_bwd_plan`): chip_smoke.py
# phase 6a's four cases, the iBOT site, and the wrapper's largest R.
_PLAN_CASES = [(16384, 65536), (128, 65536), (1024, 65536), (1000, 1000),
               (65535 * 64, 65536), (70, 136), (1, 8)]


@pytest.mark.parametrize("which", ["dxs", "dws"])
@pytest.mark.parametrize("R,K", _PLAN_CASES)
def test_backward_plan_covers_every_tile_once(which, R, K):
    plan = tpc.proto_bwd_plan(which, R, K, 132)
    n_rt, n_kt = -(-R // 64), -(-K // 64)
    own, loop = (n_rt, n_kt) if which == "dxs" else (n_kt, n_rt)
    assert (plan.own_tiles, plan.loop_tiles) == (own, loop)
    # the own side: warpgroup w of block b owns tile b + w * blocks_x;
    # every tile once, the rest of the warpgroups idle
    owned = [b + w * plan.blocks_x for b in range(plan.blocks_x)
             for w in range(plan.groups)]
    assert len(set(owned)) == len(owned)
    assert set(range(own)) <= set(owned)
    assert max(owned) < own + plan.blocks_x
    # the loop side: the splits are split_work's, in 64-wide units, and the
    # kernel's 32-wide tiles of each split cover it once
    assert (plan.per, plan.splits) == tpc.split_work(own, loop, 132)
    extent = K if which == "dxs" else R
    streamed = []
    for split in range(plan.splits):
        begin = split * plan.per * 64
        end = min(extent, begin + plan.per * 64)
        assert begin < end                        # no split is empty
        streamed += range(begin, end, tpc.STREAM)
    assert streamed == list(range(0, extent, tpc.STREAM))
    # what the card takes
    assert plan.smem_bytes <= 232448
    assert plan.smem_bytes == tpc.bwd_smem(plan.groups, plan.stages)
    assert plan.stages >= 3
    assert plan.blocks_x < 2 ** 31 and plan.splits <= 65535
    assert plan.args() == (plan.groups, plan.stages, plan.splits, plan.per,
                           plan.smem_bytes, plan.blocks_x)


def test_backward_plan_groups():
    """Two consumer warpgroups a block where their blocks fill the SMs in
    fewer waves (the iBOT site), one where one-warpgroup blocks fit in one
    wave already (the DINO global site); `groups` forces either."""
    assert tpc.proto_bwd_plan("dxs", 16384, 65536).groups == 2
    assert tpc.proto_bwd_plan("dws", 16384, 65536).groups == 2
    assert tpc.proto_bwd_plan("dxs", 128, 65536).groups == 1
    for groups in (1, 2):
        plan = tpc.proto_bwd_plan("dxs", 16384, 65536, groups=groups)
        assert plan.groups == groups
        assert plan.blocks_x == -(-256 // groups)


@pytest.mark.parametrize("which,R,K,groups", [
    ("dx", 16, 64, None),
    ("dxs", 0, 64, None),
    ("dws", 16, 60, None),
    ("dws", 16, 0, None),
    ("dxs", 16, 64, 3),
])
def test_backward_plan_refuses_what_the_kernels_do_not_take(which, R, K,
                                                            groups):
    with pytest.raises(ValueError):
        tpc.proto_bwd_plan(which, R, K, 132, groups)


# The forward's launch plan (`proto_fwd_plan`): warpgroups own the row
# tiles, the blocks split K.
@pytest.mark.parametrize("R,K", _PLAN_CASES)
def test_forward_plan_covers_every_row_tile_once(R, K):
    plan = tpc.proto_fwd_plan(R, K, 132)
    n_rt, n_kt = -(-R // 64), -(-K // 64)
    assert (plan.which, plan.own_tiles, plan.loop_tiles) == ("fwd", n_rt,
                                                             n_kt)
    # warpgroup w of block b owns row tile b + w * blocks_x: every tile
    # once, the rest of the warpgroups idle
    owned = [b + w * plan.blocks_x for b in range(plan.blocks_x)
             for w in range(plan.groups)]
    assert len(set(owned)) == len(owned)
    assert set(range(n_rt)) <= set(owned)
    assert max(owned) < n_rt + plan.blocks_x
    # K: split_work's 64-wide units, each split streamed once in 32-wide
    # tiles, so the partials keep the 64-wide boundaries
    assert (plan.per, plan.splits) == tpc.split_work(n_rt, n_kt, 132)
    streamed = []
    for split in range(plan.splits):
        begin = split * plan.per * 64
        end = min(K, begin + plan.per * 64)
        assert begin < end                        # no split is empty
        streamed += range(begin, end, tpc.STREAM)
    assert streamed == list(range(0, K, tpc.STREAM))
    # what the card takes
    assert plan.smem_bytes <= 232448
    assert plan.smem_bytes == tpc.fwd_smem(plan.stages)
    assert plan.stages >= 3
    assert plan.blocks_x < 2 ** 31 and plan.splits <= 65535
    assert plan.args() == (plan.groups, plan.stages, plan.splits, plan.per,
                           plan.smem_bytes, plan.blocks_x)


@pytest.mark.parametrize("R,K,groups", [
    (16384, 65536, 2),    # iBOT: 256 one-warpgroup blocks are two waves
    (1024, 65536, 2),     # the local pairs: 144 blocks against 72
    (128, 65536, 1),      # the DINO global site: one wave either way
    (1000, 1000, 1),
    (1, 8, 1),            # one row tile
])
def test_forward_plan_groups_follow_the_waves(R, K, groups):
    """Two consumer warpgroups a block where their blocks fill the SMs in
    fewer waves by more than TWO_GROUP_COST, else one; `groups` forces
    either, and the plan's shared memory does not depend on it."""
    plan = tpc.proto_fwd_plan(R, K, 132)
    assert plan.groups == groups
    for forced in (1, 2):
        other = tpc.proto_fwd_plan(R, K, 132, forced)
        assert other.groups == forced
        assert other.blocks_x == -(-plan.own_tiles // forced)
        assert (other.splits, other.per, other.smem_bytes) == (
            plan.splits, plan.per, plan.smem_bytes)


@pytest.mark.parametrize("R,K,groups", [
    (0, 64, None),
    (16, 60, None),
    (16, 0, None),
    (16, 4, None),
    (16, 64, 3),
    (16, 64, 0),
])
def test_forward_plan_refuses_what_the_kernel_does_not_take(R, K, groups):
    with pytest.raises(ValueError):
        tpc.proto_fwd_plan(R, K, 132, groups)
