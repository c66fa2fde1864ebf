"""The port's memory-efficient attention (`ops/mha.py`) against the JAX
package's Pallas attention kernel (`pallas_mha.vmem_mha`, run in the Pallas
interpreter, forward and the gradients of its custom VJP).

The same numpy q, k, v (and cotangent) go to both: the kernels' plain
versions take them packed `[B, N, 3C]` as the qkv matmul emits them, the
JAX function as `[B, N, H, Dh]`.  Tolerances: float32 rtol = atol = 1e-4
(sum order only); bfloat16 max|err| <= 2e-2 * max|ref| (both round p, the
output and ds to bf16 at the same points; f32 sums in another order can
move a value across a bf16 rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_mha
from apla_tpu_torch.ops import mha as tmha
from apla_tpu_torch.ops.flash_attention import flash_mha

H, DH = 2, 64
SCALE = DH ** -0.5
F32_TOL = 1e-4
BF16_REL_TOL = 2e-2


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_mha.INTERPRET = True
    yield
    pallas_mha.INTERPRET = False


def _inputs(b, n, seed):
    """q, k, v, dO [B, N, H, Dh] float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, H, DH)).astype(np.float32)
            for _ in range(4)]


def _packed(q, k, v, dtype):
    b, n = q.shape[:2]
    qkv = np.concatenate([t.reshape(b, n, H * DH) for t in (q, k, v)], -1)
    return torch.from_numpy(qkv).to(dtype)


def _jax(q, k, v, d_o, dtype, seg):
    """JAX forward output and (dq, dk, dv) through the custom VJP."""
    args = [jnp.asarray(t, dtype) for t in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: pallas_mha.vmem_mha(
        a, b, c, SCALE, segment_len=seg), *args)
    grads = vjp(jnp.asarray(d_o, dtype))
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (out, *grads)]


def _close(got, ref, dtype):
    got = np.asarray(got, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        err = np.abs(got - ref).max()
        assert err <= BF16_REL_TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,seg", [(64, 0), (100, 0), (257, 0), (100, 30)])
def test_plain_versions_match_vmem_mha(dtype, n, seg):
    """mha_fwd_reference / mha_bwd_reference against the TPU kernel's
    forward and custom-VJP backward: N a tile multiple, ragged (padded to
    112 on the TPU), the served length, and segments with a partial last
    one."""
    q, k, v, d_o = _inputs(2, n, seed=n + seg)
    j_out, j_dq, j_dk, j_dv = _jax(q, k, v, d_o, getattr(jnp, dtype), seg)
    tdt = getattr(torch, dtype)
    qkv = _packed(q, k, v, tdt)
    out = tmha.mha_fwd_reference(qkv, H, SCALE, seg)
    assert out.shape == (2, n, H * DH) and out.dtype == tdt
    _close(out.float().reshape(2, n, H, DH), j_out, dtype)
    d_o_t = torch.from_numpy(d_o.reshape(2, n, H * DH)).to(tdt)
    dqkv = tmha.mha_bwd_reference(qkv, d_o_t, H, SCALE, seg)
    assert dqkv.shape == qkv.shape and dqkv.dtype == tdt
    for got, ref in zip(dqkv.float().chunk(3, dim=-1), (j_dq, j_dk, j_dv)):
        _close(got.reshape(2, n, H, DH), ref, dtype)


def test_segments_are_block_diagonal():
    """With segment_len, each segment's output equals attention over that
    segment alone (the packed DINOv2 local crops)."""
    q, k, v, _ = _inputs(1, 90, seed=5)
    qkv = _packed(q, k, v, torch.float32)
    packed = tmha.mha_fwd_reference(qkv, H, SCALE, 30)
    for s in range(3):
        alone = tmha.mha_fwd_reference(qkv[:, 30 * s:30 * (s + 1)], H, SCALE)
        torch.testing.assert_close(packed[:, 30 * s:30 * (s + 1)], alone,
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n,seg", [(100, 0), (100, 25)])
def test_flash_mha_and_function_run_plain_versions_on_cpu(n, seg):
    """flash_mha ([B, N, H, Dh] like the JAX function) and the autograd
    Function on CPU tensors: the plain versions, no kernel launch, output
    and gradients as the JAX kernel's in float32."""
    q, k, v, d_o = _inputs(2, n, seed=11 + seg)
    j_out, j_dq, j_dk, j_dv = _jax(q, k, v, d_o, jnp.float32, seg)
    launches = (tmha.mha_fwd.launches, tmha.mha_bwd.launches)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = flash_mha(tq, tk, tv, scale=SCALE, segment_len=seg)
    assert out.shape == (2, n, H, DH)
    _close(out.detach(), j_out, "float32")
    out.backward(torch.from_numpy(d_o))
    for t, ref in zip((tq, tk, tv), (j_dq, j_dk, j_dv)):
        _close(t.grad, ref, "float32")
    qkv = _packed(q, k, v, torch.float32).requires_grad_()
    o = tmha.mha(qkv, H, SCALE, seg)
    o.backward(torch.from_numpy(d_o.reshape(2, n, H * DH)))
    _close(o.detach().reshape(2, n, H, DH), j_out, "float32")
    for got, ref in zip(qkv.grad.chunk(3, dim=-1), (j_dq, j_dk, j_dv)):
        _close(got.reshape(2, n, H, DH), ref, "float32")
    assert (tmha.mha_fwd.launches, tmha.mha_bwd.launches) == launches


def test_function_saves_only_qkv():
    """The custom VJP's contract: qkv is the only tensor kept for the
    backward (p is recomputed there)."""
    q, k, v, _ = _inputs(1, 20, seed=3)
    qkv = _packed(q, k, v, torch.float32).requires_grad_()
    out = tmha.mha(qkv, H, SCALE)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is qkv


@pytest.mark.parametrize("bad,match", [
    ("float32", "bfloat16"),
    ("heads", "head dim 64"),
    ("strided", "contiguous"),
    ("segment", "segment_len"),
])
def test_kernel_contract_is_checked_before_a_launch(bad, match):
    """What the CUDA kernels do not take raises, naming why; the wrappers
    check it before any launch (checked here on the CPU tensors' shapes)."""
    qkv = torch.zeros((2, 17, 3 * H * DH), dtype=torch.bfloat16)
    heads, seg = H, 0
    if bad == "float32":
        qkv = qkv.float()
    elif bad == "heads":
        heads = 4
    elif bad == "strided":
        qkv = torch.zeros((2, 17, 6 * H * DH), dtype=torch.bfloat16)[..., ::2]
    else:
        seg = -1
    with pytest.raises(ValueError, match=match):
        tmha._check_qkv(qkv, heads, seg)


def test_other_devices_raise():
    """No device other than the CPU and a card gets an attention: the
    wrappers raise rather than take another path."""
    qkv = torch.empty((1, 17, 3 * H * DH), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        tmha.mha_fwd(qkv, H, SCALE)
    with pytest.raises(ValueError, match="no attention kernel"):
        tmha.mha_bwd(qkv, qkv[..., :H * DH], H, SCALE)


# ---- the forward kernel's launch plan (ops/mha.py fwd_plan) ---------------
# The CUDA forward takes its plan from the wrapper; these hold the plan's
# promises on the CPU.  Shapes: phase 7a's and tests/test_torch_cuda.py's
# (batch, N, heads), then sweeps of every N in 1..2048 at the port's batches.

PLAN_SHAPES = [
    (1, 257, 12), (8, 257, 12), (64, 257, 12), (512, 50, 12), (2, 1370, 12),
    (8, 200, 12), (3, 100, 12), (3, 17, 12), (1, 1, 12), (2, 100, 12),
    (2, 257, 3), (4, 65, 6), (2, 320, 12), (2, 321, 12), (2, 768, 12),
    (2, 769, 12), (2, 128, 12)]
SWEEP_BATCHES = [(1, 12), (2, 12), (8, 12), (64, 12), (512, 12), (2, 3),
                 (4, 6), (8, 16)]


def _check_plan(B, N, H, seg):
    plan = tmha.fwd_plan(B, N, H, seg)
    n_t = -(-N // tmha.TILE)
    assert plan.n_tiles == n_t
    # every query tile of every (image, head) exactly once, as the kernel
    # walks them: block -> its run of items -> (image, head, group) -> tiles
    assert plan.groups * plan.q_tiles >= n_t > (plan.groups - 1) * plan.q_tiles
    assert plan.items == B * H * plan.groups
    assert (plan.blocks * plan.items_per_block >= plan.items
            > (plan.blocks - 1) * plan.items_per_block)
    # shared memory: within a block's 227 KB, and the blocks the plan counts
    # on fit an SM's 228 KB
    fixed = tmha.FIXED_SMEM
    assert plan.smem_bytes == fixed + plan.slots * tmha.SLOT_BYTES
    assert plan.smem_bytes <= 232448
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233472
    # the head is resident exactly when all its key tiles' K and V fit
    fits = fixed + n_t * tmha.SLOT_BYTES <= 232448
    assert plan.resident == fits
    if plan.kind == "row":
        assert n_t <= tmha.ROW_TILES and plan.slots == plan.kv_sets * n_t
        # a run of items only with a second K/V set to load the next into
        assert plan.items_per_block == 1 or plan.kv_sets == 2
    else:
        assert n_t > tmha.ROW_TILES and plan.kv_sets == 1
        assert plan.slots == (n_t if fits else tmha.RING_DEPTH)
        assert plan.items_per_block == 1
    # enough blocks to fill the card, wherever the tiles allow it
    assert plan.blocks >= min(tmha.SMS, B * H * n_t)
    return plan


@pytest.mark.parametrize("B,N,H", PLAN_SHAPES)
@pytest.mark.parametrize("seg", [0, 50])
def test_fwd_plan_at_the_kernel_shapes(B, N, H, seg):
    """Coverage, shared memory, residency and grid size at the shapes the
    port's paths and the card's tests launch."""
    _check_plan(B, N, H, seg)


@pytest.mark.parametrize("B,H", SWEEP_BATCHES)
@pytest.mark.parametrize("seg", [0, 7])
def test_fwd_plan_sweep(B, H, seg):
    """The same promises for every N in 1..2048; the kernels switch where
    the records say (row kernel up to N = 320, K/V resident up to 768)."""
    kinds = {}
    for n in range(1, 2049):
        plan = _check_plan(B, n, H, seg)
        kinds.setdefault((plan.kind, plan.resident), []).append(n)
    assert kinds[("row", True)] == list(range(1, 321))
    assert kinds[("two_pass", True)] == list(range(321, 769))
    assert kinds[("two_pass", False)] == list(range(769, 2049))


def test_fwd_plan_served_shapes():
    """The plans the records quote: one block per (image, head) over all
    five query tiles at b64, the tiles split at b1 and b8, runs of items
    with two K/V sets at the local crops, a ring for the 518 crop."""
    b64 = tmha.fwd_plan(64, 257, 12)
    assert (b64.kind, b64.q_tiles, b64.blocks) == ("row", 5, 768)
    assert tmha.fwd_plan(1, 257, 12).q_tiles == 1
    assert tmha.fwd_plan(8, 257, 12).q_tiles == 1
    crops = tmha.fwd_plan(512, 50, 12)
    assert crops.kv_sets == 2 and crops.items_per_block > 1
    long = tmha.fwd_plan(2, 1370, 12)
    assert (long.kind, long.resident) == ("two_pass", False)


def _check_bwd_plan(B, N, H, seg):
    """The backward's plan (`bwd_plan`): each side's blocks cover every
    own tile of every (image, head) exactly once, the shared memory is the
    kernels' layout and fits a block, and the other side is resident
    exactly when both sides' blocks, holding all of a head's tiles, fit
    two to an SM."""
    plan = tmha.bwd_plan(B, N, H, seg)
    n_t = -(-N // tmha.TILE)
    assert plan.n_tiles == n_t
    # either side: block -> (image, head) = block // groups, its tiles
    # [g * tiles, min(n_t, (g + 1) * tiles)): every own tile once
    groups = -(-n_t // plan.tiles)
    assert plan.blocks == B * H * groups
    covered = [t for g in range(groups)
               for t in range(g * plan.tiles,
                              min(n_t, (g + 1) * plan.tiles))]
    assert covered == list(range(n_t))
    pair = 2 * tmha.TILE * tmha.HEAD_DIM * 2
    assert plan.q_smem == 1024 + pair + plan.slots * pair + 256
    assert plan.k_smem == (1024 + pair + plan.slots * (pair + 3 * 64 * 4)
                           + 256)
    assert plan.smem_bytes == max(plan.q_smem, plan.k_smem) <= 232448
    fits = max(tmha.bwd_smem("query", n_t),
               tmha.bwd_smem("key", n_t)) + 1024 <= 233472 // 2
    assert plan.resident == fits
    assert plan.slots == (n_t if fits else tmha.BWD_RING)
    if plan.resident:
        assert 2 * (plan.smem_bytes + 1024) <= 233472
    else:
        # streamed: one own tile a block (nothing to reuse across them)
        assert plan.tiles == 1
    assert plan.blocks >= min(tmha.SMS, B * H * n_t)
    return plan


@pytest.mark.parametrize("B,N,H", PLAN_SHAPES)
@pytest.mark.parametrize("seg", [0, 50])
def test_bwd_plan_at_the_kernel_shapes(B, N, H, seg):
    """Coverage, shared memory and residency of the backward's plan at the
    shapes the port's paths and the card's tests launch."""
    _check_bwd_plan(B, N, H, seg)


@pytest.mark.parametrize("B,H", SWEEP_BATCHES)
@pytest.mark.parametrize("seg", [0, 7])
def test_bwd_plan_sweep(B, H, seg):
    """The same promises for every N in 1..2048; the other side's tiles
    are resident up to N = 320 (five tiles) and streamed beyond."""
    resident = [n for n in range(1, 2049)
                if _check_bwd_plan(B, n, H, seg).resident]
    assert resident == list(range(1, 321))


def test_bwd_plan_is_pure_and_cached():
    """A pure function of the shape, cached: the same plan object for the
    same arguments, equal plans from a fresh cache, and `segment_len`
    (which changes the tiles a block multiplies) leaves it alone."""
    a = tmha.bwd_plan(64, 257, 12)
    assert tmha.bwd_plan(64, 257, 12) is a
    tmha.bwd_plan.cache_clear()
    assert tmha.bwd_plan(64, 257, 12) == a
    assert tmha.bwd_plan(64, 257, 12, 50) == a
    assert a.args() == (a.tiles, 1, a.slots, a.q_smem, a.k_smem)


def test_bwd_plan_served_shapes():
    """The plans the records quote: all five tiles of a head per block at
    b64 (768 blocks a side), one tile per block at b8, one block per
    (image, head) at the local crops, a ring for the 518 crop and the
    segmenter's [8, 1025] x 16 heads."""
    b64 = tmha.bwd_plan(64, 257, 12)
    assert (b64.resident, b64.tiles, b64.blocks) == (True, 5, 768)
    assert tmha.bwd_plan(8, 257, 12).tiles == 1
    crops = tmha.bwd_plan(512, 50, 12)
    assert (crops.resident, crops.blocks) == (True, 512 * 12)
    for b, n, h in ((2, 1370, 12), (8, 1025, 16)):
        plan = tmha.bwd_plan(b, n, h)
        assert (plan.resident, plan.slots) == (False, tmha.BWD_RING)
        assert plan.blocks == b * h * -(-n // 64)


class _Lib:
    """A stand-in for a kernel library: records each C entry's arguments
    and returns 0 (queued)."""

    def __init__(self, *names):
        self.calls = {name: [] for name in names}
        for name in names:
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def call(*args):
            self.calls[name].append(args)
            return 0
        return call


@pytest.mark.parametrize("b,n,seg", [(64, 257, 0), (2, 1370, 0),
                                     (8, 200, 50)])
def test_mha_bwd_routes_through_its_plan(monkeypatch, b, n, seg):
    """The CUDA route of `mha_bwd` with the C entry replaced by a recorder:
    one call queues both launches (parts 2 | 4) with `bwd_plan`'s five ints
    and the statistics scratch [B, H, ceil(N / 64), 3, 64];
    `mha_bwd_part` queues the launch it names.  Neither counts a launch:
    `mha_bwd` counts its calls."""
    import contextlib
    c, heads = 768, 12
    lib = _Lib("mha_bwd")
    monkeypatch.setattr(tmha, "_bwd_library", lambda: lib)
    monkeypatch.setattr(tmha, "device_index", lambda t: 0)
    monkeypatch.setattr(tmha, "device_smem", lambda *a: 232448)
    monkeypatch.setattr(tmha, "launch_context",
                        lambda t: contextlib.nullcontext(7))
    stats = []
    real_stats = tmha.bwd_stats
    monkeypatch.setattr(tmha, "bwd_stats",
                        lambda *a: stats.append(real_stats(*a)) or stats[-1])
    qkv = torch.zeros((b, n, 3 * c), dtype=torch.bfloat16)
    d_o = torch.zeros((b, n, c), dtype=torch.bfloat16)
    before = tmha.mha_bwd.launches
    dqkv = tmha._launch_bwd(qkv, d_o, heads, 0.125, seg)
    tmha.mha_bwd_part(qkv, d_o, heads, 0.125, tmha.PART_KEY, seg)
    assert tmha.mha_bwd.launches == before
    (args, part_args) = lib.calls["mha_bwd"]
    plan = tmha.bwd_plan(b, n, heads, seg)
    assert args[0] == qkv.data_ptr() and args[1] == d_o.data_ptr()
    assert args[2] == dqkv.data_ptr() and args[3] == stats[0].data_ptr()
    assert stats[0].shape == (b, heads, -(-n // 64), 3, 64)
    assert args[4:10] == (b, n, c, heads, 0.125, seg)
    assert list(args[10]) == list(plan.args())
    assert args[11] == tmha.PART_QUERY | tmha.PART_KEY and args[12] == 7
    assert part_args[11] == tmha.PART_KEY
