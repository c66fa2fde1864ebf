"""The port's fused Swin window attention (kernel rows 3, 4) against the JAX
package's.

`apla_tpu.ops.pallas_apla_attn.fused_swin_attention` (its custom VJP, the
Pallas kernels in interpret mode, as tests/test_fused_swin_attn.py runs
them) and the port's `FusedSwinAttention` autograd `Function` on CPU tensors
(the plain versions of both kernels) take the same inputs and the same
output cotangent, drawn with numpy: the forward, dqkv, dW and db; no
gradient reaches the bias or the mask.  Cases: N = 49 (a 7x7 window, one
64-row kernel tile) and N = 9; H = 3 heads of 32 (Swin-T's stage 0, C = 96);
shifted (a per-window mask, nW not dividing the batch) and unshifted.

Tolerances: float32 rtol = atol = 1e-4 (only the order of f32 sums
differs); bfloat16 rtol = atol = 2e-2 (both round p, o, dO and ds to bf16,
so an element may differ by one bf16 ulp of values of order 1).

The forward's two launches on the card (`csrc/swin_attn_fwd.cu`: the
attention into a scratch o, then the projection GEMM): the attention's
plain version (`swin_attn_reference`) against the JAX forward with an
identity projection, which gives its o_cat; that plain attention followed
by the GEMM's plain version equal bit for bit to the fused plain version;
the attention's launch plan (`swin_plan`: every (window, head, query tile)
once, within the card's limits) at the Swin-T stages and other windows;
the CUDA route with the C entry replaced by a recorder.  The backward's
launch plan (`swin_bwd_plan`: every (window, head) item once, a window's
heads adjacent, the tile counts, the resident limit) and its CUDA route
(three launches through one C call, or apart with shared buffers) the
same way.  The kernels
themselves are held against the plain versions by tests/test_torch_cuda.py
on the card.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn
from apla_tpu_torch.ops import cuda_build
from apla_tpu_torch.ops import fused_swin_attn as tfs
from apla_tpu_torch.ops.apla_proj_gemm import apla_proj_gemm_reference
from apla_tpu_torch.ops.mha import (BLOCK_SMEM, merge_heads, softmax_f32,
                                    split_heads)

C, H = 96, 3
SCALE = (C // H) ** -0.5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_apla_attn.INTERPRET = True
    yield
    pallas_apla_attn.INTERPRET = False


def _inputs(n, shifted, seed, b=6, n_w=4):
    rng = np.random.default_rng(seed)
    if shifted:
        blk = rng.uniform(size=(n_w, n, n)) > 0.6
        blk = blk & blk.transpose(0, 2, 1) & ~np.eye(n, dtype=bool)[None]
        mask = np.where(blk, -1e9, 0.0).astype(np.float32)
    else:
        mask = None
    return {
        "qkv": rng.standard_normal((b, n, 3 * C)).astype(np.float32),
        "w": (rng.standard_normal((C, C)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(C) * 0.1).astype(np.float32),
        "bias": (rng.standard_normal((H, n, n)) * 0.5).astype(np.float32),
        "mask": mask,
        "g": rng.standard_normal((b, n, C)).astype(np.float32),
    }


def _jax(x, dtype):
    jdt = jnp.dtype(dtype)
    wmask = x["mask"] if x["mask"] is not None else np.zeros(
        (1,) + x["bias"].shape[1:], np.float32)

    def f(qkv, w, b):
        return pallas_apla_attn.fused_swin_attention(
            qkv, w, b, jnp.asarray(x["bias"]), jnp.asarray(wmask), H, SCALE)

    out, vjp = jax.vjp(f, jnp.asarray(x["qkv"], jdt), jnp.asarray(x["w"]),
                       jnp.asarray(x["b"]))
    grads = vjp(jnp.asarray(x["g"], out.dtype))
    return [np.asarray(jnp.asarray(a, jnp.float32))
            for a in (out,) + tuple(grads)]


def _torch(x, dtype, qkv_grad=True):
    tdt = getattr(torch, dtype)
    qkv = torch.tensor(x["qkv"]).to(tdt).requires_grad_(qkv_grad)
    w = torch.tensor(x["w"], requires_grad=True)
    b = torch.tensor(x["b"], requires_grad=True)
    bias = torch.tensor(x["bias"], requires_grad=True)
    mask = None if x["mask"] is None else torch.tensor(x["mask"])
    out = tfs.fused_swin_attention(qkv, w, b, bias, mask, H, SCALE)
    out.backward(torch.tensor(x["g"]).to(out.dtype))
    assert bias.grad is None           # frozen: no cotangent
    return out, qkv, w, b


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [49, 9])
@pytest.mark.parametrize("shifted", [True, False])
def test_forward_and_vjp_match_jax(n, shifted, dtype):
    x = _inputs(n, shifted, seed=n + shifted)
    j_out, j_dqkv, j_dw, j_db = _jax(x, dtype)
    out, qkv, w, b = _torch(x, dtype)
    _close(out.detach().float(), j_out, dtype, "out")
    _close(qkv.grad.float(), j_dqkv, dtype, "dqkv")
    _close(w.grad, j_dw, dtype, "dW")
    _close(b.grad, j_db, dtype, "db")


@pytest.mark.parametrize("shifted", [True, False])
def test_plain_backward_alone_matches_jax(shifted):
    """`fused_swin_attn_bwd_reference` (the kernel's plain version, without
    the autograd Function) against the JAX cotangents, float32."""
    x = _inputs(49, shifted, seed=7)
    _, j_dqkv, j_dw, _ = _jax(x, "float32")
    mask = None if x["mask"] is None else torch.tensor(x["mask"])
    dqkv, dw = tfs.fused_swin_attn_bwd_reference(
        torch.tensor(x["qkv"]), torch.tensor(x["w"]), torch.tensor(x["g"]),
        torch.tensor(x["bias"]), mask, H, SCALE)
    _close(dqkv, j_dqkv, "float32", "dqkv")
    _close(dw, j_dw, "float32", "dW")


def test_frozen_input_still_gives_dw_and_db():
    """Stage 0 block 0: qkv comes from the frozen patch embedding and needs
    no gradient; dW and db are still those of the JAX VJP."""
    x = _inputs(49, True, seed=3)
    _, _, j_dw, j_db = _jax(x, "float32")
    _, qkv, w, b = _torch(x, "float32", qkv_grad=False)
    assert qkv.grad is None
    _close(w.grad, j_dw, "float32", "dW")
    _close(b.grad, j_db, "float32", "db")


def test_wrappers_count_nothing_on_the_cpu_and_reject_other_devices():
    x = _inputs(49, False, seed=1)
    qkv = torch.tensor(x["qkv"]).bfloat16()
    w = torch.tensor(x["w"]).bfloat16()
    bias = torch.tensor(x["bias"])
    before = (tfs.fused_swin_attn_fwd.launches,
              tfs.fused_swin_attn_bwd.launches)
    tfs.fused_swin_attn_fwd(qkv, w, bias, None, H, SCALE)
    tfs.fused_swin_attn_bwd(qkv, w, torch.zeros(6, 49, C).bfloat16(), bias,
                            None, H, SCALE)
    assert (tfs.fused_swin_attn_fwd.launches,
            tfs.fused_swin_attn_bwd.launches) == before
    with pytest.raises(ValueError, match="no fused Swin attention"):
        tfs.fused_swin_attn_fwd(qkv.to("meta"), w.to("meta"),
                                bias.to("meta"), None, H, SCALE)


@pytest.mark.parametrize("bad, match", [
    ("dtype", "bfloat16"), ("head_dim", "head dim 32"),
    ("bias", "bias must be"), ("mask", "mask must be")])
def test_kernel_argument_checks(bad, match):
    """The checks a CUDA tensor meets before a launch, run on CPU tensors
    (no card needed): each names why the kernel cannot run."""
    qkv = torch.zeros(4, 49, 3 * C, dtype=torch.bfloat16)
    w = torch.zeros(C, C, dtype=torch.bfloat16)
    bias = torch.zeros(H, 49, 49)
    mask = torch.zeros(2, 49, 49)
    heads = H
    if bad == "dtype":
        qkv = qkv.float()
    elif bad == "head_dim":
        heads = 2
        bias = torch.zeros(2, 49, 49)
    elif bad == "bias":
        bias = torch.zeros(H, 49, 48)
    else:
        mask = torch.zeros(2, 49, 49, dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        tfs._check(qkv, w, bias, mask, heads)


# ------------------------------------------------------------------ #
# the forward's two launches: the attention into a scratch o, then the
# projection GEMM over the B * N rows (csrc/swin_attn_fwd.cu)
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, shifted", [(49, True), (49, False), (9, True)])
def test_attention_half_matches_jax_with_identity_projection(n, shifted,
                                                             dtype):
    """`swin_attn_reference` (the attention launch's plain version: o, the
    heads concatenated) against the JAX forward with w = I and b = 0,
    which gives its o_cat exactly: the product by the identity is exact
    in f32 and o_cat is already in the input dtype."""
    x = _inputs(n, shifted, seed=11 + n + shifted)
    x["w"] = np.eye(C, dtype=np.float32)
    x["b"] = np.zeros(C, np.float32)
    j_out = _jax(x, dtype)[0]
    mask = None if x["mask"] is None else torch.tensor(x["mask"])
    o = tfs.swin_attn_reference(torch.tensor(x["qkv"]).to(getattr(torch,
                                                                  dtype)),
                                torch.tensor(x["bias"]), mask, H, SCALE)
    assert o.dtype == getattr(torch, dtype) and o.shape == (6, n, C)
    _close(o.float(), j_out, dtype, "o")


@pytest.mark.parametrize("b, n, n_w", [(6, 49, 4), (6, 49, 0), (5, 9, 2),
                                       (2, 100, 1)])
def test_attention_then_projection_is_the_fused_reference(b, n, n_w):
    """The composite plain path, `swin_attn_reference` then the GEMM's plain
    version (`apla_proj_gemm_reference`) over the B * N rows, equals bit
    for bit in bf16 the single kernel's arithmetic: p rounded to bf16, o
    rounded to bf16, the projection in f32 on the upcast inputs."""
    rng = np.random.default_rng(b + n + n_w)
    qkv = torch.tensor(rng.standard_normal((b, n, 3 * C)),
                       dtype=torch.float32).bfloat16()
    w = torch.tensor(rng.standard_normal((C, C)) * 0.1,
                     dtype=torch.float32).bfloat16()
    bias = torch.tensor(rng.standard_normal((H, n, n)), dtype=torch.float32)
    mask = None
    if n_w:
        mask = torch.tensor(np.where(rng.uniform(size=(n_w, n, n)) > 0.7,
                                     -1e9, 0.0), dtype=torch.float32)
    o = tfs.swin_attn_reference(qkv, bias, mask, H, SCALE)
    out = apla_proj_gemm_reference(o.reshape(b * n, C), w).reshape(b, n, C)
    assert torch.equal(out, tfs.fused_swin_attn_fwd_reference(
        qkv, w, bias, mask, H, SCALE))
    # the same arithmetic written out once more, as the single mma.sync kernel did it
    q, k, v = (split_heads(t, H) for t in qkv.chunk(3, dim=-1))
    terms = (bias[None],)
    if mask is not None:
        terms += (mask[torch.arange(b) % n_w][:, None],)
    p = softmax_f32(q, k, SCALE, 0, terms)
    o_cat = merge_heads(torch.matmul(p.bfloat16().float(), v)).bfloat16()
    assert torch.equal(o, o_cat)
    assert torch.equal(out, torch.matmul(o_cat.float(), w.float()).bfloat16())


def _covered(plan, B, H):
    """The (window, head, query tile) triples the plan's blocks visit, as
    `csrc/swin_attn_fwd.cu` walks them (`item_of`), with repeats."""
    seen = []
    for blk in range(plan.blocks):
        if plan.kind == "two_pass":
            qt, bh = blk % plan.n_tiles, blk // plan.n_tiles
            seen.append((bh // H, bh % H, qt))
            continue
        it0 = blk * plan.items_per_block
        for it in range(it0, min(plan.items, it0 + plan.items_per_block)):
            seen.append((it // H, it % H, 0))
    return seen


# (images, stage) of the Swin-T detector at 224 (chip_smoke.py SWIN_CASES):
# (56 >> s)^2 / 49 windows an image, 3 << s heads; b1 and b8 are served
@pytest.mark.parametrize("images, stage", [(16, 0), (16, 1), (16, 2),
                                           (16, 3), (1, 0), (8, 0), (1, 3),
                                           (8, 3)])
def test_swin_plan_covers_every_item_once(images, stage):
    heads = 3 << stage
    b = images * ((56 >> stage) // 7) ** 2
    plan = tfs.swin_plan(b, 49, heads)
    seen = _covered(plan, b, heads)
    assert len(seen) == len(set(seen)) == b * heads
    assert plan.kind == "row" and plan.n_tiles == 1
    assert 0 < plan.blocks < 2 ** 31
    assert plan.smem_bytes <= BLOCK_SMEM and plan.blocks_per_sm >= 1
    # two K/V sets exactly when a block runs several items
    assert (plan.kv_sets == 2) == (plan.items_per_block > 1)
    assert plan.smem_bytes == tfs.FIXED_SMEM + plan.kv_sets * tfs.SLOT_BYTES
    proj = tfs.proj_plan(b * 49, 32 * heads)
    assert proj.bn == 128 and proj.smem_bytes <= BLOCK_SMEM
    assert proj.row_tiles == -(-b * 49 // 128)


def test_swin_plan_at_the_b16_stages():
    """Stage 0 runs 3072 items in runs of eight with two K/V sets (three
    blocks an SM), stage 3 its 384 items one a block: 384 blocks where the
    single kernel (a block per window) had 16."""
    p0 = tfs.swin_plan(1024, 49, 3)
    assert (p0.items, p0.items_per_block, p0.kv_sets, p0.blocks) == (
        3072, 8, 2, 384)
    p3 = tfs.swin_plan(16, 49, 24)
    assert (p3.items, p3.items_per_block, p3.kv_sets, p3.blocks) == (
        384, 1, 1, 384)


@pytest.mark.parametrize("b, n, h", [(3, 100, 2), (2, 320, 3), (2, 321, 3),
                                     (4, 576, 6), (1, 1, 1), (6, 9, 3),
                                     (2, 64, 1), (2, 65, 1)])
def test_swin_plan_other_windows(b, n, h):
    """Windows of other sizes: the row kernel up to one key tile (64
    tokens), the two-pass kernel past it; every item once either way."""
    plan = tfs.swin_plan(b, n, h)
    seen = _covered(plan, b, h)
    assert len(seen) == len(set(seen)) == b * h * -(-n // 64)
    assert plan.kind == ("row" if n <= 64 else "two_pass")
    assert plan.smem_bytes <= BLOCK_SMEM
    assert tfs.swin_plan(b, n, h) is plan            # pure and cached


def _bwd_covered(plan):
    """The items (window b, head h at b H + h) the backward plan's blocks
    visit, in block order, as `csrc/swin_attn_bwd.cu` walks them."""
    seen = []
    for blk in range(plan.blocks):
        it0 = blk * plan.items_per_block
        seen.extend(range(it0, min(plan.items, it0 + plan.items_per_block)))
    return seen


@pytest.mark.parametrize("images, stage", [(16, 0), (16, 1), (16, 2),
                                           (16, 3), (1, 0), (8, 0), (1, 3),
                                           (8, 3)])
def test_swin_bwd_plan_covers_every_item_once(images, stage):
    """Every (window, head) item once, a block's items consecutive, so a
    window's heads are next to each other (they share its mask plane);
    within the card's limits."""
    heads = 3 << stage
    b = images * ((56 >> stage) // 7) ** 2
    plan = tfs.swin_bwd_plan(b, 49, heads)
    assert _bwd_covered(plan) == list(range(b * heads))
    assert plan.kind == "row" and plan.n_tiles == 1
    assert plan.items == b * heads
    assert 0 < plan.blocks < 2 ** 31 and plan.blocks_per_sm >= 1
    assert plan.smem_bytes <= BLOCK_SMEM
    # two input sets exactly when a block runs several items
    assert (plan.sets == 2) == (plan.items_per_block > 1)
    assert plan.smem_bytes == (tfs.BWD_ROW_FIXED
                               + plan.sets * tfs.BWD_SET_BYTES)


@pytest.mark.parametrize("b, heads, shape", [
    (1024, 3, (3072, 6, 2, 512)),      # stage 0
    (256, 6, (1536, 3, 2, 512)),       # stage 1
    (64, 12, (768, 2, 2, 384)),        # stage 2
    (16, 24, (384, 1, 1, 384)),        # stage 3
])
def test_swin_bwd_plan_at_the_b16_stages(b, heads, shape):
    """Swin-T's b16 stages: four blocks an SM over 132 SMs, runs of 6, 3
    and 2 items with two input sets at stages 0-2, an item a block at
    stage 3."""
    plan = tfs.swin_bwd_plan(b, 49, heads)
    assert (plan.items, plan.items_per_block, plan.sets,
            plan.blocks) == shape
    assert plan.blocks_per_sm == 4


@pytest.mark.parametrize("n, tiles", [(9, 1), (49, 1), (64, 1), (65, 2),
                                      (100, 2), (144, 3), (768, 12)])
def test_swin_bwd_plan_tiles(n, tiles):
    """The row kernel up to one tile (64 tokens), the tiles kernel past it:
    an item a block, its 4 n_t tiles and statistics resident."""
    plan = tfs.swin_bwd_plan(4, n, 2)
    assert plan.n_tiles == tiles
    assert plan.kind == ("row" if tiles == 1 else "tiles")
    assert plan.smem_bytes <= BLOCK_SMEM
    if tiles > 1:
        assert (plan.items_per_block, plan.blocks, plan.sets) == (1, 8, 1)
        assert plan.smem_bytes == tfs._bwd_smem("tiles", tiles)
    assert tfs.swin_bwd_plan(4, n, 2) is plan            # pure and cached
    assert str(tiles) in plan.describe()


@pytest.mark.parametrize("n", [769, 1024])
def test_swin_bwd_plan_refuses_past_the_resident_limit(n):
    """A window whose q, k, v and dO tiles do not fit one block's shared
    memory is refused by name, not run."""
    assert tfs.BWD_MAX_TILES == 12
    with pytest.raises(ValueError, match="at most 12 fit"):
        tfs.swin_bwd_plan(2, n, 1)


class _Recorder:
    """Stands for the loaded library: records the C entry's calls."""

    def __init__(self):
        self.calls = []

    def swin_attn_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("b, n, c, n_w", [(1024, 49, 96, 64), (16, 49, 768, 0),
                                          (3, 100, 64, 1)])
def test_forward_routes_through_one_call_of_both_launches(monkeypatch, b, n,
                                                          c, n_w):
    """The CUDA route with the C entry replaced by a recorder: one call
    queues the attention and the projection (`parts` = 3) with
    `swin_plan`'s and `proj_plan`'s plans, the attention writing a scratch
    o that the projection reads, and counts one launch; the parts apart
    queue one launch each, uncounted, the projection reading the o given."""
    lib = _Recorder()
    monkeypatch.setattr(tfs, "_fwd_library", lambda: lib)
    monkeypatch.setattr(tfs, "device_smem", lambda *a: 232448)
    monkeypatch.setattr(tfs, "device_index", lambda t: 0)
    monkeypatch.setattr(tfs, "launch_context",
                        lambda t: contextlib.nullcontext(7))
    heads = c // 32
    qkv = torch.zeros((b, n, 3 * c), dtype=torch.bfloat16)
    w = torch.zeros((c, c), dtype=torch.bfloat16)
    bias = torch.zeros((heads, n, n))
    mask = torch.zeros((n_w, n, n)) if n_w else None
    before = tfs.fused_swin_attn_fwd.launches
    out = tfs._launch_fwd(qkv, w, bias, mask, heads, 0.125)
    tfs.fused_swin_attn_fwd.launches += 1        # as the wrapper counts
    assert out.shape == (b, n, c) and out.dtype == torch.bfloat16
    (args,) = lib.calls
    plan, proj = tfs.swin_plan(b, n, heads), tfs.proj_plan(b * n, c)
    assert args[:4] == (qkv.data_ptr(), w.data_ptr(), bias.data_ptr(),
                        None if mask is None else mask.data_ptr())
    assert args[4] != args[5] == out.data_ptr()  # o is a scratch
    assert list(args[6]) == [b, n, c, heads, n_w or 1, *plan.args(),
                             proj.bn, proj.stages, proj.smem_bytes]
    assert args[7:] == (0.125, tfs.PART_ATTN | tfs.PART_PROJ, 7)
    assert tfs.fused_swin_attn_fwd.launches == before + 1
    lib.calls.clear()
    o = tfs._launch_fwd(qkv, w, bias, mask, heads, 0.125, tfs.PART_ATTN)
    assert lib.calls[-1][4] == o.data_ptr() and lib.calls[-1][5] is None
    out = tfs._launch_fwd(qkv, w, bias, mask, heads, 0.125, tfs.PART_PROJ,
                          o)
    assert lib.calls[-1][4] == o.data_ptr()
    assert lib.calls[-1][5] == out.data_ptr()
    assert [a[8] for a in lib.calls] == [tfs.PART_ATTN, tfs.PART_PROJ]
    assert tfs.fused_swin_attn_fwd.launches == before + 1
    with pytest.raises(ValueError, match="o must be"):
        tfs._launch_fwd(qkv, w, bias, mask, heads, 0.125, tfs.PART_PROJ,
                        o[:, :1].contiguous())


class _BwdRecorder:
    """Stands for the loaded backward library: records the C entry's
    calls."""

    def __init__(self):
        self.calls = []

    def swin_attn_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("b, n, c, n_w", [(1024, 49, 96, 64),
                                          (16, 49, 768, 0), (64, 144, 128, 4),
                                          (4, 49, 32, 4)])
def test_backward_routes_through_one_call_of_three_launches(monkeypatch, b,
                                                             n, c, n_w):
    """The CUDA route with the C entry replaced by a recorder: one call
    queues the dO GEMM, the attention and the dW launches (`parts` = 7)
    with `swin_bwd_plan`'s, the GEMMs' and `dw_chunks`' ints, writing dqkv
    and dW through a dO / o_cat scratch, and counts one launch; the parts
    apart queue one launch each into the buffers they are given,
    uncounted."""
    from apla_tpu_torch.ops.apla_proj_gemm import gemm_plan
    from apla_tpu_torch.ops.fused_apla_attn import DW_GEMM, dw_chunks
    lib = _BwdRecorder()
    monkeypatch.setattr(tfs, "_bwd_library", lambda: lib)
    monkeypatch.setattr(tfs, "device_smem", lambda *a: 232448)
    monkeypatch.setattr(tfs, "device_index", lambda t: 0)
    monkeypatch.setattr(tfs, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tfs, "launch_context",
                        lambda t: contextlib.nullcontext(7))
    heads = c // 32
    qkv = torch.zeros((b, n, 3 * c), dtype=torch.bfloat16)
    w = torch.zeros((c, c), dtype=torch.bfloat16)
    g = torch.zeros((b, n, c), dtype=torch.bfloat16)
    bias = torch.zeros((heads, n, n))
    mask = torch.zeros((n_w, n, n)) if n_w else None
    before = tfs.fused_swin_attn_bwd.launches
    dqkv, dw, scratch, part = tfs._launch_bwd(qkv, w, g, bias, mask, heads,
                                              0.125)
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.bfloat16
    assert dw.shape == (c, c) and dw.dtype == torch.float32
    assert scratch.shape == (2, b, n, c)
    (args,) = lib.calls
    plan = tfs.swin_bwd_plan(b, n, heads)
    do_gemm, dw_gemm = tfs.proj_plan(b * n, c), gemm_plan(c, c, *DW_GEMM)
    rows, chunks = dw_chunks(b * n, c, c, 132, 64 if c % 64 == 0 else 32)
    assert part.shape == (chunks, c, c)
    assert args[:10] == (qkv.data_ptr(), w.data_ptr(), g.data_ptr(),
                         bias.data_ptr(),
                         None if mask is None else mask.data_ptr(),
                         dqkv.data_ptr(), dw.data_ptr(),
                         scratch[0].data_ptr(), scratch[1].data_ptr(),
                         part.data_ptr())
    assert list(args[10]) == [
        b, n, c, heads, n_w or 1, *plan.args(), do_gemm.bn, do_gemm.stages,
        do_gemm.smem_bytes, dw_gemm.bn, dw_gemm.stages, dw_gemm.smem_bytes,
        rows, chunks]
    assert args[11:] == (0.125, tfs.BWD_PARTS_ALL, 7)
    assert tfs.fused_swin_attn_bwd.launches == before
    lib.calls.clear()
    bufs = tfs._launch_bwd(qkv, w, g, bias, mask, heads, 0.125, tfs.BWD_DO)
    for part_bit in (tfs.BWD_ATTN, tfs.BWD_DW):
        assert tfs._launch_bwd(qkv, w, g, bias, mask, heads, 0.125, part_bit,
                               bufs) is bufs
    assert [a[12] for a in lib.calls] == [tfs.BWD_DO, tfs.BWD_ATTN,
                                          tfs.BWD_DW]
    assert len({a[5:10] for a in lib.calls}) == 1     # the same buffers
    assert tfs.fused_swin_attn_bwd.launches == before


def test_forward_cpu_path_never_builds(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU call tried to build the CUDA kernel")

    monkeypatch.setattr(tfs, "load_library", no_build)
    monkeypatch.setattr(cuda_build, "build_library", no_build)
    monkeypatch.setattr(cuda_build, "find_nvcc", no_build)
    x = _inputs(49, True, seed=2)
    out = tfs.fused_swin_attn_fwd(
        torch.tensor(x["qkv"]).bfloat16(), torch.tensor(x["w"]).bfloat16(),
        torch.tensor(x["bias"]), torch.tensor(x["mask"]), H, SCALE)
    assert out.shape == (6, 49, C)
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        tfs.fused_swin_attn_bwd_part(
            torch.tensor(x["qkv"]).bfloat16(), torch.tensor(x["w"]).bfloat16(),
            out, torch.tensor(x["bias"]), None, H, SCALE, tfs.BWD_ATTN)
    with pytest.raises(ValueError, match="runs on a CUDA tensor"):
        tfs.fused_swin_attn_fwd_part(
            torch.tensor(x["qkv"]).bfloat16(), torch.tensor(x["w"]).bfloat16(),
            torch.tensor(x["bias"]), None, H, SCALE, tfs.PART_ATTN)
