"""The port's APLA projection GEMM (`apla_tpu_torch.ops.apla_proj_gemm`) and
the fused forward's two-launch route on the CPU.

On the card the fused APLA attention forward is the attention kernel
(`csrc/mha_fwd.cu`) into a scratch o, then `csrc/apla_proj_gemm.cu` over
the B * N rows.  Here:

- the GEMM's plain version against the projection inside the JAX kernel
  (`apla_tpu/ops/pallas_apla_attn.py:124-129`: the f32 `dot_general` of
  `o_cat` and `w`, rounded to the input dtype) at ragged row counts.
  Tolerance: both sum exact products of bf16 values in f32 and round once
  to bf16; only the order of the f32 sums differs, so an output may differ
  by one bf16 ulp (2^-8 relative) where a sum sits near a rounding
  boundary: rtol = 2^-7, atol = 2^-7 of the largest |output|.  In f32
  (no rounding of the output) rtol = atol = 1e-5.
- the composite plain path (`mha_fwd_reference`, then the GEMM's plain
  version over the flattened rows) equal bit for bit to
  `fused_apla_attn_fwd_reference`, with and without segments, at odd N.
- the GEMM's launch plan as a pure function, its argument checks, and the
  fused wrapper's routing with the C entries replaced by recorders.

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py (skipped without a card) and by chip_smoke.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu_torch.ops import apla_proj_gemm as pg
from apla_tpu_torch.ops import cuda_build
from apla_tpu_torch.ops import fused_apla_attn as tfa
from apla_tpu_torch.ops import mha as tmha


def _bf16(x):
    """numpy f32 values that bf16 holds exactly."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _jax_projection(o, w, dtype):
    """`pallas_apla_attn.py:_fwd_kernel`'s projection, on [M, C]."""
    proj = jax.lax.dot_general(
        jnp.asarray(o, dtype), jnp.asarray(w, dtype), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return np.asarray(proj.astype(dtype).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,c", [(3 * 257, 128), (131, 192), (1, 64),
                                 (8 * 41, 256)])
def test_plain_gemm_matches_jax_projection(m, c, dtype):
    rng = np.random.default_rng(m + c)
    o = _bf16(rng.standard_normal((m, c)).astype(np.float32))
    w = _bf16((rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32))
    ref = _jax_projection(o, w, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    got = pg.apla_proj_gemm(torch.from_numpy(o).to(tdt),
                            torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (m, c)
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,seg", [(2, 17, 0), (3, 41, 0), (2, 41, 10),
                                     (1, 65, 13)])
def test_composite_plain_path_is_the_fused_reference(b, n, seg, dtype):
    """The two launches' plain versions, one after the other, give the
    fused forward's plain version bit for bit (the CPU path of the
    wrapper, too)."""
    c, heads = 128, 2
    gen = torch.Generator().manual_seed(n + seg)
    qkv = torch.randn((b, n, 3 * c), generator=gen).to(dtype)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(dtype)
    o = tmha.mha_fwd_reference(qkv, heads, 0.125, seg)
    two = pg.apla_proj_gemm(o.reshape(b * n, c), w).reshape(b, n, c)
    ref = tfa.fused_apla_attn_fwd_reference(qkv, w, heads, 0.125, seg)
    assert torch.equal(two, ref)
    assert torch.equal(tfa.fused_apla_attn_fwd(qkv, w, heads, 0.125, seg),
                       ref)


# ---- the launch plan (ops/apla_proj_gemm.py gemm_plan) --------------------
# The shapes the port's paths give the GEMM: b64 at N = 257 (served and
# trained), b8 at N = 1025 with C = 1024 (the segmenter), b2 at N = 1370
# (the 518 crop), the 512 local crops of N = 50, and small ones.


@pytest.mark.parametrize("m,c,tiles,bn", [
    (64 * 257, 768, (129, 3), 256), (8 * 1025, 1024, (65, 4), 256),
    (2 * 1370, 768, (22, 6), 128), (512 * 50, 768, (200, 3), 256),
    (257, 768, (3, 6), 128), (1, 768, (1, 6), 128), (131, 192, (2, 2), 128),
    (300, 1280, (3, 10), 128)])
def test_gemm_plan_at_the_path_shapes(m, c, tiles, bn):
    """Wide tiles (one block an SM) where they fill the SMs at least once,
    else 128 x 128 (two an SM)."""
    plan = pg.gemm_plan(m, c)
    assert (plan.rows, plan.width, plan.bn) == (m, c, bn)
    assert plan.stages == (4 if bn == 256 else 3)
    assert plan.blocks_per_sm == (1 if bn == 256 else 2)
    assert (plan.row_tiles, plan.col_tiles) == tiles
    assert plan.blocks == tiles[0] * tiles[1]
    # every row and column is covered, and no tile lies wholly outside
    assert plan.row_tiles * pg.BM >= m > (plan.row_tiles - 1) * pg.BM
    assert plan.col_tiles * plan.bn >= c > (plan.col_tiles - 1) * plan.bn
    assert plan.smem_bytes == pg.smem_bytes(plan.bn, plan.stages)
    assert plan.smem_bytes <= 232448
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233472
    assert plan.stages >= plan.bn // 64


@pytest.mark.parametrize("bn,stages", [(128, 2), (128, 3), (128, 4),
                                       (128, 6), (256, 4)])
def test_gemm_plan_configurations(bn, stages):
    """Every instantiation with enough stages fits a block; the epilogue's
    bn / 64 boxes fit in the ring."""
    plan = pg.gemm_plan(8200, 1024, bn, stages)
    assert (plan.bn, plan.stages) == (bn, stages)
    assert plan.smem_bytes == 1280 + stages * (16384 + bn * 128)
    assert plan.smem_bytes <= 232448
    assert plan.blocks_per_sm == min(pg.REG_BLOCKS[bn],
                                     233472 // (plan.smem_bytes + 1024))


@pytest.mark.parametrize("bn,stages", [(64, 3), (256, 3), (256, 5),
                                       (192, 3)])
def test_gemm_plan_refuses(bn, stages):
    with pytest.raises(ValueError):
        pg.gemm_plan(8200, 1024, bn, stages)


@pytest.mark.parametrize("case,match", [
    ("f32", "bfloat16"), ("w_shape", "w must be"), ("width", "multiple of 64"),
    ("strided", "contiguous")])
def test_gemm_argument_checks(case, match):
    bf = torch.bfloat16
    o, w = torch.zeros(17, 128, dtype=bf), torch.zeros(128, 128, dtype=bf)
    if case == "f32":
        o = o.float()
    elif case == "w_shape":
        # w [K, N] must meet o's K (a rectangular w of o's K is the
        # tensor-parallel share: tests/test_torch_tensor_parallel.py)
        w = torch.zeros(64, 128, dtype=bf)
    elif case == "width":
        o, w = torch.zeros(17, 96, dtype=bf), torch.zeros(96, 96, dtype=bf)
    elif case == "strided":
        o = torch.zeros(128, 17, dtype=bf).t()
    with pytest.raises(ValueError, match=match):
        pg.check_args(o, w)


def test_gemm_cpu_path_never_builds(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU call tried to build the CUDA kernel")

    monkeypatch.setattr(pg, "load_library", no_build)
    monkeypatch.setattr(cuda_build, "build_library", no_build)
    monkeypatch.setattr(cuda_build, "find_nvcc", no_build)
    before = pg.apla_proj_gemm.launches
    out = pg.apla_proj_gemm(torch.randn(5, 64).to(torch.bfloat16),
                            torch.randn(64, 64).to(torch.bfloat16))
    assert out.shape == (5, 64) and pg.apla_proj_gemm.launches == before
    with pytest.raises(ValueError, match="no projection GEMM"):
        pg.apla_proj_gemm(torch.empty(5, 64, device="meta"),
                          torch.empty(64, 64, device="meta"))


class _Recorder:
    """Stands for a loaded library: records each C entry's calls."""

    def __init__(self, *names):
        self.calls = {name: [] for name in names}
        for name in names:
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def call(*args):
            self.calls[name].append(args)
            return 0
        return call


@pytest.mark.parametrize("b,n,c,seg", [(2, 257, 768, 0), (8, 1025, 1024, 0),
                                       (8, 200, 768, 50)])
def test_fused_forward_routes_through_both_kernels(monkeypatch, b, n, c,
                                                   seg):
    """The CUDA route of the fused forward, with the C entries replaced by
    recorders: one call launches the attention kernel with
    `mha.fwd_plan`'s plan and the GEMM with `gemm_plan`'s over the B * N
    rows of the attention's output, once each; it counts one fused launch
    and leaves `mha_fwd.launches` and `apla_proj_gemm.launches` alone."""
    heads = c // 64
    mlib = _Recorder("mha_fwd")
    glib = _Recorder("apla_proj_gemm")
    for module, lib in ((tmha, mlib), (pg, glib)):
        monkeypatch.setattr(module, "device_smem", lambda *a: 232448)
        monkeypatch.setattr(module, "_fwd_library" if module is tmha
                            else "_library", lambda lib=lib: lib)
    monkeypatch.setattr(tfa, "launch_context",
                        lambda t: contextlib.nullcontext(7))
    qkv = torch.zeros((b, n, 3 * c), dtype=torch.bfloat16)
    w = torch.zeros((c, c), dtype=torch.bfloat16)
    before = (tfa.fused_apla_attn_fwd.launches, tmha.mha_fwd.launches,
              pg.apla_proj_gemm.launches)
    out = tfa._launch(qkv, w, heads, 0.125, seg)
    assert out.shape == (b, n, c) and out.dtype == torch.bfloat16
    assert len(mlib.calls["mha_fwd"]) == 1
    assert len(glib.calls["apla_proj_gemm"]) == 1
    (m_args,), (g_args,) = mlib.calls["mha_fwd"], glib.calls["apla_proj_gemm"]
    plan = tmha.fwd_plan(b, n, heads, seg)
    assert m_args[0] == qkv.data_ptr()
    assert m_args[2:8] == (b, n, c, heads, 0.125, seg)
    assert m_args[8:15] == (int(plan.kind == "two_pass"), plan.q_tiles,
                            plan.items_per_block, plan.kv_sets, plan.slots,
                            int(plan.resident), plan.smem_bytes)
    g_plan = pg.gemm_plan(b * n, c)
    # the GEMM reads the attention's output and writes the call's result
    assert g_args[0] == m_args[1] and g_args[1] == w.data_ptr()
    assert g_args[2] == out.data_ptr() != m_args[1]
    # M, K (the heads' width), N (the projection's), the plan, and bf16
    # out (a tensor-parallel rank's call asks for its f32 partial)
    assert g_args[3:10] == (b * n, c, c, g_plan.bn, g_plan.stages,
                            g_plan.smem_bytes, 0)
    assert m_args[-1] == g_args[-1] == 7          # the current stream
    assert (tfa.fused_apla_attn_fwd.launches, tmha.mha_fwd.launches,
            pg.apla_proj_gemm.launches) == (before[0] + 1, *before[1:])
