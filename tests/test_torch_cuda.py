"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

This file imports no jax, so it also runs on a machine that has only
PyTorch; there, skip tests/conftest.py (it sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Each kernel is held against its plain PyTorch version on the same bf16
tensors.  Bound: 2e-2 of the reference's largest magnitude, per output
(the two round p, o, dO, ds and the outputs to bf16 after f32 sums taken
in different orders; the prototype-CE kernels round ds to bf16 as their
plain versions do, and the backward is held at the collate's layout of g,
on every row of a tile and at ragged edges); 1e-2 for the projection GEMM
alone (exact products,
f32 sums in another order, one rounding: a bf16 ulp here and there).
Reruns of the kernels that sum partials are bit-equal.  The fused APLA
and Swin window forwards are each their two kernels bit for bit.  The
int8 GEMM takes bf16 or f32 and computes what its plain version does,
step for step (the same codes, exact int32 sums, the same f32 roundings,
the bias added after the rounding): equal, bit for bit.
"""

import dataclasses

import pytest
import torch

from apla_tpu_torch.ops import apla_proj_gemm as pg
from apla_tpu_torch.ops import fused_apla_attn as tfa
from apla_tpu_torch.ops import mha as tmha
from apla_tpu_torch.ops import proto_ce as tpc

REL_TOL = 2e-2
GEMM_REL_TOL = 1e-2


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided at run time, never at collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _qkv_w(device, b, n, c, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, n, 3 * c), generator=gen).to(device, torch.bfloat16)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(device,
                                                            torch.bfloat16)
    return qkv, w


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,seg,c", [
    (8, 257, 0, 768),     # ViT-B/14 at 224
    (2, 1370, 0, 768),    # ViT-B/14 at 518
    (8, 200, 50, 768),    # packed segments
    (2, 100, 64, 768),    # last segment cut by N
    (3, 17, 0, 768),      # N below one tile
    (1, 1, 0, 768),
    (2, 257, 0, 192),     # ViT-Ti: 3 heads, odd
    (4, 65, 13, 384),     # ViT-S
    (2, 300, 0, 1024),    # ViT-L
    (8, 1025, 0, 1024),   # ViT-L/16 at 512: the seg recipe's b8
])
def test_fused_apla_attn_matches_plain(cuda_device, b, n, seg, c):
    qkv, w = _qkv_w(cuda_device, b, n, c, seed=n + seg + c)
    heads = c // 64
    before = tfa.fused_apla_attn_fwd.launches
    out = tfa.fused_apla_attn_fwd(qkv, w, heads, 0.125, seg)
    torch.cuda.synchronize()
    assert tfa.fused_apla_attn_fwd.launches == before + 1
    ref = tfa.fused_apla_attn_fwd_reference(qkv, w, heads, 0.125, seg)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL * ref.float().abs().max().item()


@pytest.mark.cuda
def test_fused_apla_attn_raises_instead_of_falling_back(cuda_device):
    qkv, w = _qkv_w(cuda_device, 2, 17, 768, seed=0)
    before = tfa.fused_apla_attn_fwd.launches
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.fused_apla_attn_fwd(qkv.float(), w.float(), 12, 0.125)
    with pytest.raises(ValueError, match="head dim 64"):
        tfa.fused_apla_attn_fwd(qkv, w, 6, 0.125)
    assert tfa.fused_apla_attn_fwd.launches == before


def _bwd_errors(got, ref):
    (dqkv, dwt), (r_dqkv, r_dwt) = got, ref
    c = dqkv.shape[-1] // 3
    out = {}
    for name, a, r in (("dq", dqkv[..., :c], r_dqkv[..., :c]),
                       ("dk", dqkv[..., c:2 * c], r_dqkv[..., c:2 * c]),
                       ("dv", dqkv[..., 2 * c:], r_dqkv[..., 2 * c:]),
                       ("dW_t", dwt, r_dwt)):
        assert torch.isfinite(a).all(), name
        out[name] = ((a.float() - r.float()).abs().max().item(),
                     REL_TOL * r.float().abs().max().item())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,seg,c,k", [
    (8, 257, 0, 768, 128),    # the recipe's training micro-batch
    (8, 257, 0, 768, 8),      # the NABirds recipe's APLA-8: 8 live columns
    (64, 257, 0, 768, 128),   # a b64 step without accumulation
    (2, 1370, 0, 768, 128),   # ViT-B/14 at 518
    (8, 200, 50, 768, 128),   # packed segments
    (2, 100, 64, 768, 16),    # last segment cut by N; k below one tile
    (3, 17, 0, 768, 100),     # N below one tile; k padded to 128
    (1, 1, 0, 768, 768),      # full-width trainable projection
    (2, 257, 0, 192, 32),     # ViT-Ti: 3 heads
    (4, 65, 13, 384, 64),     # ViT-S
    (2, 300, 0, 1024, 128),   # ViT-L
    (8, 1025, 0, 1024, 1024),  # ViT-L/16 at 512, APLA "full" as k = C
    (1, 1025, 0, 1024, 1024),  # the same, one served image
    # the backward's launch plan (ops/mha.py bwd_plan): the other side's
    # tiles resident up to N = 320, streamed through a ring from 321
    (2, 320, 0, 768, 128),    # the longest resident N, five whole tiles
    (2, 321, 0, 768, 128),    # the first streamed
    (512, 50, 0, 768, 128),   # the SSL local crops: one ragged tile each
    (2, 769, 0, 768, 64),     # streamed, 13 tiles
])
def test_fused_apla_attn_bwd_matches_plain(cuda_device, b, n, seg, c, k):
    qkv, w = _qkv_w(cuda_device, b, n, c, seed=n + seg + c + k)
    gen = torch.Generator().manual_seed(k)
    g = torch.randn((b, n, c), generator=gen).to(cuda_device, torch.bfloat16)
    inds = torch.randperm(c, generator=gen)[:k].to(cuda_device)
    heads = c // 64
    before = tfa.fused_apla_attn_bwd.launches
    got = tfa.fused_apla_attn_bwd(qkv, w, g, inds, heads, 0.125, seg)
    torch.cuda.synchronize()
    assert tfa.fused_apla_attn_bwd.launches == before + 1
    assert got[0].shape == qkv.shape and got[0].dtype == torch.bfloat16
    assert got[1].shape == (c, k) and got[1].dtype == torch.float32
    ref = tfa.fused_apla_attn_bwd_reference(qkv, w, g, inds, heads, 0.125,
                                            seg)
    for name, (err, bound) in _bwd_errors(got, ref).items():
        assert err <= bound, (name, err, bound)


# (b, n): one variant of the backward's launch plan each: resident with
# one own tile a block (b8), resident with all five of a head's (b64), one
# tile (N = 50), streamed through the ring (N = 1370)
BWD_PLAN_VARIANTS = ((8, 257), (64, 257), (512, 50), (2, 1370))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", BWD_PLAN_VARIANTS)
def test_fused_apla_attn_bwd_is_deterministic(cuda_device, b, n):
    """No atomics, and dW_t sums per-chunk partials in a fixed order:
    reruns are equal, at every variant of the launch plan."""
    plan = tmha.bwd_plan(b, n, 12)
    assert plan.resident == (n <= 320)
    qkv, w = _qkv_w(cuda_device, b, n, 768, seed=1)
    g = torch.randn((b, n, 768), device=cuda_device).to(torch.bfloat16)
    inds = torch.arange(0, 768, 6, device=cuda_device)
    a = tfa.fused_apla_attn_bwd(qkv, w, g, inds, 12, 0.125)
    b_ = tfa.fused_apla_attn_bwd(qkv, w, g, inds, 12, 0.125)
    assert torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels(cuda_device):
    qkv, w = _qkv_w(cuda_device, 2, 257, 768, seed=2)
    qkv.requires_grad_()
    w_t = torch.randn((768, 128), device=cuda_device, requires_grad=True)
    b_t = torch.zeros(128, device=cuda_device, requires_grad=True)
    inds = torch.arange(128, device=cuda_device)
    fwd, bwd = tfa.fused_apla_attn_fwd.launches, tfa.fused_apla_attn_bwd.launches
    out = tfa.fused_apla_attention(qkv, w_t, b_t, w.float(),
                                   torch.zeros(768, device=cuda_device),
                                   inds, 12, 0.125)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert tfa.fused_apla_attn_fwd.launches == fwd + 1
    assert tfa.fused_apla_attn_bwd.launches == bwd + 1
    assert qkv.grad.dtype == torch.bfloat16 and w_t.grad.dtype == torch.float32
    assert torch.isfinite(w_t.grad).all() and torch.isfinite(b_t.grad).all()


@pytest.mark.cuda
def test_fused_apla_attn_smem_limit_names_the_width(cuda_device):
    """The forward no longer keeps o_cat [64, C] in shared memory (its two
    launches' shared memory does not grow with C), so C = 1280 (ViT-H, 20
    heads), which the single kernel refused for want of 257,024 bytes,
    runs and agrees with the plain version; what limits the width now is
    the head dim of 64, and a width the kernels cannot take raises naming
    it before any launch."""
    qkv, w = _qkv_w(cuda_device, 2, 65, 1280, seed=3)
    before = tfa.fused_apla_attn_fwd.launches
    out = tfa.fused_apla_attn_fwd(qkv, w, 20, 0.125)
    torch.cuda.synchronize()
    assert tfa.fused_apla_attn_fwd.launches == before + 1
    ref = tfa.fused_apla_attn_fwd_reference(qkv, w, 20, 0.125)
    assert (out.float() - ref.float()).abs().max() <= \
        REL_TOL * ref.float().abs().max()
    with pytest.raises(ValueError, match="head dim 64"):
        tfa.fused_apla_attn_fwd(qkv, w, 16, 0.125)
    assert tfa.fused_apla_attn_fwd.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [
    (257, 768), (8 * 257, 768), (64 * 257, 768),   # b1, b8, b64 at N = 257
    (2 * 1370, 768), (512 * 50, 768),              # the 518 crop, SSL crops
    (8 * 1025, 1024), (1025, 1024),                # the segmenter's b8, b1
    (1, 768), (131, 192), (300, 1280)])            # one row, ViT-Ti, ViT-H
def test_apla_proj_gemm_matches_plain(cuda_device, m, c):
    """The projection GEMM against its plain version (the same exact
    products summed in f32 in another order, one rounding: bound
    GEMM_REL_TOL of max|ref|, as chip_smoke.py phase 2); every plan the
    kernel has gives the same bits (one accumulator over all of K in
    increasing order)."""
    gen = torch.Generator().manual_seed(m + c)
    o = torch.randn((m, c), generator=gen).to(cuda_device, torch.bfloat16)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(cuda_device,
                                                           torch.bfloat16)
    before = pg.apla_proj_gemm.launches
    out = pg.apla_proj_gemm(o, w)
    torch.cuda.synchronize()
    assert pg.apla_proj_gemm.launches == before + 1
    ref = pg.apla_proj_gemm_reference(o, w)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max() <= \
        GEMM_REL_TOL * ref.float().abs().max()
    for bn, stages in ((128, 2), (128, 3), (128, 4), (256, 4)):
        plan = pg.gemm_plan(m, c, bn, stages)
        with torch.cuda.device(cuda_device):
            other = pg.launch(o, w, torch.cuda.current_stream().cuda_stream,
                              plan)
        torch.cuda.synchronize()
        assert torch.equal(other.view(torch.int16), out.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,seg,c", [(8, 257, 0, 768), (8, 200, 50, 768),
                                       (2, 1025, 0, 1024)])
def test_fused_apla_attn_is_its_two_kernels(cuda_device, b, n, seg, c):
    """The fused forward is the attention kernel, then the GEMM on its
    output, bit for bit; one call counts one fused launch and neither
    kernel's own wrapper."""
    qkv, w = _qkv_w(cuda_device, b, n, c, seed=n + c)
    heads = c // 64
    counts = (tmha.mha_fwd.launches, pg.apla_proj_gemm.launches)
    before = tfa.fused_apla_attn_fwd.launches
    out = tfa.fused_apla_attn_fwd(qkv, w, heads, 0.125, seg)
    torch.cuda.synchronize()
    assert tfa.fused_apla_attn_fwd.launches == before + 1
    assert (tmha.mha_fwd.launches, pg.apla_proj_gemm.launches) == counts
    two = pg.apla_proj_gemm(tmha.mha_fwd(qkv, heads, 0.125, seg), w)
    assert torch.equal(out.view(torch.int16), two.view(torch.int16))


@pytest.mark.cuda
def test_apla_proj_gemm_raises_instead_of_falling_back(cuda_device):
    o = torch.zeros((17, 768), device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros((768, 768), device=cuda_device, dtype=torch.bfloat16)
    before = pg.apla_proj_gemm.launches
    with pytest.raises(ValueError, match="bfloat16"):
        pg.apla_proj_gemm(o.float(), w.float())
    with pytest.raises(ValueError, match="w must be"):
        pg.apla_proj_gemm(o, w[:, :640])
    with pytest.raises(ValueError, match="o on"):
        pg.apla_proj_gemm(o, w.cpu())
    assert pg.apla_proj_gemm.launches == before


@pytest.mark.cuda
def test_seg_full_apla_runs_the_fused_kernels(cuda_device):
    """The SETR-PUP segmenter under APLA "full" with use_fused_apla: every
    block runs the forward kernel, and the backward too (every block's
    projection is trainable), at k = C; the logits agree with the plain
    attention path's."""
    from apla_tpu_torch.models import seg as tseg
    from apla_tpu_torch.models.vit import ViTConfig
    cfg = ViTConfig(img_size=64, patch_size=16, embed_dim=128, depth=3,
                    num_heads=2, use_fused_apla=True)
    model = tseg.init_segmenter(cfg, 7, channels=16, n_aux_heads=1,
                                aux_channels=8, device=cuda_device)
    x = torch.randn(2, 64, 64, 3, device=cuda_device)
    fwd, bwd = tfa.fused_apla_attn_fwd.launches, tfa.fused_apla_attn_bwd.launches
    main, aux = tseg.segmenter_forward_train(model, x, cfg)
    (main.sum() + aux[0].sum()).backward()
    torch.cuda.synchronize()
    assert tfa.fused_apla_attn_fwd.launches == fwd + 3
    assert tfa.fused_apla_attn_bwd.launches == bwd + 3
    assert all(torch.isfinite(b.attn.proj.kernel.grad).all()
               for b in model.backbone.blocks)
    with torch.no_grad():
        plain = tseg.segmenter_forward(model, x, dataclasses.replace(
            cfg, use_fused_apla=False))
    # bf16 through 3 blocks and the heads: the served-model bound of
    # chip_smoke (3e-2 of the largest logit)
    assert (main.detach() - plain).abs().max() <= 3e-2 * plain.abs().max()


@pytest.mark.cuda
def test_fused_apla_attn_bwd_raises_instead_of_falling_back(cuda_device):
    qkv, w = _qkv_w(cuda_device, 2, 17, 768, seed=0)
    g = torch.zeros((2, 17, 768), device=cuda_device, dtype=torch.bfloat16)
    inds = torch.arange(16, device=cuda_device)
    before = tfa.fused_apla_attn_bwd.launches
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.fused_apla_attn_bwd(qkv.float(), w.float(), g.float(), inds, 12,
                                0.125)
    with pytest.raises(ValueError, match="g must be"):
        tfa.fused_apla_attn_bwd(qkv, w, g[:, :16], inds, 12, 0.125)
    with pytest.raises(ValueError, match="inds"):
        tfa.fused_apla_attn_bwd(qkv, w, g, inds.cpu(), 12, 0.125)
    assert tfa.fused_apla_attn_bwd.launches == before


def _proto_inputs(device, r, k, seed):
    gen = torch.Generator().manual_seed(seed)

    def unit(shape, dim):
        x = torch.randn(shape, generator=gen)
        return (x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)).to(
            device, torch.bfloat16)

    return (unit((r, 256), -1), unit((256, k), 0), unit((r, 256), -1),
            unit((256, k), 0), (0.1 * torch.randn(k, generator=gen)).to(device),
            torch.rand(r, generator=gen).to(device))


def _proto_outputs(fns, args, tt):
    xs, ws, xt, wt, c, g = args
    ce, ls, lt = fns[0](xs, ws, xt, wt, c, tt, 0.1)
    b = (xs, ws, xt, wt, c, tt, 0.1, ls, lt, g)
    return ce, ls, lt, fns[1](*b), fns[2](*b)


_PROTO_KERNELS = (tpc.proto_ce_fwd, tpc.proto_ce_dxs, tpc.proto_ce_dws)
_PROTO_PLAIN = (tpc.proto_ce_fwd_reference, tpc.proto_ce_dxs_reference,
                tpc.proto_ce_dws_reference)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [
    (2048, 65536),    # an iBOT site (many row tiles, no K split)
    (128, 65536),     # the DINO global site (K split over blocks)
    (1024, 4096),     # dws with row chunks
    (1000, 1000),     # ragged R and K
    (70, 136),        # one row tile, ragged
    (1, 8),           # one row, one 16-byte column chunk
])
def test_proto_ce_kernels_match_plain(cuda_device, r, k):
    args = _proto_inputs(cuda_device, r, k, seed=r + k)
    before = [f.launches for f in _PROTO_KERNELS]
    for tt in (0.04, 0.07):
        got = _proto_outputs(_PROTO_KERNELS, args, tt)
        torch.cuda.synchronize()
        ref = _proto_outputs(_PROTO_PLAIN, args, tt)
        for name, a, b in zip(("ce", "lse_s", "lse_t", "dxs", "dws"), got,
                              ref):
            assert a.shape == b.shape and a.dtype == torch.float32, name
            assert torch.isfinite(a).all(), name
            err = (a - b).abs().max().item()
            assert err <= REL_TOL * b.abs().max().item(), (name, err)
    assert [f.launches for f in _PROTO_KERNELS] == [n + 2 for n in before]


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [(128, 65536), (1024, 4096), (2048, 8192)])
def test_proto_ce_kernels_are_deterministic(cuda_device, r, k):
    """Partials are merged in a fixed order, no atomics: reruns are
    equal."""
    args = _proto_inputs(cuda_device, r, k, seed=1)
    a = _proto_outputs(_PROTO_KERNELS, args, 0.05)
    b = _proto_outputs(_PROTO_KERNELS, args, 0.05)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _proto_bwd_check(args, tt=0.05):
    """dxs and dws of the kernels against the plain versions on the
    forward's lse; one counted launch per call."""
    xs, ws, xt, wt, c, g = args
    _, ls, lt = tpc.proto_ce_fwd(xs, ws, xt, wt, c, tt, 0.1)
    b = (xs, ws, xt, wt, c, tt, 0.1, ls, lt, g)
    before = (tpc.proto_ce_dxs.launches, tpc.proto_ce_dws.launches)
    got = (tpc.proto_ce_dxs(*b), tpc.proto_ce_dws(*b))
    torch.cuda.synchronize()
    assert (tpc.proto_ce_dxs.launches, tpc.proto_ce_dws.launches) == (
        before[0] + 1, before[1] + 1)
    ref = (tpc.proto_ce_dxs_reference(*b), tpc.proto_ce_dws_reference(*b))
    for name, a, r in zip(("dxs", "dws"), got, ref):
        assert torch.isfinite(a).all(), name
        err = (a - r).abs().max().item()
        assert err <= REL_TOL * r.abs().max().item(), (name, err)
    return got, b


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,live", [
    (16384, 8192, 4915),  # the iBOT buffer as the collate fills it
    (2048, 65536, 600),   # a tail inside a 32-row tile
    (1000, 1000, 64),     # the tail on a 64-row boundary, ragged K
])
def test_proto_ce_backward_at_the_collate_layout(cuda_device, r, k, live):
    """g = 0 past the first `live` rows: the dws kernel skips those row
    tiles, a dxs warpgroup whose 64 rows all have g = 0 writes zeros."""
    args = list(_proto_inputs(cuda_device, r, k, seed=r + live))
    args[5][live:] = 0
    (dxs, dws), b = _proto_bwd_check(args)
    assert not dxs[live:].any()
    again = (tpc.proto_ce_dxs(*b), tpc.proto_ce_dws(*b))
    assert torch.equal(again[0], dxs) and torch.equal(again[1], dws)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 64])
def test_proto_ce_backward_reads_every_row_of_a_tile(cuda_device, tile):
    """g non-zero only on the last row of each tile: a skip test that read
    only a tile's first row would drop every product."""
    args = list(_proto_inputs(cuda_device, 4096, 4096, seed=tile))
    keep = torch.zeros(4096, dtype=torch.bool, device=cuda_device)
    keep[tile - 1::tile] = True
    args[5] = torch.where(keep, args[5], torch.zeros_like(args[5]))
    (dxs, dws), _ = _proto_bwd_check(args)
    assert dws.abs().max() > 0
    assert (dxs.abs().amax(dim=1) > 0).eq(keep).all()


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [
    (33, 40),      # one row past a 32-row tile; K past one 32-column box
    (65, 1000),    # one row past a 64-row tile; K not a multiple of 32
    (97, 1032),
    (129, 8),      # K below one box
    (4097, 65536), # the iBOT width with one row past the last tile
])
def test_proto_ce_backward_at_ragged_edges(cuda_device, r, k):
    _proto_bwd_check(_proto_inputs(cuda_device, r, k, seed=r * k))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dxs", "dws"])
@pytest.mark.parametrize("groups", [1, 2])
def test_proto_ce_backward_block_shapes_agree(cuda_device, which, groups):
    """One and two consumer warpgroups a block give the same bits (the sum
    orders do not depend on the block's shape)."""
    args = _proto_inputs(cuda_device, 2048, 8192, seed=5)
    (dxs, dws), b = _proto_bwd_check(args)
    got = tpc.proto_ce_bwd_launch(which, *b, groups=groups)
    assert torch.equal(got, dxs if which == "dxs" else dws)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [
    (1000, 1000),     # ragged R and K, K split over blocks
    (4097, 8200),     # one row past a tile, K past a 64-wide unit
    (70, 136),        # one row tile
    (16385, 65528),   # the iBOT width, ragged, one split
])
def test_proto_ce_forward_is_deterministic(cuda_device, r, k):
    """No atomics: reruns of the forward are equal, at ragged edges too."""
    args = _proto_inputs(cuda_device, r, k, seed=r + 3 * k)[:5]
    a = tpc.proto_ce_fwd(*args, 0.04, 0.1)
    b = tpc.proto_ce_fwd(*args, 0.04, 0.1)
    for x, y in zip(a, b):
        assert torch.isfinite(x).all()
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [300, 16384])
def test_proto_ce_forward_reads_every_tile(cuda_device, r):
    """A spike planted in one column of ws moves lse_s of exactly the rows
    that see it, whichever 32-column tile holds the column: the rows with
    xs[:, 0] = 0 get the same s there, bit for bit, the others a logit of
    40 more.  K = 1000 ends in a tile of 8 columns; at R = 300 K is split
    over blocks (partials merged by the second launch), at 16384 not (two
    warpgroups a block, merged in the kernel)."""
    k = 1000
    xs, ws, xt, wt, c, _ = _proto_inputs(cuda_device, r, k, seed=r)
    seen = torch.arange(r, device=cuda_device) % 3 == 0
    xs = xs.float()
    xs[:, 0] = torch.where(seen, 0.5, 0.0)
    xs = xs.to(torch.bfloat16)
    _, base, _ = tpc.proto_ce_fwd(xs, ws, xt, wt, c, 0.05, 0.1)
    for tile in range(-(-k // 32)):
        col = min(32 * tile + (7 * tile) % 32, k - 1)
        spiked = ws.clone()
        spiked[0, col] += 8.0
        _, ls, _ = tpc.proto_ce_fwd(xs, spiked, xt, wt, c, 0.05, 0.1)
        moved = ls != base
        assert moved.eq(seen).all(), (tile, col)
        assert (ls[seen] - base[seen]).min() > 20.0, (tile, col)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [(2048, 8192), (1000, 1000)])
@pytest.mark.parametrize("groups", [1, 2])
def test_proto_ce_forward_block_shapes_agree(cuda_device, r, k, groups):
    """One and two consumer warpgroups a block give the same bits (the
    sum orders do not depend on the block's shape); the uncounted launch
    leaves the wrapper's count alone."""
    args = _proto_inputs(cuda_device, r, k, seed=11)[:5]
    ref = tpc.proto_ce_fwd(*args, 0.04, 0.1)
    before = tpc.proto_ce_fwd.launches
    got = tpc.proto_ce_fwd_launch(*args, 0.04, 0.1, groups=groups)
    assert tpc.proto_ce_fwd.launches == before
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_proto_ce_autograd_runs_the_kernels(cuda_device):
    xs, ws, xt, wt, c, g = _proto_inputs(cuda_device, 300, 2048, seed=2)
    xs, ws = xs.float().requires_grad_(), ws.float().requires_grad_()
    counts = [f.launches for f in _PROTO_KERNELS]
    ce = tpc.proto_ce(xs, ws, xt, wt, c, 0.04, 0.1)
    (ce * g).sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in _PROTO_KERNELS] == [n + 1 for n in counts]
    assert xs.grad.dtype == ws.grad.dtype == torch.float32
    assert torch.isfinite(xs.grad).all() and torch.isfinite(ws.grad).all()


@pytest.mark.cuda
def test_proto_ce_raises_instead_of_falling_back(cuda_device):
    xs, ws, xt, wt, c, g = _proto_inputs(cuda_device, 16, 64, seed=3)
    before = [f.launches for f in _PROTO_KERNELS]
    with pytest.raises(ValueError, match="bottleneck dim 256"):
        tpc.proto_ce_fwd(xs[:, :128], ws[:128], xt[:, :128], wt[:128], c,
                         0.04, 0.1)
    with pytest.raises(ValueError, match="multiple of 8"):
        tpc.proto_ce_fwd(xs, ws[:, :60], xt, wt[:, :60], c[:60], 0.04, 0.1)
    with pytest.raises(ValueError, match="xs on"):
        tpc.proto_ce_fwd(xs, ws, xt.cpu(), wt, c, 0.04, 0.1)
    assert [f.launches for f in _PROTO_KERNELS] == before


def _mha_inputs(device, b, n, c, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((b, n, 3 * c), generator=gen).to(device,
                                                        torch.bfloat16),
            torch.randn((b, n, c), generator=gen).to(device, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,seg,c", [
    (8, 257, 0, 768),     # the training micro-batch of ViT-B/14 at 224
    (64, 257, 0, 768),    # the served b64 call
    (512, 50, 0, 768),    # the SSL local crops
    (2, 1370, 0, 768),    # ViT-B/14 at 518: keys over 22 tiles
    (8, 200, 50, 768),    # packed segments
    (2, 100, 64, 768),    # last segment cut by N
    (3, 17, 0, 768),      # N below one tile
    (1, 1, 0, 768),
    (2, 257, 0, 192),     # ViT-Ti: 3 heads
    (4, 65, 13, 384),     # ViT-S
    # the forward's launch-plan boundaries (ops/mha.py fwd_plan)
    (2, 320, 0, 768),     # the row kernel's longest N, five whole key tiles
    (2, 321, 0, 768),     # the two-pass kernel's first, K/V resident
    (2, 768, 0, 768),     # its longest resident N, 12 whole key tiles
    (2, 769, 0, 768),     # its first streamed N
    (2, 128, 0, 768),     # an exact multiple of the key tile
    (2, 1370, 100, 768),  # streamed, with segments
    (8, 1025, 0, 1024),   # ViT-L/16 at 512: 16 heads, 17 tiles, streamed
])
def test_mha_kernels_match_plain(cuda_device, b, n, seg, c):
    qkv, d_o = _mha_inputs(cuda_device, b, n, c, seed=n + seg + c)
    heads = c // 64
    before = (tmha.mha_fwd.launches, tmha.mha_bwd.launches)
    out = tmha.mha_fwd(qkv, heads, 0.125, seg)
    dqkv = tmha.mha_bwd(qkv, d_o, heads, 0.125, seg)
    torch.cuda.synchronize()
    assert (tmha.mha_fwd.launches, tmha.mha_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = tmha.mha_fwd_reference(qkv, heads, 0.125, seg)
    r_dqkv = tmha.mha_bwd_reference(qkv, d_o, heads, 0.125, seg)
    assert out.shape == (b, n, c) and out.dtype == torch.bfloat16
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.bfloat16
    pairs = [("o", out, ref)] + [
        (name, dqkv[..., i * c:(i + 1) * c], r_dqkv[..., i * c:(i + 1) * c])
        for i, name in enumerate(("dq", "dk", "dv"))]
    for name, a, r in pairs:
        assert torch.isfinite(a).all(), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= REL_TOL * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_mha_kernels_are_deterministic(cuda_device):
    """No atomics: reruns give the same bits (the forward's TMA loads and
    wgmma products too, at each of its kernels: row, two-pass resident and
    streamed; the backward at each variant of its launch plan)."""
    qkv, d_o = _mha_inputs(cuda_device, 8, 257, 768, seed=1)
    assert torch.equal(tmha.mha_fwd(qkv, 12, 0.125),
                       tmha.mha_fwd(qkv, 12, 0.125))
    for n in (321, 1370):
        x = _mha_inputs(cuda_device, 2, n, 768, seed=n)[0]
        assert torch.equal(tmha.mha_fwd(x, 12, 0.125),
                           tmha.mha_fwd(x, 12, 0.125))
    # the backward at every variant of its launch plan
    for b, n in BWD_PLAN_VARIANTS:
        x, d = _mha_inputs(cuda_device, b, n, 768, seed=n)
        assert torch.equal(tmha.mha_bwd(x, d, 12, 0.125),
                           tmha.mha_bwd(x, d, 12, 0.125))


@pytest.mark.cuda
def test_mha_autograd_and_flash_mha_run_the_kernels(cuda_device):
    """The autograd Function and flash_mha ([B, N, H, Dh] q, k, v) launch
    both kernels once per call and agree with each other."""
    from apla_tpu_torch.ops.flash_attention import flash_mha
    qkv, d_o = _mha_inputs(cuda_device, 2, 257, 768, seed=2)
    qkv.requires_grad_()
    before = (tmha.mha_fwd.launches, tmha.mha_bwd.launches)
    out = tmha.mha(qkv, 12, 0.125)
    out.backward(d_o)
    q, k, v = (t.detach().reshape(2, 257, 12, 64).requires_grad_()
               for t in qkv.chunk(3, dim=-1))
    f_out = flash_mha(q, k, v, scale=0.125)
    f_out.backward(d_o.reshape(2, 257, 12, 64))
    torch.cuda.synchronize()
    assert (tmha.mha_fwd.launches, tmha.mha_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    assert qkv.grad.dtype == torch.bfloat16
    assert torch.equal(f_out.reshape(2, 257, 768), out)
    assert torch.equal(torch.cat([t.grad.reshape(2, 257, 768)
                                  for t in (q, k, v)], -1), qkv.grad)


@pytest.mark.cuda
def test_full_projection_vit_runs_the_kernels(cuda_device):
    """A 3-block bf16 ViT at APLA "full" with use_flash: every block's
    forward launches the forward kernel; the backward kernel runs in every
    block whose attention input needs a gradient (all but block 0)."""
    from apla_tpu_torch.apla.core import AplaConfig
    from apla_tpu_torch.models.classifier import (classifier_forward,
                                                  init_classifier)
    from apla_tpu_torch.models.vit import ViTConfig
    cfg = ViTConfig(img_size=56, patch_size=14, embed_dim=128, depth=3,
                    num_heads=2, use_flash=True, use_fused_apla=True)
    model = init_classifier(cfg, 10, AplaConfig(partial_size="full"),
                            generator=torch.Generator().manual_seed(0),
                            device=cuda_device)
    x = torch.randn((4, 56, 56, 3), device=cuda_device)
    before = (tmha.mha_fwd.launches, tmha.mha_bwd.launches)
    classifier_forward(model, x, cfg).float().sum().backward()
    torch.cuda.synchronize()
    assert (tmha.mha_fwd.launches, tmha.mha_bwd.launches) == \
        (before[0] + 3, before[1] + 2)
    for blk in model.backbone.blocks:
        assert torch.isfinite(blk.attn.proj.kernel.grad).all()


@pytest.mark.cuda
def test_mha_raises_instead_of_falling_back(cuda_device):
    qkv, d_o = _mha_inputs(cuda_device, 2, 17, 768, seed=0)
    before = (tmha.mha_fwd.launches, tmha.mha_bwd.launches)
    with pytest.raises(ValueError, match="bfloat16"):
        tmha.mha_fwd(qkv.float(), 12, 0.125)
    with pytest.raises(ValueError, match="head dim 64"):
        tmha.mha_fwd(qkv, 6, 0.125)
    with pytest.raises(ValueError, match="d_o must be"):
        tmha.mha_bwd(qkv, d_o[:, :16], 12, 0.125)
    with pytest.raises(ValueError, match="d_o on"):
        tmha.mha_bwd(qkv, d_o.cpu(), 12, 0.125)
    assert (tmha.mha_fwd.launches, tmha.mha_bwd.launches) == before


def _swin_inputs(device, b, n, c, n_w, seed):
    """bf16 qkv [b, n, 3c], w, g; f32 bias [c/32, n, n] and a random
    symmetric -1e9 mask of n_w planes (None when n_w is 0)."""
    gen = torch.Generator().manual_seed(seed)
    qkv, w = _qkv_w(device, b, n, c, seed)
    g = torch.randn((b, n, c), generator=gen).to(device, torch.bfloat16)
    bias = torch.randn((c // 32, n, n), generator=gen).to(device)
    mask = None
    if n_w:
        m = torch.rand((n_w, n, n), generator=gen) > 0.6
        m = m & m.transpose(1, 2) & ~torch.eye(n, dtype=torch.bool)[None]
        mask = torch.where(m, -1e9, 0.0).to(device)
    return qkv, w, g, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,n_w", [
    (1024, 49, 96, 64),    # Swin-T stage 0 at b16, shifted (3 heads)
    (1024, 49, 96, 0),     # ... unshifted: no mask
    (256, 49, 192, 16),    # stage 1
    (64, 49, 384, 4),      # stage 2
    (16, 49, 768, 0),      # stage 3: one window, no shift
    (10, 49, 96, 4),       # nW not dividing the windows
    (6, 9, 96, 2),         # a 3x3 window
    (3, 100, 64, 1),       # N past one 64-row tile
])
def test_fused_swin_attn_matches_plain(cuda_device, b, n, c, n_w):
    from apla_tpu_torch.ops import fused_swin_attn as tfs
    qkv, w, g, bias, mask = _swin_inputs(cuda_device, b, n, c, n_w,
                                         seed=b + n + c)
    heads, scale = c // 32, 32 ** -0.5
    before = (tfs.fused_swin_attn_fwd.launches,
              tfs.fused_swin_attn_bwd.launches)
    out = tfs.fused_swin_attn_fwd(qkv, w, bias, mask, heads, scale)
    dqkv, dw = tfs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads, scale)
    torch.cuda.synchronize()
    assert (tfs.fused_swin_attn_fwd.launches,
            tfs.fused_swin_attn_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = (tfs.fused_swin_attn_fwd_reference(qkv, w, bias, mask, heads,
                                             scale),
           *tfs.fused_swin_attn_bwd_reference(qkv, w, g, bias, mask, heads,
                                              scale))
    for name, a, r in zip(("out", "dqkv", "dW"), (out, dqkv, dw), ref):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= REL_TOL * r.float().abs().max().item(), (name, err)
    again = tfs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads, scale)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,n_w", [
    (1024, 49, 96, 64),    # Swin-T stage 0 at b16, shifted
    (256, 49, 192, 16),    # stage 1
    (64, 49, 384, 0),      # stage 2, unshifted
    (16, 49, 768, 0),      # stage 3
    (64, 49, 96, 64),      # b1 at stage 0: a served request
    (64, 64, 96, 4),       # N = 64: one full key tile
    (2, 400, 96, 2),       # N past one key tile: the two-pass kernel
    (4, 49, 32, 4),        # one head: C = 32, narrower than a GEMM box
])
def test_swin_fwd_is_its_two_launches(cuda_device, b, n, c, n_w):
    """The forward is one counted call of two launches: the attention into
    o (held against its plain version, `swin_attn_reference`), then the
    projection of o, whose output the call returns bit for bit; reruns
    are bit-equal."""
    from apla_tpu_torch.ops import fused_swin_attn as tfs
    qkv, w, _, bias, mask = _swin_inputs(cuda_device, b, n, c, n_w,
                                         seed=b + n + c + 1)
    heads, scale = c // 32, 32 ** -0.5
    before = tfs.fused_swin_attn_fwd.launches
    out = tfs.fused_swin_attn_fwd(qkv, w, bias, mask, heads, scale)
    torch.cuda.synchronize()
    assert tfs.fused_swin_attn_fwd.launches == before + 1
    o = tfs.fused_swin_attn_fwd_part(qkv, w, bias, mask, heads, scale,
                                     tfs.PART_ATTN)
    again = tfs.fused_swin_attn_fwd_part(qkv, w, bias, mask, heads, scale,
                                         tfs.PART_PROJ, o)
    torch.cuda.synchronize()
    assert tfs.fused_swin_attn_fwd.launches == before + 1
    assert torch.equal(again, out)
    o_ref = tfs.swin_attn_reference(qkv, bias, mask, heads, scale).float()
    assert torch.isfinite(o).all()
    err = (o.float() - o_ref).abs().max().item()
    assert err <= REL_TOL * o_ref.abs().max().item(), err
    ref = tfs.fused_swin_attn_fwd_reference(qkv, w, bias, mask, heads, scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL * ref.float().abs().max().item(), err
    assert torch.equal(tfs.fused_swin_attn_fwd(qkv, w, bias, mask, heads,
                                               scale), out)


_SWIN_BWD_CASES = [
    (1024, 49, 96, 64),    # Swin-T stage 0 at b16, shifted (3 heads)
    (1024, 49, 96, 0),     # ... unshifted: no mask
    (256, 49, 192, 16),    # stage 1
    (64, 49, 384, 4),      # stage 2
    (16, 49, 768, 0),      # stage 3: one window, no shift
    (10, 49, 96, 4),       # nW not dividing the windows
    (6, 9, 96, 2),         # a 3x3 window
    (3, 100, 64, 1),       # N past one 64-row tile: the tiles kernel
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,n_w", _SWIN_BWD_CASES)
def test_swin_bwd_reruns_bit_equal(cuda_device, b, n, c, n_w):
    """The backward sums without atomics (the dW partials in a fixed
    order), so three calls give the same bits."""
    from apla_tpu_torch.ops import fused_swin_attn as tfs
    qkv, w, g, bias, mask = _swin_inputs(cuda_device, b, n, c, n_w,
                                         seed=b + n + c + 2)
    heads, scale = c // 32, 32 ** -0.5
    first = tfs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads, scale)
    for _ in range(2):
        again = tfs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads, scale)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1].view(torch.int32),
                           first[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,n_w,win,head", [
    (64, 49, 96, 4, 37, 1),      # stage 0's width, the row kernel
    (16, 49, 768, 0, 5, 23),     # stage 3's 24 heads, the last one
    (4, 144, 128, 2, 2, 3),      # N = 144: the tiles kernel
])
def test_swin_bwd_keeps_items_apart(cuda_device, b, n, c, n_w, win, head):
    """A spike in one window's q at one head's columns changes dqkv only
    in that window's rows and that head's columns of its q, k and v
    thirds; dW changes (it sums every window)."""
    from apla_tpu_torch.ops import fused_swin_attn as tfs
    qkv, w, g, bias, mask = _swin_inputs(cuda_device, b, n, c, n_w,
                                         seed=b + n + c + 3)
    heads, scale = c // 32, 32 ** -0.5
    base = tfs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads, scale)
    spiked = qkv.clone()
    spiked[win, :, head * 32:(head + 1) * 32] *= 4
    got = tfs.fused_swin_attn_bwd(spiked, w, g, bias, mask, heads, scale)
    changed = got[0] != base[0]
    cols = torch.zeros(3 * c, dtype=torch.bool, device=cuda_device)
    for third in range(3):
        cols[third * c + head * 32:third * c + (head + 1) * 32] = True
    inside = torch.zeros_like(changed)
    inside[win][:, cols] = True
    assert not changed[~inside].any()
    assert changed[win][:, cols].any()
    for third in range(3):
        lo = third * c + head * 32
        assert changed[win, :, lo:lo + 32].any(), third
    assert not torch.equal(got[1], base[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,n_w", [(1024, 49, 96, 64), (16, 49, 768, 0),
                                       (4, 144, 128, 2), (4, 49, 32, 4)])
def test_swin_bwd_is_its_three_launches(cuda_device, b, n, c, n_w):
    """`fused_swin_attn_bwd_part`'s three launches run in turn on one set
    of buffers (the dO GEMM, the attention, the dW partials and their
    sum) give the whole call's dqkv and dW bit for bit, uncounted."""
    from apla_tpu_torch.ops import fused_swin_attn as tfs
    qkv, w, g, bias, mask = _swin_inputs(cuda_device, b, n, c, n_w,
                                         seed=b + n + c + 4)
    heads, scale = c // 32, 32 ** -0.5
    whole = tfs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads, scale)
    before = tfs.fused_swin_attn_bwd.launches
    bufs = None
    for bit in (tfs.BWD_DO, tfs.BWD_ATTN, tfs.BWD_DW):
        bufs = tfs.fused_swin_attn_bwd_part(qkv, w, g, bias, mask, heads,
                                            scale, bit, bufs)
    torch.cuda.synchronize()
    assert tfs.fused_swin_attn_bwd.launches == before
    assert torch.equal(bufs[0], whole[0])
    assert torch.equal(bufs[1].view(torch.int32), whole[1].view(torch.int32))


@pytest.mark.cuda
def test_swin_detector_runs_the_window_kernels(cuda_device):
    """A bf16 two-stage Swin detector with use_fused_apla: 4 window
    forwards per pass and 4 backwards per step, block 0 included (its
    projection is trainable though its qkv input is frozen)."""
    from apla_tpu_torch.models.detection import (detection_optimizer,
                                                 init_detector,
                                                 make_detection_train_step)
    from apla_tpu_torch.models.swin import SwinConfig
    from apla_tpu_torch.ops import fused_swin_attn as tfs
    cfg = SwinConfig(img_size=56, embed_dim=32, depths=(2, 2),
                     num_heads=(1, 2), use_fused_apla=True)
    model = init_detector(cfg, 3, torch.Generator().manual_seed(0),
                          cuda_device)
    step = make_detection_train_step(cfg, detection_optimizer(model, 1e-4,
                                                              1e-4))
    batch = {"image": torch.randn((2, 56, 56, 3), device=cuda_device),
             "boxes": torch.tensor([[[4.0, 4.0, 30.0, 30.0]]] * 2,
                                   device=cuda_device),
             "labels": torch.ones((2, 1), dtype=torch.int32,
                                  device=cuda_device)}
    before = (tfs.fused_swin_attn_fwd.launches,
              tfs.fused_swin_attn_bwd.launches)
    m = step(model, batch)
    torch.cuda.synchronize()
    assert (tfs.fused_swin_attn_fwd.launches,
            tfs.fused_swin_attn_bwd.launches) == (before[0] + 4,
                                                  before[1] + 4)
    assert torch.isfinite(m["total"]) and torch.isfinite(m["grad_norm"])


@pytest.mark.cuda
def test_fused_swin_attn_raises_instead_of_falling_back(cuda_device):
    from apla_tpu_torch.ops import fused_swin_attn as tfs
    qkv, w, g, bias, mask = _swin_inputs(cuda_device, 8, 49, 96, 4, seed=0)
    before = (tfs.fused_swin_attn_fwd.launches,
              tfs.fused_swin_attn_bwd.launches)
    with pytest.raises(ValueError, match="bfloat16"):
        tfs.fused_swin_attn_fwd(qkv.float(), w.float(), bias, mask, 3, 0.1)
    with pytest.raises(ValueError, match="head dim 32"):
        tfs.fused_swin_attn_fwd(qkv, w, bias[:2], mask, 2, 0.1)
    with pytest.raises(ValueError, match="mask must be"):
        tfs.fused_swin_attn_fwd(qkv, w, bias, mask.double(), 3, 0.1)
    with pytest.raises(ValueError, match="g must be"):
        tfs.fused_swin_attn_bwd(qkv, w, g[:, :48], bias, mask, 3, 0.1)
    with pytest.raises(ValueError, match="needs o"):
        tfs.fused_swin_attn_fwd_part(qkv, w, bias, mask, 3, 0.1,
                                     tfs.PART_PROJ)
    # a window past the tiles the backward keeps resident
    big = torch.zeros((1, 800, 96), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="at most 12 fit"):
        tfs.fused_swin_attn_bwd(
            big, w[:32, :32].contiguous(), big[..., :32].contiguous(),
            torch.zeros((1, 800, 800), device=cuda_device), None, 1, 0.1)
    assert (tfs.fused_swin_attn_fwd.launches,
            tfs.fused_swin_attn_bwd.launches) == before


# ------------------------------------------------------------------ #
# the int8 GEMM (W8A8 serving)
# ------------------------------------------------------------------ #

def _int8_operands(device, m, k, n, dtype, seed):
    from apla_tpu_torch.ops.quant import QuantizedKernel, quantize_weight
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=gen).to(device, dtype)
    w = torch.randn((k, n), generator=gen) * k ** -0.5
    return x, QuantizedKernel(*quantize_weight(w)).to(device)


def _int8_bias(device, n, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((n,), generator=gen) * 0.5).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group,dtype", [
    (16448, 768, 2304, 768, torch.bfloat16),     # ViT-B qkv at b64
    (257, 768, 3072, 768, torch.bfloat16),       # ViT-B fc1 at b1
    (257, 3072, 768, 3072, torch.bfloat16),      # ViT-B fc2 at b1
    (2050, 4096, 1024, 4096, torch.bfloat16),    # ViT-L fc2 at b2
    (3136, 96, 288, 96, torch.float32),          # Swin-T stage-0 qkv
    (49, 3072, 768, 3072, torch.float32),        # Swin-T stage-3 fc2
    (1000, 3072, 768, 256, torch.bfloat16),      # row 13's own groups
    (1, 64, 8, 32, torch.float32),
])
def test_int8_matmul_matches_plain(cuda_device, m, k, n, group, dtype):
    """The kernel against its plain version on the same tensors: the same
    codes, the exact int32 sums and the same f32 roundings, so equal bit
    for bit."""
    from apla_tpu_torch.ops import int8_matmul as tim
    x, qk = _int8_operands(cuda_device, m, k, n, dtype, seed=m + k + n)
    before = tim.fused_int8_matmul.launches
    y = tim.fused_int8_matmul(x, qk.w_int8, qk.scale, group, qk.w_kmajor)
    torch.cuda.synchronize()
    assert tim.fused_int8_matmul.launches == before + 1
    ref = tim.fused_int8_matmul_reference(x, qk.w_int8, qk.scale, group)
    assert y.shape == (m, n) and y.dtype == dtype
    assert torch.equal(y, ref), (y.float() - ref.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group,dtype,bias_dtype", [
    (16448, 768, 3072, 768, torch.bfloat16, torch.float32),  # fc1 b64
    (16443, 768, 3072, 768, torch.bfloat16, torch.bfloat16),  # ragged M
    (4099, 96, 288, 96, torch.float32, torch.float32),  # K = 96, N = 288
    (1000, 768, 264, 768, torch.bfloat16, torch.float32),  # N % 128 = 8
    (2053, 3072, 768, 256, torch.bfloat16, torch.float32),  # groups of 256
    (333, 3072, 200, 256, torch.float32, torch.bfloat16),
    (1, 64, 8, 32, torch.bfloat16, torch.float32),
])
def test_int8_matmul_with_bias_matches_plain(cuda_device, m, k, n, group,
                                             dtype, bias_dtype):
    """The bias added in the kernel's epilogue (after the rounding to x's
    dtype, then rounded again) equals the plain version's `y + bias.to(
    y.dtype)` bit for bit, at ragged M, N not a multiple of the tile width,
    K = 96 and groups of 256; without the bias, the same call's y."""
    from apla_tpu_torch.ops import int8_matmul as tim
    x, qk = _int8_operands(cuda_device, m, k, n, dtype, seed=m + n)
    b = _int8_bias(cuda_device, n, bias_dtype, seed=n)
    args = (x, qk.w_int8, qk.scale, group, qk.w_kmajor)
    before = tim.fused_int8_matmul.launches
    y = tim.fused_int8_matmul(*args, bias=b)
    y0 = tim.fused_int8_matmul(*args)
    torch.cuda.synchronize()
    assert tim.fused_int8_matmul.launches == before + 2
    ref = tim.fused_int8_matmul_reference(*args[:4], bias=b)
    assert y.shape == (m, n) and y.dtype == dtype
    assert torch.equal(y, ref), (y.float() - ref.float()).abs().max().item()
    assert torch.equal(y, y0 + b.to(dtype))


@pytest.mark.cuda
def test_int8_matmul_raises_instead_of_falling_back(cuda_device):
    from apla_tpu_torch.ops import int8_matmul as tim
    x, qk = _int8_operands(cuda_device, 64, 96, 40, torch.bfloat16, seed=0)
    before = tim.fused_int8_matmul.launches
    with pytest.raises(ValueError, match="K-major"):
        tim.fused_int8_matmul(x, qk.w_int8, qk.scale, 96)
    with pytest.raises(ValueError, match="multiples of 32"):
        tim.fused_int8_matmul(x[:, :80], qk.w_int8[:80], qk.scale, 80,
                              qk.w_kmajor[:, :80].contiguous())
    with pytest.raises(ValueError, match="multiples of 32"):
        tim.fused_int8_matmul(x, qk.w_int8, qk.scale, 48, qk.w_kmajor)
    with pytest.raises(ValueError, match="contiguous"):
        tim.fused_int8_matmul(x.t().contiguous().t(), qk.w_int8, qk.scale,
                              96, qk.w_kmajor)
    with pytest.raises(ValueError, match="bias on cpu"):
        tim.fused_int8_matmul(x, qk.w_int8, qk.scale, 96, qk.w_kmajor,
                              bias=torch.zeros(40))
    with pytest.raises(ValueError, match="bias must be"):
        tim.fused_int8_matmul(x, qk.w_int8, qk.scale, 96, qk.w_kmajor,
                              bias=torch.zeros(48, device=cuda_device))
    with pytest.raises(ValueError, match="bias must be"):
        tim.fused_int8_matmul(x, qk.w_int8, qk.scale, 96, qk.w_kmajor,
                              bias=torch.zeros(40, dtype=torch.float16,
                                               device=cuda_device))
    assert tim.fused_int8_matmul.launches == before


@pytest.mark.cuda
def test_w8a8_serving_runs_the_int8_kernel(cuda_device, tmp_path):
    """A quantized classifier artifact served on the card launches the int8
    kernel in each qkv, fc1 and fc2 of every block of every call, and
    serves what the in-process quantized module computes."""
    from apla_tpu_torch import serve
    from apla_tpu_torch.apla.core import AplaConfig
    from apla_tpu_torch.models.classifier import (classifier_forward,
                                                  init_classifier)
    from apla_tpu_torch.models.vit import ViTConfig
    from apla_tpu_torch.ops import int8_matmul as tim
    from apla_tpu_torch.ops.quant import quantize_frozen_backbone
    cfg = ViTConfig(img_size=56, patch_size=14, embed_dim=128, depth=2,
                    num_heads=2, use_fused_apla=True)
    model = init_classifier(cfg, 10, AplaConfig(partial_size=16),
                            generator=torch.Generator().manual_seed(0),
                            device=cuda_device)
    serve.export_classifier(str(tmp_path), model, cfg, batch_sizes=(1, 4),
                            quantize_frozen=True)
    pred = serve.load_predictor(str(tmp_path), cuda_device)
    x = torch.randn((5, 56, 56, 3)).numpy()
    before = (tim.fused_int8_matmul.launches,
              tfa.fused_apla_attn_fwd.launches)
    got = pred.predict(x)
    torch.cuda.synchronize()
    assert (tim.fused_int8_matmul.launches,
            tfa.fused_apla_attn_fwd.launches) == (before[0] + 3 * 2 * 2,
                                                  before[1] + 2 * 2)
    with torch.inference_mode():
        ref = classifier_forward(quantize_frozen_backbone(model),
                                 torch.from_numpy(x[:4]).to(cuda_device),
                                 cfg)
    assert torch.equal(torch.from_numpy(got[:4]), ref.float().cpu())
