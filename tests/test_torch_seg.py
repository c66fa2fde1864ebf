"""The port's SETR-PUP segmenter (`apla_tpu_torch.models.seg`) against the
JAX package's (`apla_tpu/models/seg.py`).

The same inputs, drawn with numpy, and the same weights (the JAX trees,
perturbed so that no leaf is trivially zero, carried over by
`utils.pretrained.seg_state_from_jax`) go through both: the PUP head, the
bilinear resizes (`jax.image.resize` against `F.interpolate`, up x2, x4
(the aux heads' 128 -> 512 included) and by other factors, and reductions),
the loss (an all-ignore batch included), the IoU counts, the sliding-window
geometry and forward, the segmenter with 3 aux heads, and a 3-step
trajectory of `make_seg_train_step` with `head_lr_mult` 10 on the plain
and the fused attention path.  The JAX package's own cases
(tests/test_seg.py) run on the port too.

Tolerances: float32 rtol = atol = 1e-4 (only the order of f32 sums
differs); bfloat16 2e-2 of the largest magnitude.  Host-side counts are
integers and agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.models import seg as jseg
from apla_tpu.models.vit import ViTConfig as JViTConfig
from apla_tpu_torch.apla.core import AplaConfig
from apla_tpu_torch.models import seg as tseg
from apla_tpu_torch.models.vit import ViTConfig
from apla_tpu_torch.serve import segmenter_from_state
from apla_tpu_torch.utils.pretrained import seg_state_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
N_CLASSES = 5
# 4 blocks: the 3 aux heads read blocks 1, 2, 3
KW = dict(img_size=64, patch_size=16, embed_dim=64, depth=4, num_heads=4)
SMALL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(fused=False, **kw):
    kw = kw or KW
    return (JViTConfig(compute_dtype=jnp.float32, **kw),
            ViTConfig(compute_dtype=torch.float32, use_fused_apla=fused,
                      **kw))


def _jax_segmenter(jcfg, seed=0, n_aux=3, apla_cfg=None, channels=16,
                   aux_channels=8):
    """The JAX trees as numpy, every float leaf perturbed (the init's
    zero biases would hide a swapped leaf)."""
    t, f = jseg.init_segmenter(jax.random.PRNGKey(seed), jcfg, N_CLASSES,
                               apla_cfg=apla_cfg, channels=channels,
                               n_aux_heads=n_aux, aux_channels=aux_channels)
    rng = np.random.default_rng(seed)

    def perturb(scale):
        def fn(a):
            a = np.asarray(a)
            if a.dtype.kind != "f":
                return a
            return a + (rng.standard_normal(a.shape) * scale).astype(a.dtype)
        return fn

    return jax.tree.map(perturb(0.05), t), jax.tree.map(perturb(0.02), f)


def _port(tcfg, t, f):
    ts, fs = seg_state_from_jax(t, f)
    return segmenter_from_state(tcfg, ts, fs, torch.device("cpu"))


def _images(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), **tol)


def test_state_bridge_names_every_parameter():
    jcfg, tcfg = _cfgs()
    t, f = _jax_segmenter(jcfg)
    ts, fs = seg_state_from_jax(t, f)
    model = tseg.init_segmenter(tcfg, N_CLASSES, channels=16, n_aux_heads=3,
                                aux_channels=8)
    assert set(ts) | set(fs) == set(model.state_dict())
    assert set(ts) == {n for n, p in model.named_parameters()
                       if p.requires_grad}
    # "full": the JAX projection trains in place, held once; the block's
    # columns 0..C-1 are a buffer no state carries
    np.testing.assert_array_equal(
        ts["backbone.blocks.2.attn.proj.kernel"].numpy(),
        t["backbone"]["blocks"]["attn"]["proj"]["kernel"][2])
    assert not any("proj_wt" in n or "attn.inds" in n for n in {**ts, **fs})
    assert torch.equal(model.backbone.blocks[2].attn.inds, torch.arange(64))
    assert ts["head.convs.0.kernel"].shape == (3, 3, 64, 16)
    assert ts["aux_heads.2.cls.kernel"].shape == (1, 1, 8, N_CLASSES)


@pytest.mark.parametrize("hw,out", [
    ((4, 4), (64, 64)),        # the main head: 4 x2 stages reach it
    ((4, 4), (48, 40)),        # a reduction after the stages
    ((3, 5), (100, 70)),       # upsampled by other factors
])
def test_pup_head_forward_matches_jax(hw, out):
    jcfg, _ = _cfgs()
    t, _ = _jax_segmenter(jcfg)
    feat = _images((2,) + hw + (64,))
    ref = jseg.pup_head_forward(jnp.asarray(feat), t["head"], out)
    _, tcfg = _cfgs()
    model = _port(tcfg, t, _jax_segmenter(jcfg)[1])
    got = tseg.pup_head_forward(torch.from_numpy(feat), model.head, out)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2,) + out + (
        N_CLASSES,)
    _close(got, ref)


@pytest.mark.parametrize("src,dst", [
    ((32, 32), (64, 64)),      # a PUP stage, x2
    ((128, 128), (512, 512)),  # the aux heads' last resize at 512, x4
    ((16, 16), (64, 64)),      # x4
    ((16, 24), (40, 52)),      # other factors, up
    ((64, 64), (32, 32)),      # down x2 (antialiased in JAX)
    ((64, 48), (27, 31)),      # down by other factors
    ((16, 64), (40, 32)),      # one axis up, the other down
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_bilinear_matches_jax_image_resize(src, dst, dtype):
    """`jax.image.resize(..., "bilinear")` renormalises the weights of taps
    that fall outside the input; `F.interpolate` clamps the sample
    position.  The two agree, at the edges too."""
    x = _images((2,) + src + (3,), seed=sum(src))
    ref = jax.image.resize(jnp.asarray(x, getattr(jnp, dtype)),
                           (2,) + dst + (3,), method="bilinear")
    got = tseg.resize_bilinear(torch.from_numpy(x).to(getattr(torch, dtype)),
                               dst)
    assert got.dtype == getattr(torch, dtype) and got.is_contiguous()
    ref = np.asarray(ref.astype(jnp.float32))
    tol = TOL if dtype == "float32" else dict(
        rtol=0, atol=2e-2 * np.abs(ref).max())
    _close(got.float(), ref, tol)


def test_segmentation_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 7, N_CLASSES)).astype(np.float32) * 3
    labels = rng.integers(0, N_CLASSES, (2, 6, 7)).astype(np.int32)
    labels[0, :2] = 255
    ref = jseg.segmentation_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tseg.segmentation_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    _close(got, ref)


def test_all_ignore_batch_gives_zero_loss():
    """Every pixel ignored: JAX divides by max(0, 1) and gives 0; the port
    too (mean-reduced `F.cross_entropy` would give NaN there)."""
    logits = torch.randn(1, 4, 4, 3, requires_grad=True)
    labels = torch.full((1, 4, 4), 255, dtype=torch.int32)
    ref = jseg.segmentation_loss(jnp.asarray(logits.detach().numpy()),
                                 jnp.asarray(labels.numpy()))
    loss = tseg.segmentation_loss(logits, labels)
    assert float(loss) == float(ref) == 0.0
    loss.backward()
    assert torch.equal(logits.grad, torch.zeros_like(logits))
    assert torch.isnan(F.cross_entropy(logits.detach().permute(0, 3, 1, 2),
                                       labels.long(), ignore_index=255))
    labels[0, 0, 0] = 1
    assert float(tseg.segmentation_loss(logits, labels)) > 0


def test_iou_counts_match_jax():
    """Counts per class equal JAX's loop exactly, with ignored pixels and a
    label past the class count (counted in neither)."""
    rng = np.random.default_rng(4)
    pred = rng.integers(0, N_CLASSES, (3, 9, 11))
    labels = rng.integers(0, N_CLASSES, (3, 9, 11))
    labels[0, 0] = 255
    labels[1, 1, :3] = 200
    for a, b in zip(tseg.iou_counts(pred, labels, N_CLASSES),
                    jseg.iou_counts(pred, labels, N_CLASSES)):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert tseg.mean_iou(pred, labels, N_CLASSES) == jseg.mean_iou(
        pred, labels, N_CLASSES)


def test_mean_iou():
    pred = np.array([[0, 0], [1, 1]])
    labels = np.array([[0, 0], [1, 255]])
    assert tseg.mean_iou(pred, labels, n_classes=2) == 1.0
    assert tseg.mean_iou(1 - pred, labels, n_classes=2) == 0.0


def test_iou_counts_dataset_level():
    """Summed counts give the dataset-level mIoU (4/5 for class 0), not a
    mean of per-batch mIoUs (0.5)."""
    ia, ua = tseg.iou_counts(np.zeros((1, 2, 2)), np.zeros((1, 2, 2)), 2)
    ib, ub = tseg.iou_counts(np.ones((1, 1, 1)), np.zeros((1, 1, 1)), 2)
    assert tseg.mean_iou_from_counts(ia + ib, ua + ub) == (4 / 5 + 0.0) / 2
    assert tseg.mean_iou_from_counts(np.zeros(3), np.zeros(3)) == 0.0


def test_slide_geometry_matches_jax():
    for crop in (32, 512):
        assert tseg.slide_stride(crop) == jseg.slide_stride(crop)
        for stride in (None, 1, crop // 3, crop):
            s = tseg.slide_stride(crop, stride)
            assert s == jseg.slide_stride(crop, stride)
            for full in (crop, crop + 1, 2 * crop - 1, 640, 3 * crop + 7):
                if full >= crop:
                    assert tseg.slide_starts(full, crop, s) == \
                        jseg.slide_starts(full, crop, s)
        for bad in (-1, crop + 1):
            with pytest.raises(ValueError, match="slide stride"):
                tseg.slide_stride(crop, bad)
    assert tseg.slide_starts(640, 512, 341) == [0, 128]


@pytest.mark.parametrize("shape,stride", [((1, 64, 80, 3), None),
                                          ((2, 48, 32, 3), 32),
                                          ((1, 40, 40, 3), 5)])
def test_slide_forward_matches_jax(shape, stride):
    jcfg, tcfg = _cfgs(**SMALL)
    t, f = _jax_segmenter(jcfg, n_aux=0)
    model = _port(tcfg, t, f)
    x = _images(shape, seed=5)
    ref = jseg.segmenter_slide_forward(t, f, jnp.asarray(x), jcfg,
                                       stride=stride)
    with torch.no_grad():
        got = tseg.segmenter_slide_forward(model, torch.from_numpy(x), tcfg,
                                           stride=stride)
    _close(got, ref)
    with pytest.raises(ValueError, match="smaller than crop"):
        tseg.segmenter_slide_forward(model, torch.zeros(1, 16, 16, 3), tcfg)


@pytest.mark.parametrize("fused", [False, True])
def test_segmenter_forward_train_matches_jax(fused):
    """Main and 3 aux heads' logits from one trunk pass, the aux heads on
    blocks 1, 2, 3 (`aux_indices(4, 3)`); plain and fused attention."""
    jcfg, tcfg = _cfgs(fused)
    t, f = _jax_segmenter(jcfg)
    model = _port(tcfg, t, f)
    x = _images((2, 64, 64, 3), seed=6)
    ref_main, ref_aux = jseg.segmenter_forward_train(t, f, jnp.asarray(x),
                                                     jcfg)
    with torch.no_grad():
        main, aux = tseg.segmenter_forward_train(model, torch.from_numpy(x),
                                                 tcfg)
        plain = tseg.segmenter_forward(model, torch.from_numpy(x), tcfg)
    assert tseg.aux_indices(4, 3) == jseg.aux_indices(4, 3) == [1, 2, 3]
    assert tseg.aux_indices(24, 3) == [9, 14, 19]
    _close(main, ref_main)
    _close(plain, ref_main)
    assert len(aux) == 3
    for a, r in zip(aux, ref_aux):
        _close(a, r)


def _jax_tx(t, lr, mult, wd=1e-4):
    labels = {k: jax.tree.map(lambda _: "bb" if k == "backbone" else "head",
                              v) for k, v in t.items()}
    return optax.multi_transform(
        {"bb": optax.adamw(lr, weight_decay=wd),
         "head": optax.adamw(lr * mult, weight_decay=wd)}, labels)


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_trajectory_matches_jax(fused):
    """Three `make_seg_train_step` steps, aux losses at 0.4 and the heads
    at 10x the backbone's lr (`optax.multi_transform` against the port's
    two AdamW groups): losses, grad norms and every trainable tensor."""
    jcfg, tcfg = _cfgs(fused)
    t, f = _jax_segmenter(jcfg)
    model = _port(tcfg, t, f)
    rng = np.random.default_rng(7)
    batches = [{"image": _images((2, 64, 64, 3), seed=10 + i),
                "label": rng.integers(0, N_CLASSES, (2, 64, 64)).astype(
                    np.int32)} for i in range(3)]
    for b in batches:
        b["label"][:, :5] = 255
    tx = _jax_tx(t, 1e-3, 10.0)
    jstep = jseg.make_seg_train_step(jcfg, tx)
    jt = jax.tree.map(jnp.asarray, t)
    opt_state = tx.init(jt)
    step = tseg.make_seg_train_step(tcfg, tseg.seg_optimizer(
        model, 1e-3, 1e-4, head_lr_mult=10.0))
    for b in batches:
        jt, opt_state, jm = jstep(jt, opt_state, f, jax.tree.map(
            jnp.asarray, b))
        m = step(model, {k: torch.from_numpy(v) for k, v in b.items()})
        _close(m["loss"], jm["loss"])
        _close(m["grad_norm"], jm["grad_norm"])
    ts, _ = seg_state_from_jax(jax.tree.map(np.asarray, jt), f)
    params = dict(model.named_parameters())
    for name, want in ts.items():
        _close(params[name].detach(), want.numpy(), dict(rtol=1e-4,
                                                         atol=2e-5))


def test_segmenter_shapes_and_grads():
    """The JAX package's case: per-pixel logits, and under "full" every
    block's whole projection gets a gradient, nothing frozen does."""
    _, tcfg = _cfgs(**SMALL)
    model = tseg.init_segmenter(tcfg, 5, channels=32)
    x = torch.randn(2, 32, 32, 3)
    logits = tseg.segmenter_forward(model, x, tcfg)
    assert logits.shape == (2, 32, 32, 5)
    tseg.segmentation_loss(logits, torch.zeros(2, 32, 32,
                                               dtype=torch.int32)).backward()
    for blk in model.backbone.blocks:
        g = blk.attn.proj.kernel.grad
        assert g.shape == (64, 64) and torch.isfinite(g).all()
        assert g.abs().max() > 0
        assert blk.attn.proj_wt is None
        assert blk.attn.qkv.kernel.grad is None


def test_aux_heads_train_step():
    """Aux heads read the trunk at fractional depths; their losses join at
    0.4 and their parameters train."""
    _, tcfg = _cfgs(**SMALL)
    model = tseg.init_segmenter(tcfg, 5, channels=16, n_aux_heads=2,
                                aux_channels=8)
    x = torch.randn(2, 32, 32, 3)
    main, aux = tseg.segmenter_forward_train(model, x, tcfg)
    assert main.shape == (2, 32, 32, 5)
    assert len(aux) == 2 and all(a.shape == (2, 32, 32, 5) for a in aux)
    before = [p.detach().clone() for p in model.aux_heads.parameters()]
    step = tseg.make_seg_train_step(tcfg, tseg.seg_optimizer(model, 1e-3,
                                                             1e-4))
    m = step(model, {"image": x, "label": torch.zeros(2, 32, 32,
                                                      dtype=torch.int32)})
    assert np.isfinite(float(m["loss"]))
    assert all(not torch.equal(a, b)
               for a, b in zip(before, model.aux_heads.parameters()))
    with pytest.raises(ValueError, match="at most 3 aux heads"):
        tseg.Segmenter(tcfg, 5, n_aux_heads=4)


def test_head_lr_mult():
    """The decoder head moves ~mult times further per AdamW step."""
    _, tcfg = _cfgs(**SMALL)
    x = torch.randn(2, 32, 32, 3)
    labels = torch.ones(2, 32, 32, dtype=torch.int32)
    deltas = {}
    for mult in (1.0, 10.0):
        model = tseg.init_segmenter(tcfg, 5, channels=16)
        step = tseg.make_seg_train_step(tcfg, tseg.seg_optimizer(
            model, 1e-3, 1e-4, head_lr_mult=mult))
        before = model.head.cls.kernel.detach().clone()
        step(model, {"image": x, "label": labels})
        deltas[mult] = float((model.head.cls.kernel - before).abs().mean())
    assert deltas[10.0] > 5 * deltas[1.0]


def test_apla_rank_mode_seg_matches_jax():
    """A rank-8 APLA backbone: the sampled columns are JAX's, and so is
    the forward."""
    jcfg, tcfg = _cfgs(**SMALL)
    t, f = _jax_segmenter(jcfg, n_aux=0, apla_cfg=JAplaConfig(
        partial_size=8))
    assert t["backbone"]["blocks"]["proj_wt"].shape == (2, 64, 8)
    model = _port(tcfg, t, f)
    fresh = tseg.init_segmenter(tcfg, N_CLASSES, AplaConfig(partial_size=8),
                                channels=16)
    for a, b in zip(model.backbone.blocks, fresh.backbone.blocks):
        assert torch.equal(a.attn.inds, b.attn.inds)
    x = _images((1, 32, 32, 3), seed=8)
    ref = jseg.segmenter_forward(t, f, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = tseg.segmenter_forward(model, torch.from_numpy(x), tcfg)
    _close(got, ref)


def test_vit_features_return_layers_matches_jax():
    """`vit_features(..., return_layers=True)`: the final-norm tokens and
    every block's output before the final norm (the JAX scan's ys)."""
    from apla_tpu.models.classifier import _backbone_params
    from apla_tpu.models.vit import vit_features as j_vit_features
    from apla_tpu_torch.models.vit import vit_features
    jcfg, tcfg = _cfgs()
    t, f = _jax_segmenter(jcfg, n_aux=0)
    model = _port(tcfg, t, f)
    x = _images((2, 64, 64, 3), seed=9)
    params, apla_t = _backbone_params({"backbone": t["backbone"]}, f)
    ref_tokens, ref_layers = j_vit_features(params, jnp.asarray(x), jcfg,
                                            trainable=apla_t,
                                            return_layers=True)
    with torch.no_grad():
        tokens, layers = vit_features(model.backbone, torch.from_numpy(x),
                                      tcfg, return_layers=True)
    assert len(layers) == 4 and tokens.shape == (2, 17, 64)
    _close(tokens, ref_tokens)
    for i, layer in enumerate(layers):
        _close(layer, ref_layers[i])
    with pytest.raises(ValueError, match="packing"):
        vit_features(model.backbone, torch.zeros(4, 64, 64, 3), tcfg,
                     pack_segments=2, return_layers=True)
