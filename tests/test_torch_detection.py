"""The port's detection head, loss, decode, mAP and train step against the
JAX package's (`apla_tpu/models/detection.py`).

The same inputs, drawn with numpy, and the same weights (the JAX trees
carried over by `utils.pretrained.det_state_from_jax`) go through both:
the FCOS head's per-level maps, the batched loss terms, the host decode
with NMS, `nms`, `DetectionAP`, and a 3-step trajectory of
`make_detection_train_step` (AdamW over the APLA-trainable projections, the
head and the laterals) on the plain and the fused window path.  float32,
rtol = atol = 1e-4 (only the order of f32 sums differs); the decode and
mAP are numpy on both sides and agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apla_tpu.models import detection as jdet
from apla_tpu.models import swin as jswin
from apla_tpu_torch.models import detection as tdet
from apla_tpu_torch.models import swin as tswin
from apla_tpu_torch.utils.pretrained import det_state_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
          num_heads=(1, 2), window_size=7)
N_CLASSES = 3
STRIDES = (4, 8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_detector(seed=0):
    """The JAX segdet loop's trees at KW (head channels 16, one lateral per
    level), as numpy."""
    cfg = jswin.SwinConfig(compute_dtype=jnp.float32, **KW)
    k_bb, k_head = jax.random.split(jax.random.PRNGKey(seed))
    bb_t, bb_f = jswin.build_apla_swin(jswin.init_swin_params(k_bb, cfg))
    keys = jax.random.split(k_head, 3)
    trainable = {
        "backbone": bb_t,
        "head": jdet.init_fcos_head(keys[0], 32, N_CLASSES, channels=16,
                                    n_levels=2),
        "laterals": [jdet._conv_init(keys[1 + i], 1, 32 * 2 ** i, 32)
                     for i in range(2)],
    }
    # non-trivial biases and scales, so that a swapped leaf shows
    rng = np.random.default_rng(seed)
    trainable = jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.01, trainable)
    return cfg, trainable, jax.tree.map(np.asarray, bb_f)


def _port_detector(trainable, frozen, fused=False):
    cfg = tswin.SwinConfig(compute_dtype=torch.float32, use_fused_apla=fused,
                           **KW)
    model = tdet.Detector(cfg, N_CLASSES)
    t, f = det_state_from_jax(trainable, frozen)
    params = dict(model.named_parameters())
    assert set(params) == set(t) | set(f)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(t[name] if name in t else f[name])
            p.requires_grad_(name in t)
    return cfg, model


def _batch(seed=1, b=2, m=4):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((b, 56, 56, 3)).astype(np.float32)
    xy = rng.uniform(0, 40, (b, m, 2))
    wh = rng.uniform(6, 30, (b, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 56)], -1).astype(
        np.float32)
    labels = rng.integers(0, N_CLASSES, (b, m)).astype(np.int32)
    labels[:, -1] = -1                       # a padding row
    boxes[:, -1] = 0
    return {"image": image, "boxes": boxes, "labels": labels}


def _maps(levels):
    return [tuple(np.asarray(o) for o in lvl) for lvl in levels]


def test_head_forward_matches_jax():
    jcfg, trainable, frozen = _jax_detector()
    tcfg, model = _port_detector(trainable, frozen)
    x = _batch()["image"]
    ref = jax.jit(lambda t, f, im: jdet.fcos_head_forward(
        jswin.swin_features(f, im, jcfg, trainable=t["backbone"]),
        t["head"], t["laterals"]))(trainable, frozen, jnp.asarray(x))
    with torch.no_grad():
        got = tdet.detector_forward(model, torch.tensor(x), tcfg)
    for g_lvl, r_lvl in zip(got, ref):
        for g, r in zip(g_lvl, r_lvl):
            assert tuple(g.shape) == r.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_loss_terms_match_jax():
    rng = np.random.default_rng(3)
    levels = [(rng.standard_normal((2, 14, 14, N_CLASSES)) * 2,
               rng.uniform(0, 40, (2, 14, 14, 4)),
               rng.standard_normal((2, 14, 14, 1))),
              (rng.standard_normal((2, 7, 7, N_CLASSES)) * 2,
               rng.uniform(0, 80, (2, 7, 7, 4)),
               rng.standard_normal((2, 7, 7, 1)))]
    levels = [tuple(a.astype(np.float32) for a in lvl) for lvl in levels]
    b = _batch()
    ref = jax.jit(lambda lv, bx, lb: jdet.fcos_loss_batch(lv, STRIDES, bx,
                                                          lb))(
        [tuple(jnp.asarray(a) for a in lvl) for lvl in levels],
        jnp.asarray(b["boxes"]), jnp.asarray(b["labels"]))
    got = tdet.fcos_loss_batch(
        [tuple(torch.tensor(a) for a in lvl) for lvl in levels], STRIDES,
        torch.tensor(b["boxes"]), torch.tensor(b["labels"]))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), **TOL,
                                   err_msg=k)
    single = jax.jit(lambda lv, bx, lb: jdet._fcos_loss_single(
        lv, STRIDES, bx, lb))(
        [tuple(jnp.asarray(a[0]) for a in lvl) for lvl in levels],
        jnp.asarray(b["boxes"][0]), jnp.asarray(b["labels"][0]))
    t_single = tdet._fcos_loss_single(
        [tuple(torch.tensor(a[0]) for a in lvl) for lvl in levels], STRIDES,
        torch.tensor(b["boxes"][0]), torch.tensor(b["labels"][0]))
    np.testing.assert_allclose([float(v) for v in t_single],
                               [float(v) for v in single], **TOL)


def test_decode_nms_and_map_match_jax():
    rng = np.random.default_rng(5)
    levels = [(rng.standard_normal((1, 14, 14, N_CLASSES)) * 3,
               rng.uniform(1, 12, (1, 14, 14, 4)),
               rng.standard_normal((1, 14, 14, 1))),
              (rng.standard_normal((1, 7, 7, N_CLASSES)) * 3,
               rng.uniform(1, 24, (1, 7, 7, 4)),
               rng.standard_normal((1, 7, 7, 1)))]
    levels = [tuple(a.astype(np.float32) for a in lvl) for lvl in levels]
    got = tdet.decode_detections(levels, STRIDES, top_k=20)
    ref = jdet.decode_detections([tuple(jnp.asarray(a) for a in lvl)
                                  for lvl in levels], STRIDES, top_k=20)
    assert len(got[0]) > 3
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(tdet.nms(got[0], got[1], 0.3),
                                  jdet.nms(got[0], got[1], 0.3))
    gt_boxes = got[0][:3] + rng.uniform(-2, 2, (3, 4))
    for iou in (0.5, 0.75):
        metrics = [m(N_CLASSES, iou_thresh=iou) for m in (tdet.DetectionAP,
                                                          jdet.DetectionAP)]
        for m in metrics:
            m.add_image(0, got[0], got[1], got[2], gt_boxes, got[2][:3])
            m.add_image(1, got[0][:2], got[1][:2], got[2][:2], gt_boxes[:1],
                        np.array([-1]))
        assert metrics[0].mean_ap() == metrics[1].mean_ap()
    np.testing.assert_array_equal(tdet.box_iou_matrix(got[0], gt_boxes),
                                  jdet.box_iou_matrix(got[0], gt_boxes))


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_trajectory_matches_jax(fused):
    """3 steps of `make_detection_train_step` (AdamW lr 1e-3, wd 1e-4, no
    decay mask): each step's loss terms and gradient norm, and the trainable
    tensors after the last step, against the JAX step on the same batches."""
    jcfg, trainable, frozen = _jax_detector(seed=2)
    tcfg, model = _port_detector(trainable, frozen, fused)
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    j_step = jdet.make_detection_train_step(jcfg, tx, strides=STRIDES)
    opt = tdet.detection_optimizer(model, 1e-3, 1e-4)
    t_step = tdet.make_detection_train_step(tcfg, opt, strides=STRIDES)
    j_t = jax.tree.map(jnp.asarray, trainable)
    j_opt = tx.init(j_t)
    for i in range(3):
        b = _batch(seed=10 + i)
        j_t, j_opt, j_m = j_step(j_t, j_opt, jax.tree.map(jnp.asarray, frozen),
                                 jax.tree.map(jnp.asarray, b))
        t_m = t_step(model, {k: torch.tensor(v) for k, v in b.items()})
        for k in ("total", "cls_loss", "box_loss", "ctr_loss", "grad_norm"):
            np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), **TOL,
                                       err_msg=f"step {i} {k}")
    want, _ = det_state_from_jax(jax.tree.map(np.asarray, j_t), {})
    params = dict(model.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(params[name].detach().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_masks_raise_naming_their_roadmap_item():
    """The mask branch is ported (tests/test_torch_detection_masks.py
    holds it against JAX): a box-only detector has no mask parameters and
    decodes three outputs, a mask detector adds the coefficient conv and
    the protonet, and the mask metric takes masks."""
    cfg = tswin.SwinConfig(compute_dtype=torch.float32, **KW)
    box, mask = tdet.Detector(cfg, N_CLASSES), tdet.Detector(cfg, N_CLASSES,
                                                             n_protos=4)
    assert box.protonet is None and not hasattr(box.head, "coef")
    extra = set(dict(mask.named_parameters())) - set(
        dict(box.named_parameters()))
    assert extra == {"head.coef.kernel", "head.coef.bias",
                     "protonet.convs.0.kernel", "protonet.convs.0.bias",
                     "protonet.convs.1.kernel", "protonet.convs.1.bias",
                     "protonet.out.kernel", "protonet.out.bias"}
    assert tuple(mask.head.coef.kernel.shape) == (3, 3, 16, 4)
    assert tuple(mask.protonet.out.kernel.shape) == (1, 1, 64, 4)
    ap = tdet.DetectionAP(N_CLASSES, use_masks=True)
    m = np.zeros((1, 14, 14), bool)
    m[0, 2:6, 3:9] = True
    ap.add_image(0, np.zeros((1, 4)), [0.9], [1], np.zeros((1, 4)), [1],
                 pred_masks=m, gt_masks=m)
    assert ap.mean_ap() == pytest.approx(1.0)
