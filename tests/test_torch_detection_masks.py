"""The port's instance-mask branch against the JAX package's
(`apla_tpu/data/detection_data.py`, `apla_tpu/models/detection.py`,
`apla_tpu/segdet.py`).

- COCO RLE, uncompressed and compressed (written here with pycocotools'
  `rleToString` rule), decoded bit for bit as JAX decodes it.
- `polygons_to_mask` bit for bit against the JAX function, which draws
  with Pillow, on 2,400 seeded polygons: fractional, negative and
  out-of-grid vertices, horizontal edges, self-intersecting rings,
  repeated and collinear points, several rings, rings of fewer than 3
  points.
- `CocoDetection(with_masks=True)`'s `_gt_mask` in its three branches
  (RLE, polygons, the box fallback) and the collated `masks`.
- The protonet forward, the prototype-mask loss and its gradients, the
  decode with masks, `mask_iou`, `DetectionAP(use_masks=True)`, and a
  3-step `make_detection_train_step(with_mask=True)` trajectory on the
  plain and the fused window path: float32, rtol = atol = 1e-4.
- The `segdet det --masks` loop for 2 epochs on a set written here, the
  port's loop started from the JAX loop's initial weights: every logged
  step's loss terms and the box and mask mAP@50 of each epoch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apla_tpu.data import detection_data as jdata
from apla_tpu.models import detection as jdet
from apla_tpu.models import swin as jswin
from apla_tpu_torch.data import detection_data as tdata
from apla_tpu_torch.models import detection as tdet
from apla_tpu_torch.models import swin as tswin
from apla_tpu_torch.utils.pretrained import det_state_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
          num_heads=(1, 2), window_size=7)
N_CLASSES = 3
N_PROTOS = 8
STRIDES = (4, 8)
HM = 14                      # the mask grid: 56 / stride 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ #
# RLE and polygons
# ------------------------------------------------------------------ #

def _rle_counts(mask):
    """Column-major runs of a 0/1 mask, starting with a run of zeros."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    counts.append(run)
    return counts


def _rle_string(counts):
    """pycocotools' rleToString: each count past the second a delta on
    counts[-2], in 5-bit groups with 0x20 = more, offset by 48."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


@pytest.mark.parametrize("compressed", [False, True])
def test_rle_matches_jax(compressed):
    rng = np.random.default_rng(4 + compressed)
    for _ in range(40):
        h, w = rng.integers(1, 60, 2)
        mask = (rng.random((h, w)) < rng.uniform(0.05, 0.95)).astype(
            np.uint8)
        if rng.random() < 0.3:
            mask[:] = rng.integers(0, 2)         # one run only
        counts = _rle_counts(mask)
        rle = {"size": [int(h), int(w)],
               "counts": _rle_string(counts) if compressed else counts}
        if compressed:
            assert tdata._rle_counts_from_string(rle["counts"]) == counts
        got = tdata.rle_to_mask(rle)
        np.testing.assert_array_equal(got, jdata.rle_to_mask(rle))
        np.testing.assert_array_equal(got, mask)


def _ring(rng, kind):
    n = int(rng.integers(3, 10))
    if kind == "fractional":
        pts = rng.uniform(0, 56, (n, 2))
    elif kind == "out_of_grid":
        pts = rng.uniform(-80, 140, (n, 2))
    elif kind == "horizontal":
        pts = rng.uniform(-2, 58, (n, 2))
        for i in range(1, n, 2):             # runs of equal y
            pts[i, 1] = pts[i - 1, 1]
    elif kind == "self_intersecting":
        pts = rng.uniform(0, 56, (n, 2))
        pts = pts[rng.permutation(n)]        # a star-like zig-zag
    elif kind == "repeated":
        pts = rng.uniform(0, 56, (n, 2))
        pts = np.repeat(pts, rng.integers(1, 3, n), axis=0)
        pts = np.concatenate([pts, pts[:1]])  # closed explicitly
    elif kind == "integer_collinear":
        pts = rng.integers(-3, 12, (n, 2)).astype(float) * 5
        pts[1] = (pts[0] + pts[2]) / 2       # a midpoint
    elif kind == "tiny":
        pts = rng.uniform(10, 14, (n, 2))    # a pixel or two across
    else:                                    # fewer than 3 points
        pts = rng.uniform(0, 56, (int(rng.integers(0, 3)), 2))
    return [float(v) for v in pts.reshape(-1)]


@pytest.mark.parametrize("kind", ["fractional", "out_of_grid", "horizontal",
                                  "self_intersecting", "repeated",
                                  "integer_collinear", "tiny", "short"])
def test_polygons_to_mask_matches_pillow(kind):
    """300 seeded annotations of each kind (2,400 in all), one to three
    rings each, in source coordinates scaled onto the 14 x 14 and 56 x 56
    grids as `_gt_mask` scales them."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    n_drawn = 0
    for t in range(300):
        rings = [_ring(rng, kind) for _ in range(int(rng.integers(1, 4)))]
        w0, h0 = rng.uniform(40, 300, 2)
        for grid in (HM, 56):
            kw = dict(sx=grid / w0, sy=grid / h0)
            src = [[v * (w0 / 56 if i % 2 == 0 else h0 / 56)
                    for i, v in enumerate(r)] for r in rings]
            got = tdata.polygons_to_mask(src, grid, grid, **kw)
            want = jdata.polygons_to_mask(src, grid, grid, **kw)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{t} {rings}")
            n_drawn += int(want.any())
    if kind == "short":
        assert n_drawn == 0
    else:
        assert n_drawn > 100


def _write_coco(tmp_path, n_images=4, size=56, seed=0):
    """PNG images with a bright ellipse per object on a dark ground; the
    annotations cycle through a polygon, an uncompressed RLE, a compressed
    RLE, and a missing and an empty segmentation (the box fallback)."""
    rng = np.random.default_rng(seed)
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    yy, xx = np.mgrid[:size, :size]
    for i in range(n_images):
        img = np.full((size, size, 3), 30, np.uint8)
        for k in range(2):
            x, y = rng.uniform(2, size / 2, 2)
            bw, bh = rng.uniform(12, size / 2 - 2, 2)
            cx, cy = x + bw / 2, y + bh / 2
            m = (((xx + 0.5 - cx) / (bw / 2)) ** 2
                 + ((yy + 0.5 - cy) / (bh / 2)) ** 2 <= 1).astype(np.uint8)
            img[m > 0] = (200, 90 + 60 * k, 40)
            style = (2 * i + k) % 5
            ann = {"id": len(anns) + 1, "image_id": i, "category_id": 1 + k,
                   "bbox": [x, y, bw, bh], "iscrowd": 0}
            if style == 0:
                t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
                ann["segmentation"] = [list(np.stack(
                    [cx + bw / 2 * np.cos(t), cy + bh / 2 * np.sin(t)],
                    1).reshape(-1))]
            elif style in (1, 2):
                counts = _rle_counts(m)
                ann["segmentation"] = {
                    "size": [size, size],
                    "counts": counts if style == 1 else _rle_string(counts)}
            elif style == 3:
                ann["segmentation"] = []
            anns.append(ann)
        name = f"im{i}.png"
        tdata.write_png(str(img_dir / name), img)
        images.append({"id": i, "file_name": name, "width": size,
                       "height": size})
    ann_file = tmp_path / "instances.json"
    ann_file.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}))
    return str(img_dir), str(ann_file)


def test_gt_masks_and_collate_match_jax(tmp_path):
    img_dir, ann = _write_coco(tmp_path, n_images=5)
    kw = dict(img_size=56, max_boxes=4, with_masks=True, mask_stride=4)
    got_ds = tdata.CocoDetection(img_dir, ann, **kw)
    want_ds = jdata.CocoDetection(img_dir, ann, **kw)
    branches = set()
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert got["masks"].shape == (4, HM, HM)
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_allclose(got["boxes"], want["boxes"])
        for a in got_ds.anns_by_image[got_ds.ids[i]]:
            seg = a.get("segmentation")
            branches.add(type(seg["counts"]).__name__ if isinstance(seg, dict)
                         else "poly" if seg else "box")
            np.testing.assert_array_equal(
                got_ds._gt_mask(a, (56, 56), HM),
                want_ds._gt_mask(a, (56, 56), HM))
    assert branches == {"poly", "list", "str", "box"}
    # a source size that is not the grid's multiple (the RLE's nearest
    # sample and the polygon scale), and the box fallback's rounding
    a = {"bbox": [3.3, 7.9, 40.2, 21.7],
         "segmentation": {"size": [97, 131], "counts": [500, 2000, 9000]}}
    for seg in (a["segmentation"], [[3.3, 7.9, 43.5, 7.9, 20, 29.6]], None):
        b = dict(a, segmentation=seg)
        np.testing.assert_array_equal(got_ds._gt_mask(b, (97, 131), HM),
                                      want_ds._gt_mask(b, (97, 131), HM))
    batch = tdata.detection_collate([got_ds[0], got_ds[1]])
    np.testing.assert_array_equal(
        batch["masks"],
        jdata.detection_collate([want_ds[0], want_ds[1]])["masks"])
    assert "masks" not in tdata.detection_collate(
        [tdata.CocoDetection(img_dir, ann, img_size=56)[0]])


# ------------------------------------------------------------------ #
# model, loss, decode, mAP
# ------------------------------------------------------------------ #

def _jax_detector(seed=0):
    """The JAX segdet loop's trees at KW with the mask branch (head
    channels 16, `n_protos` coefficients, the protonet), as numpy, with
    small noise on every leaf so that a swapped leaf shows."""
    cfg = jswin.SwinConfig(compute_dtype=jnp.float32, **KW)
    key, k_bb = jax.random.split(jax.random.PRNGKey(seed))
    bb_t, bb_f = jswin.build_apla_swin(jswin.init_swin_params(k_bb, cfg))
    keys = jax.random.split(key, 3)
    trainable = {
        "backbone": bb_t,
        "head": jdet.init_fcos_head(keys[0], 32, N_CLASSES, channels=16,
                                    n_levels=2, n_protos=N_PROTOS),
        "laterals": [jdet._conv_init(keys[1 + i], 1, 32 * 2 ** i, 32)
                     for i in range(2)],
        "protonet": jdet.init_protonet(jax.random.fold_in(key, 7), 32,
                                       n_protos=N_PROTOS),
    }
    rng = np.random.default_rng(seed)
    trainable = jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.05, trainable)
    return cfg, trainable, jax.tree.map(np.asarray, bb_f)


def _port_detector(trainable, frozen, fused=False):
    cfg = tswin.SwinConfig(compute_dtype=torch.float32, use_fused_apla=fused,
                           **KW)
    model = tdet.Detector(cfg, N_CLASSES, n_protos=N_PROTOS)
    t, f = det_state_from_jax(trainable, frozen)
    params = dict(model.named_parameters())
    assert set(params) == set(t) | set(f)
    assert {"head.coef.kernel", "protonet.convs.1.bias",
            "protonet.out.kernel"} <= set(t)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(t[name] if name in t else f[name])
            p.requires_grad_(name in t)
    return cfg, model


def _batch(seed=1, b=2, m=4):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((b, 56, 56, 3)).astype(np.float32)
    xy = rng.uniform(0, 36, (b, m, 2))
    wh = rng.uniform(8, 30, (b, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 56)], -1).astype(
        np.float32)
    labels = rng.integers(0, N_CLASSES, (b, m)).astype(np.int32)
    labels[:, -1] = -1                       # a padding row
    boxes[:, -1] = 0
    c = (np.arange(HM) + 0.5) * 4
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    rx = (boxes[..., 2] - boxes[..., 0]) / 2 + 1e-3
    ry = (boxes[..., 3] - boxes[..., 1]) / 2 + 1e-3
    masks = (((c[None, None, None, :] - cx[..., None, None])
              / rx[..., None, None]) ** 2
             + ((c[None, None, :, None] - cy[..., None, None])
                / ry[..., None, None]) ** 2 <= 1).astype(np.uint8)
    masks[:, -1] = 0
    return {"image": image, "boxes": boxes, "labels": labels,
            "masks": masks}


def test_protonet_and_head_forward_match_jax():
    jcfg, trainable, frozen = _jax_detector()
    tcfg, model = _port_detector(trainable, frozen)
    x = _batch()["image"]

    def fwd(t, f, im):
        feats = jswin.swin_features(f, im, jcfg, trainable=t["backbone"])
        outs = jdet.fcos_head_forward(feats, t["head"], t["laterals"])
        protos = jdet.protonet_forward(
            jdet._conv(feats[0], t["laterals"][0]), t["protonet"])
        return outs, protos

    ref_outs, ref_protos = jax.jit(fwd)(trainable, frozen, jnp.asarray(x))
    with torch.no_grad():
        outs, protos = tdet.detector_outputs(model, torch.tensor(x), tcfg)
    assert tuple(protos.shape) == (2, HM, HM, N_PROTOS)
    np.testing.assert_allclose(protos.numpy(), np.asarray(ref_protos), **TOL)
    for g_lvl, r_lvl in zip(outs, ref_outs):
        assert len(g_lvl) == len(r_lvl) == 4
        for g, r in zip(g_lvl, r_lvl):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def _mask_inputs(seed=3):
    rng = np.random.default_rng(seed)
    levels = []
    for h, scale in ((14, 40), (7, 80)):
        levels.append((rng.standard_normal((2, h, h, N_CLASSES)) * 2,
                       rng.uniform(0, scale, (2, h, h, 4)),
                       rng.standard_normal((2, h, h, 1)),
                       np.tanh(rng.standard_normal((2, h, h, N_PROTOS)))))
    levels = [tuple(a.astype(np.float32) for a in lvl) for lvl in levels]
    protos = np.maximum(rng.standard_normal((2, HM, HM, N_PROTOS)),
                        0).astype(np.float32)
    return levels, protos


def test_mask_loss_and_gradients_match_jax():
    levels, protos = _mask_inputs()
    b = _batch()

    def jloss(lv, pr):
        return jdet.fcos_loss_batch(lv, STRIDES, jnp.asarray(b["boxes"]),
                                    jnp.asarray(b["labels"]), protos=pr,
                                    gt_masks=jnp.asarray(b["masks"]),
                                    mask_stride=4)

    j_lv = [tuple(jnp.asarray(a) for a in lvl) for lvl in levels]
    ref = jax.jit(jloss)(j_lv, jnp.asarray(protos))
    ref_g = jax.jit(jax.grad(lambda lv, pr: jloss(lv, pr)["total"],
                             argnums=(0, 1)))(j_lv, jnp.asarray(protos))
    t_lv = [tuple(torch.tensor(a, requires_grad=True) for a in lvl)
            for lvl in levels]
    t_pr = torch.tensor(protos, requires_grad=True)
    got = tdet.fcos_loss_batch(t_lv, STRIDES, torch.tensor(b["boxes"]),
                               torch.tensor(b["labels"]), protos=t_pr,
                               gt_masks=torch.tensor(b["masks"]),
                               mask_stride=4)
    assert set(got) == set(ref) == {"cls_loss", "box_loss", "ctr_loss",
                                    "mask_loss", "total"}
    assert float(ref["mask_loss"]) > 0.1
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]),
                                   **TOL, err_msg=k)
    got["total"].backward()
    for g_lvl, r_lvl in zip(t_lv, ref_g[0]):
        for g, r in zip(g_lvl, r_lvl):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(r),
                                       **TOL)
    assert np.abs(np.asarray(ref_g[0][0][3])).max() > 0   # coef trains
    np.testing.assert_allclose(t_pr.grad.numpy(), np.asarray(ref_g[1]),
                               **TOL)
    # one image's terms, as the JAX per-image function returns them
    single = jax.jit(lambda lv, cf, pr: jdet._fcos_loss_single(
        lv, STRIDES, jnp.asarray(b["boxes"][0]), jnp.asarray(b["labels"][0]),
        coefs=cf, protos=pr, gt_masks=jnp.asarray(b["masks"][0])))(
        [tuple(jnp.asarray(a[0]) for a in lvl[:3]) for lvl in levels],
        [jnp.asarray(lvl[3][0]) for lvl in levels], jnp.asarray(protos[0]))
    t_single = tdet._fcos_loss_single(
        [tuple(torch.tensor(a[0]) for a in lvl[:3]) for lvl in levels],
        STRIDES, torch.tensor(b["boxes"][0]), torch.tensor(b["labels"][0]),
        coefs=[torch.tensor(lvl[3][0]) for lvl in levels],
        protos=torch.tensor(protos[0]), gt_masks=torch.tensor(b["masks"][0]))
    assert len(t_single) == len(single) == 6
    np.testing.assert_allclose([float(v) for v in t_single],
                               [float(v) for v in single], **TOL)


def test_decode_masks_mask_iou_and_mask_map_match_jax():
    rng = np.random.default_rng(5)
    levels = [(rng.standard_normal((1, 14, 14, N_CLASSES)) * 3,
               rng.uniform(1, 12, (1, 14, 14, 4)),
               rng.standard_normal((1, 14, 14, 1)),
               np.tanh(rng.standard_normal((1, 14, 14, N_PROTOS)))),
              (rng.standard_normal((1, 7, 7, N_CLASSES)) * 3,
               rng.uniform(1, 24, (1, 7, 7, 4)),
               rng.standard_normal((1, 7, 7, 1)),
               np.tanh(rng.standard_normal((1, 7, 7, N_PROTOS))))]
    levels = [tuple(a.astype(np.float32) for a in lvl) for lvl in levels]
    protos = np.maximum(rng.standard_normal((1, HM, HM, N_PROTOS)) * 2,
                        0).astype(np.float32)
    got = tdet.decode_detections(levels, STRIDES, top_k=20,
                                 protos=torch.tensor(protos), mask_stride=4)
    ref = jdet.decode_detections([tuple(jnp.asarray(a) for a in lvl)
                                  for lvl in levels], STRIDES, top_k=20,
                                 protos=jnp.asarray(protos), mask_stride=4)
    assert len(got) == 4 and len(got[0]) > 3 and got[3].dtype == bool
    assert got[3].any() and not got[3].all()
    # the score sigmoid is numpy's on one side, XLA's on the other: an ulp
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    # no detection above the threshold: empty masks of the grid's shape
    empty = tdet.decode_detections(levels, STRIDES, score_thresh=2.0,
                                   protos=protos)
    assert empty[3].shape == (0, HM, HM)
    # without protos the 4-map levels decode boxes only
    assert len(tdet.decode_detections(levels, STRIDES, top_k=20)) == 3
    # ground truth: three of the detections' masks, a pixel flipped each
    idx = np.nonzero(got[3].sum((1, 2)) > 4)[0][:3]
    assert len(idx) == 3
    gt_masks = got[3][idx].copy()
    gt_masks[:, 7, 7] ^= True
    for a, b in [(got[3][idx[0]], gt_masks[0]), (gt_masks[1], gt_masks[1]),
                 (got[3][idx[1]], gt_masks[2]),
                 (np.zeros((HM, HM)), np.zeros((HM, HM)))]:
        assert tdet.mask_iou(a, b) == jdet.mask_iou(a, b)
    for iou in (0.5, 0.75):
        metrics = [m(N_CLASSES, iou_thresh=iou, use_masks=True)
                   for m in (tdet.DetectionAP, jdet.DetectionAP)]
        for m in metrics:
            m.add_image(0, got[0], got[1], got[2], got[0][idx], got[2][idx],
                        pred_masks=got[3], gt_masks=gt_masks)
            m.add_image(1, got[0][:2], got[1][:2], got[2][:2], got[0][:1],
                        np.array([-1]), pred_masks=got[3][:2],
                        gt_masks=gt_masks[:1])
        assert metrics[0].mean_ap() == metrics[1].mean_ap() > 0


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_with_mask_trajectory_matches_jax(fused):
    """3 steps of `make_detection_train_step(with_mask=True)` (AdamW lr
    1e-3, wd 1e-4): each step's loss terms, `mask_loss` among them, and the
    gradient norm, then every trainable tensor (the protonet and the
    coefficient conv included), against the JAX step on the same
    batches."""
    jcfg, trainable, frozen = _jax_detector(seed=2)
    tcfg, model = _port_detector(trainable, frozen, fused)
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    j_step = jdet.make_detection_train_step(jcfg, tx, strides=STRIDES,
                                            with_mask=True)
    opt = tdet.detection_optimizer(model, 1e-3, 1e-4)
    t_step = tdet.make_detection_train_step(tcfg, opt, strides=STRIDES,
                                            with_mask=True)
    j_t = jax.tree.map(jnp.asarray, trainable)
    j_opt = tx.init(j_t)
    for i in range(3):
        b = _batch(seed=10 + i)
        j_t, j_opt, j_m = j_step(j_t, j_opt, jax.tree.map(jnp.asarray, frozen),
                                 jax.tree.map(jnp.asarray, b))
        t_m = t_step(model, {k: torch.tensor(v) for k, v in b.items()})
        assert float(j_m["mask_loss"]) > 0.1
        for k in ("total", "cls_loss", "box_loss", "ctr_loss", "mask_loss",
                  "grad_norm"):
            np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), **TOL,
                                       err_msg=f"step {i} {k}")
    want, _ = det_state_from_jax(jax.tree.map(np.asarray, j_t), {})
    params = dict(model.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(params[name].detach().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ------------------------------------------------------------------ #
# the loop (ROADMAP C 1, CPU half)
# ------------------------------------------------------------------ #

def _jax_loop_init(seed, n_classes, n_protos, embed_dim, depths, num_heads,
                   window_size, img_size):
    """The JAX `train_detection`'s initial trees, drawn as it draws them."""
    cfg = jswin.SwinConfig(img_size=img_size, patch_size=4,
                           embed_dim=embed_dim, depths=tuple(depths),
                           num_heads=tuple(num_heads),
                           window_size=window_size,
                           compute_dtype=jnp.float32)
    key, k_bb = jax.random.split(jax.random.PRNGKey(seed))
    bb_t, bb_f = jswin.build_apla_swin(jswin.init_swin_params(k_bb, cfg))
    n_levels = len(depths)
    keys = jax.random.split(key, n_levels + 1)
    trainable = {
        "backbone": bb_t,
        "head": jdet.init_fcos_head(keys[0], embed_dim, n_classes,
                                    channels=max(embed_dim // 2, 16),
                                    n_levels=n_levels, n_protos=n_protos),
        "laterals": [jdet._conv_init(keys[1 + i], 1, embed_dim * 2 ** i,
                                     embed_dim) for i in range(n_levels)],
        "protonet": jdet.init_protonet(jax.random.fold_in(key, 7),
                                       embed_dim, n_protos=n_protos),
    }
    return (jax.tree.map(np.asarray, trainable),
            jax.tree.map(np.asarray, bb_f))


def _log_records(save_dir):
    with open(os.path.join(save_dir, "det.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_masks_loop_matches_jax_loop(tmp_path, monkeypatch):
    """`train_detection(masks=True)` of both packages for 2 epochs (2
    steps each, log_every 1) with the same seed, the port's loop started
    from the JAX loop's initial trees (its initialiser patched here): the
    logged loss, class and mask loss of every step agree to the 5
    decimals the loops round them to (1e-4 absolute), and so do both
    epochs' box and mask mAP@50, and the returned bests."""
    from apla_tpu import segdet as jsegdet
    from apla_tpu_torch import segdet as tsegdet

    img_dir, ann = _write_coco(tmp_path, n_images=4)
    kw = dict(img_size=56, batch_size=2, lr=3e-3, embed_dim=32,
              depths=(2, 2), num_heads=(2, 4), num_workers=0, log_every=1,
              masks=True, n_protos=8, seed=3)
    j_out = jsegdet.train_detection(img_dir, ann, epochs=2,
                                    save_dir=str(tmp_path / "jax"), **kw)
    trainable, frozen = _jax_loop_init(3, 2, 8, 32, (2, 2), (2, 4), 7, 56)

    def init_from_jax(cfg, n_classes, generator, device=None, n_protos=0,
                      mask_generator=None):
        assert (n_classes, n_protos) == (2, 8)
        model = tdet.Detector(cfg, n_classes, n_protos)
        t, f = det_state_from_jax(trainable, frozen)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(t[name] if name in t else f[name])
                p.requires_grad_(name in t)
        return model

    monkeypatch.setattr(tsegdet, "init_detector", init_from_jax)
    t_out = tsegdet.train_detection(img_dir, ann, epochs=2,
                                    save_dir=str(tmp_path / "port"),
                                    device="cpu", **kw)
    j_log = _log_records(str(tmp_path / "jax"))
    t_log = _log_records(str(tmp_path / "port"))
    steps = [(r, s) for r, s in zip(t_log, j_log) if "train_loss" in s]
    assert len(steps) == 4 and len(t_log) == len(j_log) == 6
    for r, s in zip(t_log, j_log):
        assert set(r) - {"img_s", "t"} == set(s) - {"img_s", "t"}
        for k, v in s.items():
            if k not in ("img_s", "t"):
                np.testing.assert_allclose(r[k], v, rtol=0, atol=1e-4,
                                           err_msg=f"{k} {s}")
    assert steps[-1][1]["mask_loss"] < steps[0][1]["mask_loss"]
    assert t_out["iters"] == j_out["iters"] == 4
    for k in ("best_map50", "best_mask_map50"):
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=0, atol=1e-6)
