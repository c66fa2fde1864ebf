"""Anchor-free (FCOS-style) detection head on the APLA-Swin feature pyramid.

Counterpart of `apla_tpu/models/detection.py`: shared conv towers ->
per-level class / box / centerness maps, focal + IoU + centerness loss,
top-k + greedy NMS decode, VOC-style mAP, and the train step.  With
`n_protos > 0` the instance-mask branch (the reference recipe's
`with_mask=True`, prototype + coefficient style): a coefficient conv on the
box tower, a protonet on the finest lateral-projected level, the
prototype-mask loss at one representative positive location per instance,
masks in the decode, and mask mAP (`DetectionAP(use_masks=True)`).
Convolutions keep the JAX layouts at the API (NHWC maps, HWIO kernels) and
run as `F.conv2d` inside; a 3x3 "SAME" convolution is padding 1.  The loss is
batched over images where JAX `vmap`s it.  The host-side pieces (`nms`,
`box_iou_matrix`, `DetectionAP`, the decode) are numpy, copied from the JAX
package so that the port imports none of it.  The mask logits are plain
`torch.einsum` products, as they are plain XLA products in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (loss_normaliser, pmean,
                                    reduce_gradients)
from ..train.optim import Optimizer, global_norm
from .swin import Swin, SwinConfig, build_apla_swin, init_swin_params, \
    swin_features
from .vit import _param, trunc_normal


class Conv(nn.Module):
    """A k x k convolution: kernel [k, k, c_in, c_out] (HWIO), bias."""

    def __init__(self, k: int, c_in: int, c_out: int):
        super().__init__()
        self.kernel = _param(k, k, c_in, c_out)
        self.bias = _param(c_out)


class FCOSHead(nn.Module):
    """Class and box towers; `coef` (mask coefficients) when `n_protos`."""

    def __init__(self, in_channels, n_classes, channels=128, n_convs=2,
                 n_levels=4, n_protos=0):
        super().__init__()
        self.cls_tower = nn.ModuleList(
            Conv(3, in_channels if i == 0 else channels, channels)
            for i in range(n_convs))
        self.box_tower = nn.ModuleList(
            Conv(3, in_channels if i == 0 else channels, channels)
            for i in range(n_convs))
        self.cls = Conv(3, channels, n_classes)
        self.box = Conv(3, channels, 4)
        self.ctr = Conv(3, channels, 1)
        if n_protos:
            self.coef = Conv(3, channels, n_protos)
        self.scales = _param(n_levels, fill=1.0)


class ProtoNet(nn.Module):
    """Prototype-mask net on the finest lateral-projected level: n_convs
    3x3 + relu, then a 1x1 to `n_protos` channels + relu."""

    def __init__(self, in_channels, n_protos=32, channels=64, n_convs=2):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv(3, in_channels if i == 0 else channels, channels)
            for i in range(n_convs))
        self.out = Conv(1, channels, n_protos)


class Detector(nn.Module):
    """APLA-Swin backbone, one lateral 1x1 conv per pyramid level, FCOS
    head, and with `n_protos > 0` the mask branch (`head.coef`,
    `protonet`).  Names follow the JAX trees: `backbone.*` (the Swin; its
    `attn.proj`s trainable), `head.*`, `laterals.{i}.*`, `protonet.*`."""

    def __init__(self, swin_cfg: SwinConfig, n_classes: int, n_protos=0):
        super().__init__()
        n_levels = len(swin_cfg.depths)
        lat_ch = swin_cfg.embed_dim
        self.backbone = Swin(swin_cfg)
        self.head = FCOSHead(lat_ch, n_classes, channels=max(lat_ch // 2, 16),
                             n_levels=n_levels, n_protos=n_protos)
        self.laterals = nn.ModuleList(
            Conv(1, swin_cfg.embed_dim * 2 ** i, lat_ch)
            for i in range(n_levels))
        self.protonet = ProtoNet(lat_ch, n_protos) if n_protos else None


def _conv_init_(conv: Conv, generator):
    conv.kernel.copy_(trunc_normal(tuple(conv.kernel.shape), generator,
                                   std=0.01))
    conv.bias.zero_()


@torch.no_grad()
def init_fcos_head(head: FCOSHead, generator) -> FCOSHead:
    """The JAX init: truncated-normal (std 0.01) kernels, zero biases, the
    class bias at the focal-loss prior (p = 0.01), unit level scales."""
    for conv in list(head.cls_tower) + list(head.box_tower) + [
            head.cls, head.box, head.ctr]:
        _conv_init_(conv, generator)
    head.cls.bias.fill_(-math.log((1 - 0.01) / 0.01))
    head.scales.fill_(1.0)
    return head


def mask_generator(seed: int) -> torch.Generator:
    """The mask branch's stream for the loop's `seed`: a stream of its own,
    as the JAX loop folds 7 into its key, so that the box weights are the
    same with masks on or off."""
    folded = int(np.random.SeedSequence([seed, 7]).generate_state(1)[0])
    return torch.Generator().manual_seed(folded)


@torch.no_grad()
def init_detector(swin_cfg: SwinConfig, n_classes: int,
                  generator: torch.Generator, device=None, n_protos=0,
                  mask_generator: torch.Generator | None = None) -> Detector:
    """A `Detector` with the segdet recipe's init (random Swin weights from
    `generator`) and the APLA split applied: trainable are each block's
    `attn.proj`, the head and the laterals (and the mask branch).  The
    mask branch (`n_protos > 0`: `head.coef`, `protonet`) draws from
    `mask_generator` (see `mask_generator(seed)`)."""
    det = Detector(swin_cfg, n_classes, n_protos)
    det.backbone = build_apla_swin(init_swin_params(swin_cfg, generator))
    init_fcos_head(det.head, generator)
    for lat in det.laterals:
        _conv_init_(lat, generator)
    if n_protos:
        for conv in [det.head.coef, *det.protonet.convs, det.protonet.out]:
            _conv_init_(conv, mask_generator)
    return det.to(device) if device is not None else det


def _conv(x, p: Conv):
    """NHWC x, "SAME" stride-1 convolution in x.dtype, bias added in it.
    The OIHW kernel is made contiguous: the CPU's convolution backward at
    one image a batch (a rank's share of b2) refuses a permuted one."""
    k = p.kernel.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 p.kernel.to(x.dtype).permute(3, 2, 0, 1).contiguous(),
                 padding=k // 2)
    return y.permute(0, 2, 3, 1) + p.bias.to(x.dtype)


def protonet_forward(feat, protonet: ProtoNet):
    """[B, Hm, Wm, C] finest level -> prototype masks [B, Hm, Wm, P] f32."""
    x = feat
    for p in protonet.convs:
        x = F.relu(_conv(x, p))
    return F.relu(_conv(x, protonet.out)).float()


def fcos_head_forward(features, head: FCOSHead, laterals=None):
    """features: list of [B, H, W, C_l] pyramid levels (`laterals`, one 1x1
    conv per level, unify their widths).  Returns per-level (cls_logits
    [B,H,W,K], box [B,H,W,4], ctr [B,H,W,1]), float32, plus the mask
    coefficients [B,H,W,P] (tanh) when the head has a `coef` conv."""
    outs = []
    for lvl, feat in enumerate(features):
        x = feat
        if laterals is not None:
            x = _conv(x, laterals[lvl])
        c = x
        for p in head.cls_tower:
            c = F.relu(_conv(c, p))
        b = x
        for p in head.box_tower:
            b = F.relu(_conv(b, p))
        cls_logits = _conv(c, head.cls).float()
        box = F.relu(_conv(b, head.box).float() * head.scales[lvl])
        ctr = _conv(b, head.ctr).float()
        if hasattr(head, "coef"):
            coef = torch.tanh(_conv(b, head.coef).float())
            outs.append((cls_logits, box, ctr, coef))
        else:
            outs.append((cls_logits, box, ctr))
    return outs


def focal_loss(logits, targets, alpha=0.25, gamma=2.0):
    """Sigmoid focal loss; targets one-hot [..., K] (0 rows = background)."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits)
           + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def iou_loss(pred_ltrb, target_ltrb, eps=1e-7):
    """IoU loss between (l, t, r, b) distance encodings at matched points."""
    pl, pt, pr, pb = pred_ltrb.unbind(-1)
    tl, tt, tr, tb = target_ltrb.unbind(-1)
    p_area = (pl + pr) * (pt + pb)
    t_area = (tl + tr) * (tt + tb)
    iw = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    ih = torch.minimum(pt, tt) + torch.minimum(pb, tb)
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    union = p_area + t_area - inter
    return -torch.log(inter / (union + eps) + eps)


_SIZE_RANGES = ((0, 64), (64, 128), (128, 256), (256, 1e8))


def _fcos_loss_terms(level_maps, strides, gt_boxes, gt_labels,
                     size_ranges=_SIZE_RANGES, protos=None, gt_masks=None,
                     mask_stride=4):
    """Per-image FCOS loss sums, batched: `level_maps` a list of (cls
    [B,H,W,K], box [B,H,W,4], ctr [B,H,W,1]); gt_boxes [B,M,4] xyxy,
    gt_labels [B,M] padded with -1.  -> (cls, box, ctr, n_pos), each [B].
    With the mask coefficients as each level's fourth map, `protos`
    [B,Hm,Wm,P] and `gt_masks` [B,M,Hm,Wm], also (mask, n_mask) of
    `_proto_mask_loss`."""
    with_mask = protos is not None
    rep_scores, rep_best, rep_coefs = [], [], []
    valid_gt = gt_labels >= 0                                   # [B, M]
    areas = torch.where(valid_gt,
                        (gt_boxes[..., 2] - gt_boxes[..., 0])
                        * (gt_boxes[..., 3] - gt_boxes[..., 1]),
                        torch.full_like(gt_boxes[..., 0], 1e9))
    B = gt_boxes.shape[0]
    total = [torch.zeros(B, device=gt_boxes.device) for _ in range(4)]
    for lvl, maps in enumerate(level_maps):
        cls_logits, box, ctr = maps[:3]
        _, H, W, K = cls_logits.shape
        stride = strides[lvl]
        dev = cls_logits.device
        ys = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) * stride
        xs = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) * stride
        py, px = torch.meshgrid(ys, xs, indexing="ij")           # [H, W]
        gb = gt_boxes[:, None, None]                             # [B,1,1,M,4]
        ltrb = torch.stack([px[..., None] - gb[..., 0],
                            py[..., None] - gb[..., 1],
                            gb[..., 2] - px[..., None],
                            gb[..., 3] - py[..., None]], dim=-1)  # [B,H,W,M,4]
        inside = ltrb.amin(dim=-1) > 0
        max_dist = ltrb.amax(dim=-1)
        lo, hi = size_ranges[min(lvl, len(size_ranges) - 1)]
        candidate = inside & (max_dist >= lo) & (max_dist <= hi) \
            & valid_gt[:, None, None, :]
        cand_areas = torch.where(candidate, areas[:, None, None, :],
                                 torch.full_like(max_dist, 1e9))
        best = cand_areas.argmin(dim=-1)                         # [B, H, W]
        is_pos = candidate.gather(-1, best[..., None])[..., 0]
        labels = gt_labels.long().gather(1, best.reshape(B, -1)) \
            .reshape(best.shape)
        tgt_label = torch.where(is_pos, labels, torch.full_like(labels, -1))
        tgt_ltrb = ltrb.gather(
            3, best[..., None, None].expand(-1, -1, -1, 1, 4))[:, :, :, 0]

        fg = tgt_label >= 0
        one_hot = F.one_hot(torch.where(fg, tgt_label,
                                        torch.zeros_like(tgt_label)),
                            K).float() * fg[..., None]
        total[0] = total[0] + focal_loss(cls_logits, one_hot).sum((1, 2, 3))
        lr_ = tgt_ltrb[..., 0::2]
        tb_ = tgt_ltrb[..., 1::2]
        ctr_tgt = torch.sqrt(
            (lr_.amin(-1) / lr_.amax(-1).clamp(min=1e-7)).clamp(min=0)
            * (tb_.amin(-1) / tb_.amax(-1).clamp(min=1e-7)).clamp(min=0))
        pos = is_pos.float()
        total[1] = total[1] + (iou_loss(box / stride, tgt_ltrb / stride)
                               * pos).sum((1, 2))
        ctr_bce = -(ctr_tgt * F.logsigmoid(ctr[..., 0])
                    + (1 - ctr_tgt) * F.logsigmoid(-ctr[..., 0]))
        total[2] = total[2] + (ctr_bce * pos).sum((1, 2))
        total[3] = total[3] + pos.sum((1, 2))
        if with_mask:
            # this level's assignment, flattened for the representative
            rep_scores.append(((ctr_tgt + 1e-6) * pos).reshape(B, -1))
            rep_best.append(best.reshape(B, -1))
            rep_coefs.append(maps[3].reshape(B, H * W, -1))
    if not with_mask:
        return tuple(total)
    return tuple(total) + _proto_mask_loss(
        torch.cat(rep_scores, 1), torch.cat(rep_best, 1),
        torch.cat(rep_coefs, 1), protos, gt_boxes, gt_labels, gt_masks,
        mask_stride)


def _proto_mask_loss(score_flat, best_flat, coef_flat, protos, gt_boxes,
                     gt_labels, gt_masks, mask_stride):
    """The prototype-mask loss of each image, batched (score_flat [B, L],
    best_flat [B, L], coef_flat [B, L, P] over every level's locations).
    Each GT instance takes its highest-centerness positive location (an
    argmax, so no gradient through the choice; the coefficient gather is
    differentiated: that is how the coefficient maps and the protonet
    train), its mask logits are protos @ coef, and the BCE against the GT
    mask is summed inside the GT box on the mask grid and normalised by
    that box's pixel count (YOLACT).  -> (sum over the valid instances
    [B], their number [B])."""
    M = gt_labels.shape[1]
    hm, wm = protos.shape[1:3]
    dev = protos.device
    # [B, L, M] score of each location for each instance
    scores_2d = score_flat[..., None] * (
        best_flat[..., None] == torch.arange(M, device=dev))
    rep_idx = scores_2d.argmax(dim=1)                            # [B, M]
    has_pos = scores_2d.amax(dim=1) > 0
    coef_m = coef_flat.gather(
        1, rep_idx[..., None].expand(-1, -1, coef_flat.shape[-1]))
    logits = torch.einsum("bhwp,bmp->bmhw", protos, coef_m)
    tgt = gt_masks.float()
    bce = -(tgt * F.logsigmoid(logits) + (1 - tgt) * F.logsigmoid(-logits))
    # crop to the GT box on the mask grid
    cy = (torch.arange(hm, device=dev, dtype=torch.float32) + 0.5) \
        * mask_stride
    cx = (torch.arange(wm, device=dev, dtype=torch.float32) + 0.5) \
        * mask_stride
    gb = gt_boxes[..., None, None]                           # [B, M, 4, 1, 1]
    inside = ((cx >= gb[:, :, 0]) & (cx <= gb[:, :, 2])
              & (cy[:, None] >= gb[:, :, 1])
              & (cy[:, None] <= gb[:, :, 3])).float()          # [B, M, Hm, Wm]
    area = inside.sum((2, 3)).clamp(min=1.0)
    per_inst = (bce * inside).sum((2, 3)) / area
    valid = ((gt_labels >= 0) & has_pos).float()
    return (per_inst * valid).sum(1), valid.sum(1)


def _fcos_loss_single(level_maps, strides, gt_boxes, gt_labels,
                      coefs=None, protos=None, gt_masks=None,
                      mask_stride=4):
    """One image's loss sums: `level_maps` (cls [H,W,K], box [H,W,4], ctr
    [H,W,1]); gt [M, 4] / [M] -> (cls, box, ctr, n_pos) scalars; with
    `coefs` (per level [H,W,P]), `protos` [Hm,Wm,P] and `gt_masks`
    [M,Hm,Wm] also (mask, n_mask)."""
    maps = [tuple(m[None] for m in lvl) for lvl in level_maps]
    kw = {}
    if coefs is not None:
        maps = [m + (c[None],) for m, c in zip(maps, coefs)]
        kw = dict(protos=protos[None], gt_masks=gt_masks[None],
                  mask_stride=mask_stride)
    terms = _fcos_loss_terms(maps, strides, gt_boxes[None], gt_labels[None],
                             **kw)
    return tuple(t[0] for t in terms)


def fcos_loss_batch(level_outs, strides, gt_boxes, gt_labels, protos=None,
                    gt_masks=None, mask_stride=4, mask_weight=2.0):
    """Batched FCOS loss: level_outs [B, H, W, *] per level; gt_boxes
    [B, M, 4]; gt_labels [B, M].  Positives normalised over the whole batch
    (FCOS convention; with more than one rank, over the global batch).
    With coefficient maps in `level_outs` plus `protos`
    [B,Hm,Wm,P] and `gt_masks` [B,M,Hm,Wm], adds `mask_loss` =
    mask_weight * the instances' sum / max(their number, 1)."""
    with_mask = protos is not None and len(level_outs[0]) == 4
    terms = _fcos_loss_terms(
        level_outs, tuple(strides), gt_boxes, gt_labels,
        **(dict(protos=protos, gt_masks=gt_masks, mask_stride=mask_stride)
           if with_mask else {}))
    cls_l, box_l, ctr_l, n_pos = terms[:4]
    # over ranks: the global count's share (`loss_normaliser`)
    n_pos = loss_normaliser(n_pos.sum())
    out = {"cls_loss": cls_l.sum() / n_pos,
           "box_loss": box_l.sum() / n_pos,
           "ctr_loss": ctr_l.sum() / n_pos}
    out["total"] = out["cls_loss"] + out["box_loss"] + out["ctr_loss"]
    if with_mask:
        mask_l, n_mask = terms[4:]
        out["mask_loss"] = (mask_weight * mask_l.sum()
                            / loss_normaliser(n_mask.sum()))
        out["total"] = out["total"] + out["mask_loss"]
    return out


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def decode_detections(level_outs, strides, score_thresh=0.05, top_k=100,
                      protos=None, mask_stride=4, mask_thresh=0.5):
    """Decode per-level maps ([1, H, W, *] each, tensors or arrays) to
    (boxes [N,4], scores [N], labels [N]) on the host (numpy) with greedy
    NMS.  When the maps carry mask coefficients and `protos` [1, Hm, Wm, P]
    is given, also boolean instance masks [N, Hm, Wm]: sigmoid(protos @
    coef) > mask_thresh, cropped to the kept box."""
    with_mask = protos is not None and len(level_outs[0]) == 4
    boxes, scores, labels, coef_rows = [], [], [], []
    for lvl, maps in enumerate(level_outs):
        cls_logits, box, ctr = maps[0], maps[1], maps[2]
        stride = strides[lvl]
        cls_p = _sigmoid(_numpy(cls_logits))[0]
        ctr_p = _sigmoid(_numpy(ctr))[0, ..., 0]
        box_np = _numpy(box)[0]
        coef_np = _numpy(maps[3])[0] if with_mask else None
        H, W, K = cls_p.shape
        ys = (np.arange(H) + 0.5) * stride
        xs = (np.arange(W) + 0.5) * stride
        py, px = np.meshgrid(ys, xs, indexing="ij")
        score = cls_p * ctr_p[..., None]
        hh, ww, kk = np.nonzero(score > score_thresh)
        for y, x, k in zip(hh, ww, kk):
            l, t, r, b = box_np[y, x]
            boxes.append([px[y, x] - l, py[y, x] - t,
                          px[y, x] + r, py[y, x] + b])
            scores.append(score[y, x, k])
            labels.append(k)
            if with_mask:
                coef_rows.append(coef_np[y, x])
    if not boxes:
        empty = (np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,), int))
        if with_mask:
            return empty + (np.zeros((0,) + tuple(protos.shape[1:3]), bool),)
        return empty
    boxes = np.asarray(boxes)
    scores = np.asarray(scores)
    labels = np.asarray(labels, int)
    order = np.argsort(-scores)[:top_k * 4]
    boxes, scores, labels = boxes[order], scores[order], labels[order]
    keep = nms(boxes, scores, iou_thresh=0.6)[:top_k]
    if not with_mask:
        return boxes[keep], scores[keep], labels[keep]
    coef = np.asarray(coef_rows)[order][keep]                  # [N, P]
    proto_np = _numpy(protos)[0]                               # [Hm, Wm, P]
    logits = np.einsum("hwp,np->nhw", proto_np, coef)
    masks = 1.0 / (1.0 + np.exp(-logits)) > mask_thresh
    hm, wm = proto_np.shape[:2]
    cy = (np.arange(hm) + 0.5) * mask_stride
    cx = (np.arange(wm) + 0.5) * mask_stride
    kept_boxes = boxes[keep]
    inside = ((cx[None, None, :] >= kept_boxes[:, 0, None, None])
              & (cx[None, None, :] <= kept_boxes[:, 2, None, None])
              & (cy[None, :, None] >= kept_boxes[:, 1, None, None])
              & (cy[None, :, None] <= kept_boxes[:, 3, None, None]))
    return kept_boxes, scores[keep], labels[keep], masks & inside


def nms(boxes, scores, iou_thresh=0.5):
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) \
            * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / (a_i + a_r - inter + 1e-9)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, int)


def box_iou_matrix(a, b):
    """IoU between box sets a [N,4], b [M,4] (xyxy), numpy."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def mask_iou(a, b):
    """IoU between two boolean masks of the same shape."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 0.0


class DetectionAP:
    """Mean average precision at an IoU threshold (VOC-style, all-point
    interpolation over 101 recall points), on boxes, or with
    `use_masks=True` on instance-mask IoU (`add_image` then takes
    `pred_masks` / `gt_masks` on a shared mask grid)."""

    def __init__(self, n_classes, iou_thresh=0.5, use_masks=False):
        self.n_classes = n_classes
        self.iou_thresh = iou_thresh
        self.use_masks = use_masks
        self.preds = []   # (image_id, label, score, box_or_mask)
        self.gts = []     # (image_id, label, box_or_mask)

    def add_image(self, image_id, pred_boxes, pred_scores, pred_labels,
                  gt_boxes, gt_labels, pred_masks=None, gt_masks=None):
        pred_geo = pred_masks if self.use_masks else pred_boxes
        gt_geo = gt_masks if self.use_masks else gt_boxes
        for g, s, l in zip(pred_geo, pred_scores, pred_labels):
            self.preds.append((image_id, int(l), float(s), np.asarray(g)))
        for g, l in zip(gt_geo, gt_labels):
            if int(l) >= 0:
                self.gts.append((image_id, int(l), np.asarray(g)))

    def _iou(self, a, b):
        if self.use_masks:
            return mask_iou(a, b)
        return float(box_iou_matrix(a[None], b[None])[0, 0])

    def mean_ap(self):
        aps = []
        for c in range(self.n_classes):
            gts_c = [(i, b) for (i, l, b) in self.gts if l == c]
            preds_c = sorted([(i, s, b) for (i, l, s, b) in self.preds
                              if l == c], key=lambda t: -t[1])
            if not gts_c:
                continue
            matched = set()
            tp = np.zeros(len(preds_c))
            fp = np.zeros(len(preds_c))
            for k, (img, _, box) in enumerate(preds_c):
                cands = [(j, g) for j, (gi, g) in enumerate(gts_c)
                         if gi == img and j not in matched]
                best_iou, best_j = 0.0, -1
                for j, g in cands:
                    iou = self._iou(box, g)
                    if iou > best_iou:
                        best_iou, best_j = iou, j
                if best_iou >= self.iou_thresh:
                    tp[k] = 1
                    matched.add(best_j)
                else:
                    fp[k] = 1
            tp_cum = np.cumsum(tp)
            fp_cum = np.cumsum(fp)
            recall = tp_cum / len(gts_c)
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            # all-point interpolation
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                p = precision[recall >= r].max() if (recall >= r).any() else 0
                ap += p / 101
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


def default_strides(swin_cfg: SwinConfig):
    """One pyramid level per Swin stage: patch stride 4, doubling per merge."""
    return tuple(4 * 2 ** i for i in range(len(swin_cfg.depths)))


def detector_forward(model: Detector, images, swin_cfg: SwinConfig):
    """NHWC images -> per-level FCOS maps (float32)."""
    return detector_outputs(model, images, swin_cfg)[0]


def detector_outputs(model: Detector, images, swin_cfg: SwinConfig):
    """NHWC images -> (per-level FCOS maps, prototype masks [B,Hm,Wm,P] or
    None): the protonet reads the finest lateral-projected level."""
    feats = swin_features(model.backbone, images, swin_cfg)
    outs = fcos_head_forward(feats, model.head, model.laterals)
    protos = None
    if model.protonet is not None:
        protos = protonet_forward(_conv(feats[0], model.laterals[0]),
                                  model.protonet)
    return outs, protos


def detection_optimizer(model: nn.Module, lr: float,
                        weight_decay: float) -> Optimizer:
    """optax.adamw(lr, weight_decay) over every trainable tensor: no decay
    mask (the segdet recipe decays biases and level scales too), no clip."""
    params = [p for p in model.parameters() if p.requires_grad]
    return Optimizer(torch.optim.AdamW(
        [{"params": params, "weight_decay": weight_decay, "decay": True}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8), None)


def make_detection_train_step(swin_cfg: SwinConfig, optimizer: Optimizer,
                              strides=None, with_mask=False):
    """The detection train step: APLA-Swin backbone -> lateral 1x1s -> FCOS
    head -> batched FCOS loss -> one optimizer update of the trainable
    tensors.  `step(model, batch)` takes batch = {"image" [B,H,W,3],
    "boxes" [B,M,4] (padded rows), "labels" [B,M] (-1 padding), + "masks"
    [B,M,Hm,Wm] when `with_mask`} on the model's device and returns the
    loss terms and `grad_norm` (optax's global_norm of the gradients).
    `with_mask` adds the prototype-mask loss (the model's protonet reads
    the finest lateral-projected level; the mask grid's stride is the
    finest level's)."""
    strides = tuple(strides) if strides else default_strides(swin_cfg)

    def step(model: Detector, batch):
        outs, protos = detector_outputs(model, batch["image"], swin_cfg)
        losses = fcos_loss_batch(
            outs, strides, batch["boxes"], batch["labels"],
            protos=protos if with_mask else None,
            gt_masks=batch.get("masks") if with_mask else None,
            mask_stride=strides[0])
        optimizer.opt.zero_grad(set_to_none=True)
        losses["total"].backward()
        reduce_gradients(optimizer.params)
        g_norm = global_norm([p.grad for p in optimizer.params])
        optimizer.step(g_norm)
        metrics = {k: pmean(v.detach()) for k, v in losses.items()}
        metrics["grad_norm"] = g_norm.detach()
        return metrics

    return step
