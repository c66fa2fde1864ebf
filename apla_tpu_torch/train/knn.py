"""kNN evaluation: feature bank + temperature-weighted cosine-similarity
vote.

Counterpart of `apla_tpu/train/knn.py`: similarities to the bank, the top
`knn_k` neighbours (`torch.topk`), weights exp(sim / T), and a one-hot
weighted vote (multi-class) or a weighted mean of the neighbours' label
vectors (multi-label).  Features come L2-normalised.  Data parallel (a
loader sharded over ranks, whose batches carry 'valid'): the feature bank
and its labels, and each query batch's scores and labels, are gathered in
global order on every rank, so every rank holds the 1-device run's bank
and metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import gather_rows


def knn_predict(feature, feature_bank, feature_labels, knn_k: int,
                knn_t: float, classes: int):
    """feature [B, D], feature_bank [N, D], feature_labels [N] int ->
    class probabilities [B, classes] f32."""
    sim = torch.matmul(feature.float(), feature_bank.float().t())
    sim_weight, sim_idx = torch.topk(sim, knn_k, dim=-1)
    sim_labels = feature_labels.long()[sim_idx]                  # [B, k]
    one_hot = torch.nn.functional.one_hot(sim_labels, classes).float()
    scores = (one_hot * torch.exp(sim_weight / knn_t)[..., None]).sum(dim=1)
    return scores / scores.sum(dim=1, keepdim=True)


def knn_predict_multilabel(feature, feature_bank, feature_labels,
                           knn_k: int, knn_t: float):
    """feature_labels [N, C] float -> the weighted mean of the neighbours'
    label vectors [B, C]."""
    sim = torch.matmul(feature.float(), feature_bank.float().t())
    sim_weight, sim_idx = torch.topk(sim, knn_k, dim=-1)
    w = torch.exp(sim_weight / knn_t)
    w = w / w.sum(dim=1, keepdim=True)
    return (w[..., None] * feature_labels.float()[sim_idx]).sum(dim=1)


@torch.no_grad()
def build_feature_bank(embed_fn, loader, device):
    """Runs `embed_fn` (images on `device` -> L2-normalised [n, D]) over a
    loader: (features [N, D] f32 on `device`, labels [N] numpy)."""
    feats, labels = [], []
    for batch in loader:
        f = embed_fn(batch["image"].to(device)).float()
        lab = batch["label"]
        if "valid" in batch:
            f, lab = gather_rows(batch["valid"], f, lab)
        feats.append(f)
        labels.append(np.asarray(lab))
    return torch.cat(feats), np.concatenate(labels)


@torch.no_grad()
def knn_evaluate(embed_fn, fbank_loader, loader, metric, n_classes: int,
                 knn_nhood: int, knn_t: float, device) -> dict:
    """kNN metrics of `loader` against the feature bank of `fbank_loader`:
    `embed_fn` maps device images to L2-normalised embeddings, `metric` is
    a fresh metric of the set's kind; the vote uses the min(knn_nhood,
    bank size) nearest neighbours.  Integer labels vote for classes (the
    metric then takes probabilities, `raw = False`); label vectors (a
    multi-label set) give each image the weighted mean of its neighbours'
    vectors (`add_preds(..., using_knn=True)`)."""
    feats, labels = build_feature_bank(embed_fn, fbank_loader, device)
    bank_labels = torch.as_tensor(labels, device=device)
    knn_k = min(knn_nhood, len(labels))
    multilabel = labels.ndim == 2
    if not multilabel:
        metric.raw = False
    for batch in loader:
        emb = embed_fn(batch["image"].to(device))
        truth = batch["label"]
        if multilabel:
            scores = knn_predict_multilabel(emb, feats, bank_labels, knn_k,
                                            knn_t)
        else:
            scores = knn_predict(emb, feats, bank_labels, knn_k, knn_t,
                                 n_classes)
        if "valid" in batch:
            scores, truth = gather_rows(batch["valid"], scores, truth)
        metric.add_preds(scores.cpu().numpy(), np.asarray(truth),
                         **({"using_knn": True} if multilabel else {}))
    return metric.get_values()
