"""Host-side classification metrics, in numpy and scipy.

Counterpart of `apla_tpu/train/metrics.py:ClassificationMetrics`, with the
same key names and rounding.  The JAX package takes the values from
sklearn, which the card's machine lacks; here they come from the confusion
matrix, reproducing sklearn's definitions:

- accuracy; mean-per-class accuracy over every class (0 for an absent one);
- quadratic Cohen kappa over the labels present in truths or predictions,
  weighted by squared label-index distance (nan when undefined);
- macro recall over the labels present in truths or predictions
  (0 for a label never true);
- ROC-AUC: binary AUC with two classes, else sklearn's
  `multi_class="ovo"` macro average (Hand & Till) over the pairs of
  classes, each pair's AUCs from average ranks (`scipy.stats.rankdata`).
  Where sklearn raises (a class missing from the truths, a single class)
  the JAX package reports 0.5, and so does this.

The multi-label metrics come with multi-label datasets (ROADMAP queue A).
"""

from __future__ import annotations

import itertools

import numpy as np
from scipy.stats import rankdata

from ..utils.config import EDict


def softmax_np(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def binary_auc(truth, score) -> float:
    """AUC of `score` for the positive class `truth` (bool), ties counted
    one half (the trapezoidal ROC area); ValueError with one class only."""
    truth = np.asarray(truth, dtype=bool)
    n_pos = int(truth.sum())
    n_neg = truth.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("only one class present")
    ranks = rankdata(np.asarray(score, dtype=np.float64))
    return float((ranks[truth].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def roc_auc_ovo(truths, probs) -> float:
    """sklearn's roc_auc_score(truths, probs, multi_class='ovo',
    average='macro'); ValueError where sklearn raises."""
    truths = np.asarray(truths)
    probs = np.asarray(probs, dtype=np.float64)
    classes = np.unique(truths)
    if classes.size < 3 or classes.size != probs.shape[1]:
        raise ValueError("classes of the truths and score columns differ")
    if not np.allclose(1, probs.sum(axis=1)):
        raise ValueError("scores are not probabilities")
    scores = []
    for a, b in itertools.combinations(range(classes.size), 2):
        a_mask, b_mask = truths == classes[a], truths == classes[b]
        ab = a_mask | b_mask
        scores.append((binary_auc(a_mask[ab], probs[ab, a])
                       + binary_auc(b_mask[ab], probs[ab, b])) / 2)
    return float(np.mean(scores))


def quadratic_kappa(truths, preds) -> float:
    labels = np.unique(np.concatenate([truths, preds]))
    n = labels.size
    cm = np.zeros((n, n))
    np.add.at(cm, (np.searchsorted(labels, truths),
                   np.searchsorted(labels, preds)), 1)
    expected = np.outer(cm.sum(axis=1), cm.sum(axis=0)) / cm.sum()
    w = (np.arange(n)[:, None] - np.arange(n)[None, :]) ** 2.0
    den = np.sum(w * expected)
    return float("nan") if den == 0 else float(1 - np.sum(w * cm) / den)


def macro_recall(truths, preds) -> float:
    labels = np.unique(np.concatenate([truths, preds]))
    recalls = []
    for c in labels:
        true_c = truths == c
        n = int(true_c.sum())
        recalls.append(float((preds[true_c] == c).sum()) / n if n else 0.0)
    return float(np.mean(recalls))


class ClassificationMetrics:
    """Accuracy, mean-per-class accuracy, quadratic kappa, ROC-AUC, recall
    over predictions accumulated batch by batch."""

    def __init__(self, n_classes, mode="", raw=True):
        self.n_classes = n_classes
        self.prefix = mode + "_" if mode else ""
        self.raw = raw
        self.reset()

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))
        self.truths = []
        self.predictions = []
        self.roc_preds = []

    def add_preds(self, logits, truths):
        logits = np.asarray(logits, dtype=np.float32)
        truths = np.asarray(truths).reshape(-1).astype(np.int64)
        probs = softmax_np(logits) if self.raw else logits
        if self.n_classes == 2:
            self.roc_preds.extend(probs[:, -1])
        else:
            self.roc_preds.extend(probs)
        preds = probs.argmax(axis=1)
        self.predictions.extend(preds)
        self.truths.extend(truths)
        np.add.at(self.confusion_matrix, (truths, preds), 1)

    @staticmethod
    def calc_mean_per_class_acc(confusion_matrix):
        with np.errstate(divide="ignore", invalid="ignore"):
            divided = confusion_matrix.diagonal() / confusion_matrix.sum(
                axis=1)
        return float(np.mean(np.nan_to_num(divided, nan=0.0, posinf=0.0)))

    def get_values(self, do_reset=True, return_conf_matrix=False):
        truths = np.asarray(self.truths, dtype=np.int64)
        preds = np.asarray(self.predictions, dtype=np.int64)
        roc_preds = np.asarray(self.roc_preds)
        accuracy = float(np.mean(truths == preds))
        mpca = self.calc_mean_per_class_acc(self.confusion_matrix)
        kappa = quadratic_kappa(truths, preds) if self.n_classes > 2 else 0.0
        recall = macro_recall(truths, preds)
        try:
            roc_auc = binary_auc(truths == truths.max(), roc_preds) \
                if self.n_classes == 2 else roc_auc_ovo(truths, roc_preds)
        except ValueError:
            roc_auc = 0.5
        cm = self.confusion_matrix.copy() if do_reset \
            else self.confusion_matrix
        if do_reset:
            self.reset()
        results = EDict({
            self.prefix + "accuracy": round(accuracy, 3),
            self.prefix + "mean_per_class_accuracy": round(mpca, 3),
            self.prefix + "quadratic_kappa": round(kappa, 3),
            self.prefix + "roc_auc": round(float(roc_auc), 3),
            self.prefix + "recall": round(recall, 3),
        })
        if return_conf_matrix:
            results["confusion_matrix"] = cm
        return results
