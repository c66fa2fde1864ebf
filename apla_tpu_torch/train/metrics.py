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

`MultiLabelClassificationMetrics` (and `mean_roc_auc`) reproduce the JAX
class's sklearn 1.9 calls in numpy, branch for branch: the macro average
precision (each label's uninterpolated AP over its distinct thresholds; 0
for a label never true; 0.0 where sklearn raises, as for truths outside
{0, 1}), each label's ROC-AUC weighted by t^2 + 1e-6 on the trapezoidal
curve sklearn draws (0.5 for a label never true or where sklearn raises, nan
where it has no negatives, as sklearn returns there), subset accuracy, and
macro precision / recall / F1 over `labels` with zero_division 0; a single
label column is sklearn's binary case (its metrics then count label 0).
"""

from __future__ import annotations

import itertools

import numpy as np
from scipy.integrate import trapezoid
from scipy.stats import rankdata

from ..utils.config import EDict


def softmax_np(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def sigmoid_np(x):
    return 1.0 / (1.0 + np.exp(-x))


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


# ------------------------------------------------------------------ #
# multi-label
# ------------------------------------------------------------------ #

def target_type(y) -> str:
    """sklearn's `type_of_target` for the label arrays these metrics see:
    with two or more columns 'multilabel-indicator' (at most two distinct
    integral values, whichever they are), 'multiclass-multioutput' or
    'continuous-multioutput'; else 'binary', 'multiclass' or 'continuous'
    of the values."""
    y = np.asarray(y)
    vals = np.unique(y)
    integral = not (y.dtype.kind == "f" and np.any(vals != vals.astype(int)))
    if y.ndim == 2 and y.shape[1] > 1:
        if not integral:
            return "continuous-multioutput"
        return ("multilabel-indicator" if vals.size < 3
                else "multiclass-multioutput")
    if not integral:
        return "continuous"
    return "binary" if vals.size <= 2 else "multiclass"


def _curve_points(y, score, weight=None):
    """sklearn's `confusion_matrix_at_thresholds`: (fps, tps) at each
    distinct score, descending (y: 0/1)."""
    score = np.asarray(score).reshape(-1)
    if not (np.isfinite(score).all() and np.isfinite(y).all()):
        raise ValueError("Input contains NaN or infinity")
    if weight is not None:
        keep = weight != 0
        y, score, weight = y[keep], score[keep], weight[keep]
    order = np.argsort(-score, kind="stable")
    score, y = score[order], y[order].astype(np.float64)
    w = 1.0 if weight is None else weight[order]
    idx = np.concatenate([np.nonzero(np.diff(score))[0], [y.size - 1]])
    tps = np.cumsum(y * w, dtype=np.float64)[idx]
    fps = (np.cumsum((1 - y) * w, dtype=np.float64)[idx]
           if weight is not None else 1 + idx.astype(np.float64) - tps)
    return fps, tps


def average_precision(y, score) -> float:
    """sklearn's uninterpolated AP of one 0/1 label column (0 when no
    label is 1)."""
    fps, tps = _curve_points(np.asarray(y), score)
    precision = tps / (tps + fps)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def macro_average_precision(truths, scores) -> float:
    """average_precision_score(truths, scores, average='macro');
    ValueError where sklearn raises."""
    truths, scores = np.asarray(truths), np.asarray(scores)
    kind = target_type(truths)
    if kind == "binary":
        present = np.unique(truths)
        if present.size == 2 and 1 not in present:
            raise ValueError("pos_label=1 is not a valid label")
        return average_precision(truths.reshape(-1) == 1, scores)
    if kind != "multilabel-indicator":
        raise ValueError(f"{kind} format is not supported")
    return float(np.mean([average_precision(truths[:, c] == 1, scores[:, c])
                          for c in range(scores.shape[1])]))


def weighted_roc_auc(y, score, weight) -> float:
    """sklearn's binary roc_auc_score with sample weights (y: 0/1): the
    trapezoid under its ROC curve, collinear points dropped; nan with one
    class only."""
    if np.unique(y).size != 2:
        return float("nan")
    fps, tps = _curve_points(y, score, weight)
    if fps.size > 2:
        keep = np.nonzero(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
             [True]]))[0]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.concatenate([[0.0], fps]), np.concatenate([[0.0], tps])
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return float(trapezoid(tpr, fpr))


def mean_roc_auc(truths, predictions) -> float:
    """Per-label ROC-AUC averaged over the labels (the JAX package's
    `mean_roc_auc`): label c's targets (t + t^2) / 2, weights t^2 + 1e-6;
    0.5 for a label with no positive or where sklearn raises."""
    truths = np.asarray(truths, dtype=np.float64)
    predictions = np.asarray(predictions, dtype=np.float64)
    n_classes = predictions.shape[-1]
    total = 0.0
    for c in range(n_classes):
        auc = 0.5
        tar = (truths[:, c] + truths[:, c] ** 2) / 2
        if tar.sum() > 0 and target_type(tar) == "binary" \
                and np.isfinite(predictions[:, c]).all():
            # sklearn binarizes on the larger value; a single value -> 0s
            values = np.unique(tar)
            y = tar == values[-1] if values.size == 2 else np.zeros_like(tar)
            auc = weighted_roc_auc(y.astype(np.int64), predictions[:, c],
                                   truths[:, c] ** 2 + 1e-06)
        total += auc
    return total / n_classes


def _check_targets(truths, preds) -> str:
    """The common target type of truths and predictions, as sklearn's
    `_check_targets` settles it; ValueError on a mix or an unsupported
    type."""
    kinds = {target_type(truths), target_type(preds)}
    if kinds == {"binary", "multiclass"}:
        kinds = {"multiclass"}
    if len(kinds) > 1:
        raise ValueError(f"can't handle a mix of {sorted(kinds)} targets")
    kind = kinds.pop()
    if kind not in ("binary", "multiclass", "multilabel-indicator"):
        raise ValueError(f"{kind} is not supported")
    return kind


def _set_wise_counts(truths, preds, labels):
    """(tp, predicted, true) counts per label, as sklearn's
    multilabel_confusion_matrix: the nonzero entries of a multi-label
    indicator's columns, the label values of a single column."""
    if _check_targets(truths, preds) == "multilabel-indicator":
        t, p = truths[:, labels], preds[:, labels]
        return (np.count_nonzero(t * p, axis=0), np.count_nonzero(p, axis=0),
                np.count_nonzero(t, axis=0))
    t = truths.reshape(-1)[:, None] == labels[None]
    p = preds.reshape(-1)[:, None] == labels[None]
    return (t & p).sum(0), p.sum(0), t.sum(0)


def _divide(num, den):
    """num / den, 0 where den is 0 (zero_division=0)."""
    den = np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def subset_accuracy(truths, preds) -> float:
    """sklearn's accuracy_score: the share of rows whose labels are all
    right (ValueError on mixed targets)."""
    if _check_targets(truths, preds) == "multilabel-indicator":
        return float(np.mean((truths == preds).all(axis=1)))
    return float(np.mean(truths.reshape(-1) == preds.reshape(-1)))


class MultiLabelClassificationMetrics:
    """mAP / precision / recall / f1 / accuracy / roc_auc for multi-label
    targets, with the JAX class's keys and rounding."""

    def __init__(self, n_classes, act_threshold=0.5, mode=""):
        self.n_classes = n_classes
        self.prefix = mode + "_" if mode else ""
        self.act_threshold = act_threshold
        self.labels = np.arange(n_classes)
        self.reset()

    def reset(self):
        self.truths = []
        self.predictions = []

    def add_preds(self, logits, truths, using_knn=False):
        """Logits (sigmoid applied here) or, `using_knn`, scores already
        in [0, 1]."""
        probs = logits if using_knn else sigmoid_np(
            np.asarray(logits, dtype=np.float32))
        self.truths += np.asarray(truths).astype(int).tolist()
        self.predictions += np.asarray(probs).tolist()

    def get_values(self, do_reset=True):
        truths = np.array(self.truths)
        predictions = np.array(self.predictions)
        try:
            m_ap = macro_average_precision(truths, predictions)
        except ValueError:
            m_ap = 0.0
        roc_auc = mean_roc_auc(truths, predictions)
        binary = (predictions > self.act_threshold).astype(int)
        accuracy = subset_accuracy(truths, binary)
        tp, pred_sum, true_sum = _set_wise_counts(truths, binary,
                                                  self.labels)
        precision = float(np.mean(_divide(tp, pred_sum)))
        recall = float(np.mean(_divide(tp, true_sum)))
        f1 = float(np.mean(_divide(2 * tp, true_sum + pred_sum)))
        if do_reset:
            self.reset()
        return EDict({
            self.prefix + "accuracy": round(accuracy, 3),
            self.prefix + "mAP": round(float(m_ap), 3),
            self.prefix + "precision": round(precision, 3),
            self.prefix + "recall": round(recall, 3),
            self.prefix + "f1": round(f1, 3),
            self.prefix + "roc_auc": round(float(roc_auc), 3),
        })
