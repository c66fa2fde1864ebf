"""The port's `ClassificationMetrics` (numpy/scipy) against the JAX
package's (sklearn).

Random logits and labels, in several batches, through both classes: the
rounded values must be equal up to one unit of their 3-decimal rounding
(the two compute in different orders, so a value on a rounding boundary may
round either way); the unrounded kappa, recall and ROC-AUC against
sklearn's functions to 1e-9.  Cases: all classes present, a class missing
(sklearn refuses the ROC-AUC and both report 0.5), two classes (plain
AUC), and predictions concentrated on a few classes (kappa over the
labels present in either).
"""

import numpy as np
import pytest
from sklearn import metrics as skm

from apla_tpu.train.metrics import ClassificationMetrics as JaxMetrics
from apla_tpu_torch.train import metrics as tm


def _cases():
    rng = np.random.default_rng(0)
    out = {}
    labels = rng.integers(0, 7, 120)
    out["all_present"] = (7, rng.standard_normal((120, 7)) * 2
                          + 2 * np.eye(7)[labels], labels)
    labels = rng.integers(0, 6, 90)          # class 6 of 7 never true
    out["class_missing"] = (7, rng.standard_normal((90, 7)), labels)
    labels = rng.integers(0, 2, 80)
    out["binary"] = (2, rng.standard_normal((80, 2)) + np.eye(2)[labels],
                     labels)
    labels = rng.integers(0, 5, 100)
    logits = rng.standard_normal((100, 5))
    logits[:, 1] += 3.0                      # mostly one predicted class
    out["skewed"] = (5, logits, labels)
    return out


@pytest.mark.parametrize("case", list(_cases()))
def test_metrics_match_jax(case):
    n_classes, logits, labels = _cases()[case]
    ours = tm.ClassificationMetrics(n_classes, mode="val")
    ref = JaxMetrics(n_classes, mode="val")
    for sl in (slice(0, 50), slice(50, None)):
        ours.add_preds(logits[sl], labels[sl])
        ref.add_preds(logits[sl], labels[sl])
    got, want = ours.get_values(), ref.get_values()
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 + 1e-9, (k, got[k], want[k])
    if case == "class_missing":
        assert got["val_roc_auc"] == want["val_roc_auc"] == 0.5
    assert ours.truths == [] and ours.predictions == []     # reset


@pytest.mark.parametrize("case", list(_cases()))
def test_metric_functions_match_sklearn(case):
    n_classes, logits, labels = _cases()[case]
    probs = tm.softmax_np(logits.astype(np.float32))
    preds = probs.argmax(1)
    assert abs(tm.quadratic_kappa(labels, preds) - skm.cohen_kappa_score(
        labels, preds, weights="quadratic")) < 1e-9
    assert abs(tm.macro_recall(labels, preds) - skm.recall_score(
        labels, preds, average="macro", zero_division=0)) < 1e-9
    if case == "binary":
        want = skm.roc_auc_score(labels, probs[:, -1])
        got = tm.binary_auc(labels == 1, probs[:, -1])
    elif case == "class_missing":
        with pytest.raises(ValueError):
            skm.roc_auc_score(labels, probs, multi_class="ovo")
        with pytest.raises(ValueError):
            tm.roc_auc_ovo(labels, probs)
        return
    else:
        want = skm.roc_auc_score(labels, probs, average="macro",
                                 multi_class="ovo")
        got = tm.roc_auc_ovo(labels, probs)
    assert abs(got - want) < 1e-9


def test_binary_auc_counts_ties_as_half():
    assert tm.binary_auc([True, False, True, False],
                         [0.5, 0.5, 0.9, 0.1]) == pytest.approx(0.875)
    with pytest.raises(ValueError):
        tm.binary_auc([True, True], [0.1, 0.2])
