"""The port's kNN evaluation (`apla_tpu_torch/train/knn.py`) against the JAX
package's (`apla_tpu/train/knn.py`).

Features are numpy draws from a seed, L2-normalised, with labels drawn over
the classes.  Tolerance: float32 on both sides, the similarities the same
dot products in another sum order, so the top-k neighbours are the same
set and the votes agree to 1e-5 relative (the exp(sim / 0.07) weights
amplify a sim difference of ~1e-7 by ~15x).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.train import knn as jknn
from apla_tpu_torch.train import knn as tknn


def _bank(seed, n=60, b=9, d=16, classes=5):
    rng = np.random.default_rng(seed)

    def unit(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return unit((b, d)), unit((n, d)), rng.integers(0, classes, n)


@pytest.mark.parametrize("knn_k,knn_t", [(1, 0.07), (7, 0.07), (60, 0.1)])
def test_knn_predict_matches_jax(knn_k, knn_t):
    feat, bank, labels = _bank(knn_k)
    want = jknn.knn_predict(jnp.asarray(feat), jnp.asarray(bank),
                            jnp.asarray(labels), knn_k, knn_t, 5)
    got = tknn.knn_predict(torch.from_numpy(feat), torch.from_numpy(bank),
                           torch.from_numpy(labels), knn_k, knn_t, 5)
    assert got.shape == (9, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_knn_predict_multilabel_matches_jax():
    feat, bank, _ = _bank(3)
    labels = (np.random.default_rng(4).uniform(size=(60, 6)) < 0.3).astype(
        np.float32)
    want = jknn.knn_predict_multilabel(jnp.asarray(feat), jnp.asarray(bank),
                                       jnp.asarray(labels), 11, 0.07)
    got = tknn.knn_predict_multilabel(torch.from_numpy(feat),
                                      torch.from_numpy(bank),
                                      torch.from_numpy(labels), 11, 0.07)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_feature_bank_and_knn_evaluate():
    """The bank of a loader is what the JAX package builds from it, and
    `knn_evaluate` feeds the vote's probabilities to the metric."""
    feat, bank, labels = _bank(5, n=20, b=6)
    loader = [{"image": bank[i:i + 8], "label": labels[i:i + 8]}
              for i in range(0, 20, 8)]
    w_feats, w_labels = jknn.build_feature_bank(
        lambda t, f, x: x, None, None,
        [{k: np.asarray(v) for k, v in b.items()} for b in loader])
    t_loader = [{"image": torch.from_numpy(b["image"]),
                 "label": torch.from_numpy(b["label"])} for b in loader]
    g_feats, g_labels = tknn.build_feature_bank(lambda x: x, t_loader, "cpu")
    np.testing.assert_array_equal(g_feats.numpy(), w_feats)
    np.testing.assert_array_equal(g_labels, w_labels)

    class Metric:
        def __init__(self):
            self.preds = []

        def add_preds(self, scores, labels):
            self.preds.append((scores, labels))

        def get_values(self):
            return {"n": sum(len(lab) for _, lab in self.preds)}

    metric = Metric()
    queries = [{"image": torch.from_numpy(feat),
                "label": torch.zeros(6, dtype=torch.int64)}]
    assert tknn.knn_evaluate(lambda x: x, t_loader, queries, metric, 5, 200,
                             0.07, "cpu") == {"n": 6}
    want = jknn.knn_predict(jnp.asarray(feat), jnp.asarray(w_feats),
                            jnp.asarray(w_labels), 20, 0.07, 5)
    np.testing.assert_allclose(metric.preds[0][0], np.asarray(want),
                               rtol=1e-5, atol=1e-6)
