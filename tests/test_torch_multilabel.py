"""The port's multi-label path and LAMB against the JAX package's.

- `MultiLabelClassificationMetrics.get_values()` dict for dict against the
  JAX class (sklearn 1.9 underneath) on seeded cases: logits and kNN
  scores, tied scores, a label never true, a label always true, truths in
  {-1, 0, 1} and {-1, 1}, one label column, a NaN score; and
  `mean_roc_auc` alone.
- `SyntheticMultiLabel`'s records, the binary head's `n_classes = 1`, the
  criterion and the metric class, as the JAX wrapper sets them.
- `params/synthetic/vit_tiny/apla.yml` on `SyntheticMultiLabel` through
  both trainers from the same initial weights, f32: each logged step's
  loss and gradient norm within 1e-4, the validation metrics within 2e-3,
  the log record's keys (`utils.profiling`'s step times) the JAX ones.
- Multi-label kNN in the supervised and the BYOL trainer, against the JAX
  vote and metric on the port's own embeddings.
- `build_optimizer("LAMB", ...)` over 5 steps against optax.lamb at the
  APLA classifier's leaf split (the blocks' tensors stacked into one JAX
  leaf each), with the global-norm clip, the decay mask and a zero-norm
  leaf: float32, rtol 1e-5, atol 1e-6.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.train import metrics as jmetrics
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.train import metrics as tmetrics
from apla_tpu_torch.utils import profiling as tprof

PARAMS = os.path.join(os.path.dirname(__file__), "..", "params", "synthetic",
                      "vit_tiny", "apla.yml")
BYOL = os.path.join(os.path.dirname(__file__), "..", "params", "synthetic",
                    "vit_tiny", "byol.yml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ #
# metrics
# ------------------------------------------------------------------ #

def _case(rng, kind):
    n, c = int(rng.integers(2, 40)), int(rng.integers(2, 7))
    truths = (rng.random((n, c)) < rng.uniform(0.1, 0.9)).astype(int)
    logits = rng.standard_normal((n, c)).astype(np.float32) * 2
    knn = False
    if kind == "ties":
        logits = np.round(logits)
    elif kind == "knn":
        knn, logits = True, rng.integers(0, 5, (n, c)) / 4
    elif kind == "no_positive":
        truths[:, 0] = 0
    elif kind == "no_negative":
        truths[:, -1] = 1
    elif kind == "all_one_value":
        truths[:] = rng.integers(0, 2)
    elif kind == "uncertain":
        truths[rng.integers(0, n, 2)] = -1
    elif kind == "plus_minus":
        truths = truths * 2 - 1
    elif kind == "one_column":
        truths, logits = truths[:, :1], logits[:, :1]
    elif kind == "nan_score":
        logits[rng.integers(0, n), 0] = np.nan
    return truths, logits, knn


def _values(cls, n_classes, truths, logits, knn):
    m = cls(n_classes, mode="val")
    for lo in range(0, len(truths), 8):
        m.add_preds(logits[lo:lo + 8], truths[lo:lo + 8], using_knn=knn)
    try:
        return dict(m.get_values())
    except ValueError:
        return "ValueError"


def _same(a, b):
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return a.keys() == b.keys() and all(
        (np.isnan(a[k]) and np.isnan(b[k])) or a[k] == b[k] for k in a)


@pytest.mark.parametrize("kind", ["random", "ties", "knn", "no_positive",
                                  "no_negative", "all_one_value",
                                  "uncertain", "plus_minus", "one_column",
                                  "nan_score"])
def test_multilabel_metrics_match_sklearn_backed_jax(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    seen = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # sklearn's undefined-metric notes
        for _ in range(60):
            truths, logits, knn = _case(rng, kind)
            c = truths.shape[1]
            want = _values(jmetrics.MultiLabelClassificationMetrics, c,
                           truths, logits, knn)
            got = _values(tmetrics.MultiLabelClassificationMetrics, c,
                          truths, logits, knn)
            assert _same(got, want), (truths, logits, got, want)
            if isinstance(want, dict):
                seen.add(np.isnan(want["val_roc_auc"]))
                want_auc = jmetrics.mean_roc_auc(truths, logits)
                got_auc = tmetrics.mean_roc_auc(truths, logits)
                assert (np.isnan(got_auc) and np.isnan(want_auc)) \
                    or got_auc == want_auc
    assert seen
    if kind == "no_negative":
        assert seen == {True}          # sklearn's nan for a one-class label


def test_metric_keys_and_reset():
    m = tmetrics.MultiLabelClassificationMetrics(3, mode="test")
    m.add_preds(np.zeros((2, 3)), np.eye(3)[:2])
    assert list(m.get_values()) == ["test_accuracy", "test_mAP",
                                   "test_precision", "test_recall",
                                   "test_f1", "test_roc_auc"]
    assert m.truths == [] and m.predictions == []


# ------------------------------------------------------------------ #
# data, wrapper, trainer
# ------------------------------------------------------------------ #

def _params(tmp_path, size=128, batch=32, **extra):
    params = load_merged_params(PARAMS)
    params.dataset_params.dataset = "SyntheticMultiLabel"
    params.dataset_params.synthetic_size = size
    params.dataset_params.update(extra)
    params.training_params.update(epochs=1, log_every=1,
                                  save_dir=str(tmp_path),
                                  use_mixed_precision=False)
    params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.update(num_workers=0, batch_size=batch)
    return params


@pytest.mark.parametrize("mode", ["train", "val"])
def test_synthetic_multilabel_records_match_jax(tmp_path, mode):
    from apla_tpu.data.datasets import get_dataset_class as jget
    from apla_tpu_torch.data.datasets import get_dataset_class as tget
    dp = _params(tmp_path, size=40).dataset_params
    got, want = tget("SyntheticMultiLabel")(dp, mode), \
        jget("SyntheticMultiLabel")(dp, mode)
    assert (got.is_multiclass, got.target_metric, got.n_classes) == \
        (want.is_multiclass, want.target_metric, want.n_classes) == \
        (False, "mAP", 10)
    assert len(got.data) == len(want.data)
    for a, b in zip(got.data, want.data):
        np.testing.assert_array_equal(a["img_arr"], b["img_arr"])
        assert a["label"].dtype == np.float32 and a["label"].sum() == 2
        np.testing.assert_array_equal(a["label"], b["label"])
    # samples through the eval transforms (train's flip draws its own rng)
    for i in (0, 7) if mode == "val" else ():
        np.testing.assert_allclose(got[i]["image"], want[i]["image"],
                                   atol=1e-6)
        np.testing.assert_array_equal(got[i]["label"], want[i]["label"])


@pytest.mark.parametrize("classes", [10, 2])
def test_wrapper_heads_criterion_and_metric_match_jax(tmp_path, classes):
    """A multi-label set takes BCE and the multi-label metric; with two
    classes or fewer the head has one logit (the binary multi-label
    case), as in the JAX wrapper."""
    from apla_tpu.wrapper import DefaultWrapper as JWrapper
    from apla_tpu_torch.train.losses import bce_with_logits
    from apla_tpu_torch.wrapper import DefaultWrapper
    params = _params(tmp_path, size=64, synthetic_classes=classes)
    tw, jw = DefaultWrapper(params), JWrapper(params)
    for w in (tw, jw):
        w.instantiate()
    assert tw.model_params.n_classes == jw.model_params.n_classes \
        == (1 if classes == 2 else classes)
    assert tuple(tw.model.fc.kernel.shape) == (192, tw.model_params.n_classes)
    assert tw.is_multiclass is False and tw.criterion is bce_with_logits
    assert tw.metric_class is tmetrics.MultiLabelClassificationMetrics
    assert tw.model_params.target_metric == "mAP"


def _records(trainer_logger):
    recs = []
    log = trainer_logger.log

    def record(rec, step):
        recs.append((step, dict(rec)))
        return log(rec, step)
    trainer_logger.log = record
    return recs


def test_vit_tiny_multilabel_run_matches_jax(tmp_path):
    """One epoch (4 steps of b32, then a validation) of the synthetic
    recipe on `SyntheticMultiLabel` through the JAX and the port's
    wrapper and trainer, the port started from the JAX initial weights."""
    from apla_tpu.train.trainer import Trainer as JTrainer
    from apla_tpu.wrapper import DefaultWrapper as JWrapper
    from apla_tpu_torch.train.trainer import Trainer
    from apla_tpu_torch.utils.pretrained import params_from_jax
    from apla_tpu_torch.wrapper import DefaultWrapper

    jw = JWrapper(_params(tmp_path / "jax"))
    jw.instantiate()
    tw = DefaultWrapper(_params(tmp_path / "port"))
    tw.instantiate()
    t_state, f_state = params_from_jax(
        jax.tree.map(np.asarray, jw.state.trainable),
        jax.tree.map(np.asarray, jw.frozen))
    with torch.no_grad():
        live = dict(tw.model.named_parameters())
        for name, val in {**t_state, **f_state}.items():
            if name in live:
                live[name].copy_(val)
    jt, tt = JTrainer(jw), Trainer(tw)
    j_recs = _records(jt.logger)
    jt.train()
    tt.train()
    j_steps = [r for _, r in j_recs if "train_loss" in r]
    t_steps = [r for _, r in tt.history if "train_loss" in r]
    assert len(j_steps) == len(t_steps) == 4
    for i, (a, b) in enumerate(zip(t_steps, j_steps)):
        # the record's keys: the step timer's from the 4th step on
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in ("train_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert "step_time_p95_ms" in t_steps[-1]
    j_val = [r for _, r in j_recs if "val_mAP" in r][-1]
    t_val = [r for _, r in tt.history if "val_mAP" in r][-1]
    for k in ("val_mAP", "val_roc_auc", "val_f1", "val_accuracy",
              "val_loss"):
        np.testing.assert_allclose(t_val[k], j_val[k], rtol=0, atol=2e-3,
                                   err_msg=k)


def test_step_timer_summary_matches_jax():
    from apla_tpu.utils.profiling import StepTimer as JTimer
    samples = [0.0123, 0.0101, 0.0502, 0.0099, 0.0111, 0.0134, 0.2]
    timers = [tprof.StepTimer(), JTimer()]
    for t in timers:
        t.samples = list(samples)
    assert timers[0].summary() == timers[1].summary()
    assert tprof.StepTimer().summary() == {}
    assert tprof.device_memory_stats("cpu") == {}
    t = tprof.StepTimer(sync_every=2, skip_first=1)
    synced = []

    class Loss:
        def __float__(self):
            synced.append(1)
            return 0.0
    for _ in range(5):
        t.tick(sync_value=Loss())
    assert len(t.samples) == 4 and len(synced) == 2
    t.reset()
    assert t.samples == [] and t._count == 0


def _knn_reference(emb_fn, bank_loader, loader, n_classes, knn_k, knn_t,
                   mode):
    """The JAX package's multi-label vote and metric over `emb_fn`'s
    embeddings."""
    from apla_tpu.train.knn import knn_predict_multilabel
    feats, labels = [], []
    for b in bank_loader:
        feats.append(emb_fn(b["image"]).numpy())
        labels.append(b["label"].numpy())
    feats, labels = np.concatenate(feats), np.concatenate(labels)
    metric = jmetrics.MultiLabelClassificationMetrics(n_classes, mode=mode)
    for b in loader:
        scores = knn_predict_multilabel(
            jnp.asarray(emb_fn(b["image"]).numpy()), jnp.asarray(feats),
            jnp.asarray(labels.astype(np.float32)),
            knn_k=min(knn_k, len(labels)), knn_t=knn_t)
        metric.add_preds(np.asarray(scores), b["label"].numpy(),
                         using_knn=True)
    return dict(metric.get_values())


def test_multilabel_knn_in_the_supervised_trainer(tmp_path):
    from apla_tpu_torch.train.trainer import Trainer
    from apla_tpu_torch.wrapper import DefaultWrapper
    params = _params(tmp_path, size=64, knn_eval=True)
    params.training_params.knn_eval = True
    w = DefaultWrapper(params)
    w.instantiate()
    trainer = Trainer(w)
    got = trainer.knn_evaluate(w.dataloaders.valloader)
    with torch.no_grad():
        want = _knn_reference(
            lambda x: trainer.embed_step(trainer.state.model, x),
            w.dataloaders.fbank_loader, w.dataloaders.valloader,
            trainer.n_classes, trainer.knn_nhood, 0.07, "knn_val")
    assert set(got) == {"knn_val_accuracy", "knn_val_mAP",
                        "knn_val_precision", "knn_val_recall", "knn_val_f1",
                        "knn_val_roc_auc"}
    assert dict(got) == want


def test_multilabel_knn_in_the_byol_trainer(tmp_path):
    from apla_tpu_torch.ssl import get_ssl_wrapper_and_trainer
    import argparse
    params = load_merged_params(BYOL)
    params.dataset_params.dataset = "SyntheticMultiLabel"
    params.dataset_params.synthetic_size = 48
    params.training_params.update(epochs=1, save_dir=str(tmp_path))
    params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.update(num_workers=0, batch_size=16)
    wrapper_cls, trainer_cls = get_ssl_wrapper_and_trainer(
        argparse.Namespace(byol=True, simsiam=False, dino=False,
                           dinov2=False))
    w = wrapper_cls(params)
    w.instantiate()
    trainer = trainer_cls(w)
    got = trainer.evaluate()
    with torch.no_grad():
        want = _knn_reference(trainer._embed, w.dataloaders.fbank_loader,
                              w.dataloaders.valloader, trainer.n_classes,
                              trainer.knn_nhood, 0.1, "knn_val")
    assert "knn_val_mAP" in got and dict(got) == want


# ------------------------------------------------------------------ #
# LAMB
# ------------------------------------------------------------------ #

def test_lamb_matches_optax_at_the_apla_leaf_split():
    """The APLA classifier's trainable tree as JAX holds it (each block's
    columns stacked [depth, ...], the head, the cls and position
    embeddings; `proj_bt` starts at zero: a zero-norm leaf) and the port's
    per-block tensors, 5 steps of build_optimizer("LAMB") with a clip
    that some steps reach, a varying lr and weight decay 0.1 under the
    decay mask."""
    import optax

    from apla_tpu.train.optim import build_optimizer as jbuild, set_lr
    from apla_tpu_torch.train.optim import build_optimizer, global_norm
    from apla_tpu_torch.utils.pretrained import params_from_jax
    depth, d, k, c = 3, 8, 4, 5
    rng = np.random.default_rng(0)
    tree = {"backbone": {"blocks": {
                "proj_wt": rng.standard_normal((depth, d, k)),
                "proj_bt": np.zeros((depth, k))},
                "cls_token": rng.standard_normal((1, 1, d)),
                "pos_embed": rng.standard_normal((1, 3, d)) * 0.1},
            "fc": {"kernel": rng.standard_normal((d, c)),
                   "bias": np.zeros(c)}}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                     * (2.0 if i % 2 else 0.05)).astype(
                                         np.float32), tree)
             for i in range(5)]
    lrs = [1e-2, 8e-3, 6e-3, 4e-3, 2e-3]
    opt_params = {"lr": 1e-2, "weight_decay": 0.1}
    jp = jax.tree.map(jnp.asarray, tree)
    tx = jbuild("LAMB", dict(opt_params), jp, grad_clip=1.0)
    state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        state = set_lr(state, lr)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    named = {n: torch.nn.Parameter(t) for n, t in
             params_from_jax(tree, {})[0].items()}
    assert len(named) == 2 * depth + 4
    opt = build_optimizer("LAMB", dict(opt_params), list(named.items()),
                          grad_clip=1.0)
    assert len(opt.opt.leaves) == 6          # as the JAX tree's leaves
    for g, lr in zip(grads, lrs):
        flat = params_from_jax(g, {})[0]
        for n, p in named.items():
            p.grad = flat[n].clone()
        opt.set_lr(lr)
        opt.step(global_norm([p.grad for p in named.values()]))
    want = params_from_jax(jax.tree.map(np.asarray, jp), {})[0]
    moved = 0
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        moved += not np.array_equal(want[n].numpy(),
                                    params_from_jax(tree, {})[0][n].numpy())
    assert moved == len(named)
    # a checkpoint round trip keeps the moments and the step count
    sd = opt.state_dict()
    opt2 = build_optimizer("LAMB", dict(opt_params), list(named.items()))
    opt2.load_state_dict(sd)
    assert opt2.opt.state[named["fc.kernel"]]["step"] == 5
