"""The port's run logger (`apla_tpu_torch/utils/logging.py`) against the JAX
package's.

- Every trainer's metrics file: the supervised `Trainer`, `BYOLTrainer`,
  `DINOTrainer` and `Dinov2Trainer` of both packages train one epoch of
  the tiny synthetic recipes in float32 from the same weights (the port's
  loaded from the JAX initial state) and test; each writes
  `<save_dir>/<model_name>.metrics.jsonl`.  The two files hold the same
  records at the same iterations with the same keys; `train_loss`, `lr`,
  `grad_norm` and the schedules' values at 1e-4 relative, the validation
  and test metrics at 2e-3 (the tolerances of `test_torch_multilabel.py`'s
  run against the JAX trainer).  The step timer's and the memory keys
  are compared as key sets.  The SSL trainers log no test record, in
  either package.
- The wandb sink, with a fake `wandb` module in `sys.modules` that records
  `init`'s arguments, every `log`, `finish`, and the `wandb sync` of an
  offline run (`subprocess.run` monkeypatched): the same calls from both
  packages, dry runs writing no file, `--debug`'s `WANDB_MODE`.
- wandb absent, or raising at `init`: the JSONL file alone, in both.
- Two ranks under gloo: one file, written by rank 0.

Each package's loader and host multi-crop give the same images (held in
`test_torch_multicrop.py`), so the two runs see the same batches.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from apla_tpu.utils import logging as jlog
from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.parallel import launch as tlaunch
from apla_tpu_torch.utils import logging as tlog
from apla_tpu_torch.utils.pretrained import (byol_state_from_jax,
                                             dino_state_from_jax,
                                             dinov2_state_from_jax,
                                             params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "params", "synthetic", "vit_tiny")
# keys whose values are the wall clock or the device's memory
TIMING = ("t", "images_per_sec")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(recipe, save_dir, size=32, batch=16, **training):
    params = load_merged_params(os.path.join(TINY, f"{recipe}.yml"))
    params.dataset_params.synthetic_size = size
    params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.update(batch_size=batch, num_workers=0)
    params.training_params.update(epochs=1, log_every=1, val_every=1.0,
                                  save_dir=str(save_dir), model_name="run",
                                  use_mixed_precision=False, **training)
    return params


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _load_supervised(tw, jw):
    t_state, f_state = params_from_jax(
        jax.tree.map(np.asarray, jw.state.trainable),
        jax.tree.map(np.asarray, jw.frozen))
    with torch.no_grad():
        live = dict(tw.model.named_parameters())
        for name, val in {**t_state, **f_state}.items():
            if name in live:
                live[name].copy_(val)


def _load_ssl(tw, jt, convert):
    st = convert(*jax.tree.map(np.asarray, (jt.state, jt.frozen)))
    tw.model.load_state_dict({**st["frozen"], **st["trainable"]},
                             strict=True)
    aux = {f"teacher.{n}": v for n, v in st.get("teacher", {}).items()}
    aux.update({f"model_state.{n}": v
                for n, v in st.get("model_state", {}).items()})
    for k in ("center", "dino_center", "ibot_center"):
        if k in st:
            aux[k] = st[k]
    tw.state.load_aux(aux)


def _runs(kind, tmp_path):
    """(the port's records, the JAX package's records) of one epoch and
    the test of `kind`."""
    if kind == "supervised":
        from apla_tpu.train.trainer import Trainer as JT
        from apla_tpu.wrapper import DefaultWrapper as JW
        from apla_tpu_torch.train.trainer import Trainer as TT
        from apla_tpu_torch.wrapper import DefaultWrapper as TW
        recipe, extra, load = "apla", {}, None
    elif kind == "byol":
        from apla_tpu.ssl.byol import BYOLTrainer as JT, BYOLWrapper as JW
        from apla_tpu_torch.ssl.byol import BYOLTrainer as TT, \
            BYOLWrapper as TW
        recipe, extra, load = "byol", {"use_momentum": True}, \
            byol_state_from_jax
    elif kind == "dino":
        from apla_tpu.ssl.dino import DINOTrainer as JT, DINOWrapper as JW
        from apla_tpu_torch.ssl.dino import DINOTrainer as TT, \
            DINOWrapper as TW
        recipe, extra, load = "dino", {}, dino_state_from_jax
    else:
        from apla_tpu.ssl.dinov2 import DINOv2Wrapper as JW, \
            Dinov2Trainer as JT
        from apla_tpu_torch.ssl.dinov2 import DINOv2Wrapper as TW, \
            Dinov2Trainer as TT
        recipe, extra, load = "dinov2", {}, dinov2_state_from_jax
    params, tparams = (_params(recipe, tmp_path / d) for d in ("jax", "port"))
    # JAX on one device of the test mesh: a batch sharded over eight
    # changes the step's sums (KoLeo's neighbours among them)
    params.system_params.n_devices = 1
    if kind == "dinov2":
        # layerscale 1 as in `test_torch_dinov2_step.py`: at the recipe's
        # 1e-5 the blocks barely move the embeddings, whose neighbours
        # (KoLeo's, the kNN's) are then decided by rounding
        for p in (params, tparams):
            p.model_params.transformers_params.student.layerscale = 1.0
    jw = JW(params, **extra)
    jw.instantiate()
    jt = JT(jw)
    tw = TW(tparams, **extra)
    tw.instantiate()
    if load is None:
        _load_supervised(tw, jw)
    tt = TT(tw)
    if load is not None:
        _load_ssl(tw, jt, load)
    for t in (jt, tt):
        t.train()
        t.test()
    return (_read(tmp_path / "port" / "run.metrics.jsonl"),
            _read(tmp_path / "jax" / "run.metrics.jsonl"))


@pytest.mark.parametrize("kind", ["supervised", "byol", "dino", "dinov2"])
def test_metrics_file_matches_jax(kind, tmp_path):
    got, want = _runs(kind, tmp_path)
    assert [r["iters"] for r in got] == [r["iters"] for r in want]
    # the steps, a validation; the supervised test table (the SSL
    # trainers print theirs)
    assert any("train_loss" in r for r in got)
    assert any(any(k.startswith(("val_", "knn_val_")) for k in r)
               for r in got)
    assert any(any(k.startswith("test_") for k in r)
               for r in got) == (kind == "supervised")
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), (i, sorted(a), sorted(b))
        for k in a:
            if k in TIMING or k.startswith(("step_time", "device_")):
                continue
            tol = 1e-4 if not k.startswith(
                ("val_", "test_", "knn_")) else 2e-3
            np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                       err_msg=f"record {i} {k}")


# --------------------------------------------------------------------------- #
# the wandb sink
# --------------------------------------------------------------------------- #

class _FakeRun:
    def __init__(self, calls, save_dir):
        self.calls, self.id = calls, "abc123"
        self.dir = os.path.join(save_dir, "wandb", "offline-run-x-abc123",
                                "files")
        os.makedirs(self.dir, exist_ok=True)

    def log(self, metrics, step=None):
        self.calls.append(("log", dict(metrics), step))

    def finish(self):
        self.calls.append(("finish",))


def _fake_wandb(monkeypatch, fail=False, run_dir="."):
    calls = []

    def init(**kw):
        if fail:
            raise RuntimeError("no network")
        calls.append(("init", {k: v for k, v in kw.items() if k != "dir"}))
        return _FakeRun(calls, kw.get("dir", run_dir))

    monkeypatch.setitem(sys.modules, "wandb",
                        types.SimpleNamespace(init=init))
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(
        ("run", [os.path.basename(c) if "offline-run" in c else c
                 for c in cmd])))
    return calls


class _Wrapper:
    def __init__(self, log_params, **training):
        self.parameters = {"log_params": log_params,
                           "training_params": training}
        self.log_params = log_params
        self.training_params = training


class _Trainer:
    def __init__(self, save_dir, is_dry=False, is_debug=False):
        self.model_name, self.save_dir = "m", str(save_dir)
        self.is_dry, self.is_debug = is_dry, is_debug


def _drive(mod, save_dir, log_params, trainer_kw=None, **training):
    logger = mod.make_run_logger(_Wrapper(log_params, **training),
                                 _Trainer(save_dir, **(trainer_kw or {})))
    logger.log({"train_loss": np.float32(0.5), "lr": 1e-3}, 1)
    logger.log({"val_accuracy": 0.25}, 2)
    logger.finish()
    logger.log({"test_accuracy": 0.5}, 2)          # after finish: JSONL
    return logger


@pytest.mark.parametrize("case", ["default", "offline", "named", "off",
                                  "dry", "debug"])
def test_sink_calls_match_jax(case, tmp_path, monkeypatch):
    lp = {"project_name": "P", "run_name": "DEFINED_BY_MODEL_NAME"}
    training, trainer_kw = {}, {}
    if case == "offline":
        training = {"offline": True, "restore_session": True}
    elif case == "named":
        lp = {"run_name": "given", "use_wandb": True}
    elif case == "off":
        lp = {"use_wandb": False}
    elif case == "dry":
        trainer_kw = {"is_dry": True}
    elif case == "debug":
        trainer_kw = {"is_debug": True}
    calls, files = {}, {}
    for name, mod in (("port", tlog), ("jax", jlog)):
        monkeypatch.delenv("WANDB_MODE", raising=False)
        d = tmp_path / name
        calls[name] = _fake_wandb(monkeypatch, run_dir=str(d) + "_runs")
        _drive(mod, d, lp, trainer_kw, **training)
        files[name] = sorted(p for p in os.listdir(d)
                             if p.endswith(".jsonl")) if d.exists() else []
        if case == "debug":
            assert os.environ.get("WANDB_MODE") == "dryrun"
    assert calls["port"] == calls["jax"]
    assert files["port"] == files["jax"]
    if case == "dry":
        assert files["port"] == []
    else:
        name = "given" if case == "named" else "m"
        assert files["port"] == [f"{name}.metrics.jsonl"]
        recs = _read(tmp_path / "port" / files["port"][0])
        assert [r["iters"] for r in recs] == [1, 2, 2]
        assert recs[0]["train_loss"] == 0.5
    if case == "off":
        assert calls["port"] == []
    else:
        assert calls["port"][0][0] == "init"
        assert [c[0] for c in calls["port"]][-2:] == (
            ["finish", "run"] if case == "offline" else ["log", "finish"])


@pytest.mark.parametrize("how", ["absent", "init_raises"])
def test_without_the_sink_the_jsonl_alone(how, tmp_path, monkeypatch):
    if how == "absent":
        monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    else:
        _fake_wandb(monkeypatch, fail=True)
    for name, mod in (("port", tlog), ("jax", jlog)):
        logger = _drive(mod, tmp_path / name, {"project_name": "P"})
        assert logger.wandb_run is None
    recs = [_read(tmp_path / n / "m.metrics.jsonl") for n in ("port", "jax")]
    assert [[{k: v for k, v in r.items() if k != "t"} for r in rs]
            for rs in recs] == [[{"iters": 1, "train_loss": 0.5,
                                  "lr": 1e-3},
                                 {"iters": 2, "val_accuracy": 0.25},
                                 {"iters": 2, "test_accuracy": 0.5}]] * 2


def test_two_ranks_write_one_file(tmp_path):
    """W = 2 under gloo: the supervised recipe through `DefaultWrapper` ->
    `Trainer` on two ranks; rank 0 alone writes the metrics file, each
    record once, the records of its `history`."""
    from apla_tpu_torch.parallel import runs
    params = _params("apla", tmp_path / "w2")
    params.system_params.n_devices = 2
    run = tlaunch.launch(runs.trainer_run, 2, (params,), device="cpu",
                         backend="gloo", store_dir=str(tmp_path / "store"))
    assert sorted(os.listdir(tmp_path / "w2")) == ["run",
                                                   "run.metrics.jsonl"]
    recs = _read(tmp_path / "w2" / "run.metrics.jsonl")
    assert [r["iters"] for r in recs] == [it for it, _ in run["history"]]
    for rec, (_, want) in zip(recs, run["history"]):
        assert {k: v for k, v in rec.items() if k not in ("iters", "t")} \
            == pytest.approx(want)
