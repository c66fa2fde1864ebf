"""The port's DINOv2 slice end to end on the CPU.

The hermetic tiny recipe (`params/synthetic/vit_tiny/dinov2.yml`: a
12-block ViT-Ti/8 at 32 px, APLA-16, 2 global + 8 local crops made on the
device, DINO + iBOT heads, KoLeo; `fused_proto_ce: ibot`) goes through
`DINOv2Wrapper` -> `Dinov2Trainer.train()` -> `test()`: every loss term is
finite, frozen weights (the iBOT mask token among them) stay bit for bit,
the APLA columns, the head and the teacher move, both centers leave zero,
the kNN validation and test tables print, and the checkpoint reloads the
trained tensors, the teacher and both centers.  Then the same run through
`python -m apla_tpu_torch.main --dinov2` and its `--test`.
"""

import os

import numpy as np
import pytest
import torch

from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch import main as tmain
from apla_tpu_torch.ssl.dinov2 import DINOv2Wrapper, Dinov2Trainer

YML = os.path.join(os.path.dirname(__file__), "..", "params", "synthetic",
                   "vit_tiny", "dinov2.yml")
LOSS_TERMS = ("dino_local_crops_loss", "dino_global_crops_loss",
              "koleo_loss", "ibot_loss")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(save_dir, path=YML, cli=False):
    """The tiny recipe, cut for the CPU, on the device multi-crop
    (`device_augment`: its synthetic images are stored at 32 px, the size
    the device multi-crop cuts its 32- and 16-px crops from; the host
    multi-crop is `test_torch_multicrop.py`'s); with `cli` the device is
    left to the command line's flag."""
    params = load_merged_params(path)
    params.dataset_params.synthetic_size = 64
    params.dataset_params.device_augment = True
    if not cli:
        params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.update(batch_size=16, num_workers=0)
    params.training_params.update(epochs=2, log_every=1, val_every=1.0,
                                  save_dir=str(save_dir))
    params.model_params.dinov2.fused_proto_ce = "ibot"
    return params


def _snapshot(tensors):
    return {n: t.detach().clone() for n, t in tensors.items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    wrapper = DINOv2Wrapper(_params(tmp_path_factory.mktemp("ssl")))
    wrapper.instantiate()
    trainer = Dinov2Trainer(wrapper)
    before = (_snapshot(trainer.state.frozen()),
              _snapshot(trainer.state.trainable()),
              _snapshot(trainer.state.teacher))
    trainer.train()
    return trainer, before


def test_every_loss_term_is_finite(trained):
    trainer, _ = trained
    records = [r for _, r in trainer.history if "train_loss" in r]
    assert len(records) == trainer.iters == 8
    for r in records:
        assert np.isfinite([r["train_loss"]] + [r[k] for k in LOSS_TERMS]
                           ).all(), r
    # the DINOv2 tables drove the step: teacher temperature warms up
    temps = [r["teacher_temp"] for r in records]
    assert temps[0] == pytest.approx(0.04) and temps[-1] > temps[0]


def test_frozen_kept_trainable_teacher_and_centers_moved(trained):
    trainer, (frozen, trainable, teacher) = trained
    state = trainer.state
    assert "backbone.mask_token" in frozen
    for n, t in state.frozen().items():
        assert torch.equal(t, frozen[n]), n
    # the prototype layer was frozen in epoch 1 and trained in epoch 2
    for n, t in state.trainable().items():
        assert not torch.equal(t, trainable[n]), n
    assert set(state.teacher) == set(trainable)
    for n, t in state.teacher.items():
        assert not torch.equal(t, teacher[n]), n
    assert float(state.dino_center.abs().max()) > 0
    assert float(state.ibot_center.abs().max()) > 0


def test_knn_validation_and_test_table(trained, capsys):
    trainer, _ = trained
    vals = [r for _, r in trainer.history if "knn_val_accuracy" in r]
    assert len(vals) == 2                      # once per epoch
    results = trainer.test()
    assert "SSL TEST RESULTS (kNN)" in capsys.readouterr().out
    assert 0.0 <= results["knn_test_accuracy"] <= 1.0


def test_checkpoint_reloads_teacher_and_centers(trained, tmp_path):
    trainer, _ = trained
    path = trainer.checkpoint_path
    wrapper = DINOv2Wrapper(_params(tmp_path))
    wrapper.instantiate(seed=1)                # other weights, replaced
    other = Dinov2Trainer(wrapper)
    other._restore(path)
    for got, want in ((other.state.trainable(), trainer.state.trainable()),
                      (other.state.frozen(), trainer.state.frozen()),
                      (other.state.teacher, trainer.state.teacher)):
        assert set(got) == set(want)
        for n, t in want.items():
            assert torch.equal(got[n], t), n
    assert torch.equal(other.state.dino_center, trainer.state.dino_center)
    assert torch.equal(other.state.ibot_center, trainer.state.ibot_center)


def test_cli_trains_then_tests_a_checkpoint(tmp_path, monkeypatch, capsys):
    """`--dinov2` trains and checkpoints; `--test --pretrained_path` prints
    the kNN test table of the checkpoint.  `--device cpu` is the way to the
    CPU."""
    monkeypatch.setattr(tmain, "load_merged_params",
                        lambda path: _params(tmp_path, path, cli=True))
    flags = ["--dinov2", "--params_path", YML, "--device", "cpu"]
    assert tmain.run_cli(flags + ["--epochs", "1", "--model_name", "cli"]) \
        is None
    ckpt = os.path.join(str(tmp_path), "cli")
    assert os.path.isfile(os.path.join(ckpt, "state.pt"))
    results = tmain.run_cli(flags + ["--test", "--pretrained_path", ckpt])
    assert "SSL TEST RESULTS (kNN)" in capsys.readouterr().out
    assert "knn_test_accuracy" in results
