"""The port's DefaultWrapper + Trainer end to end on the CPU.

The hermetic synthetic recipe (`params/synthetic/vit_tiny/apla.yml`, merged
by the JAX package's config loader) trains a tiny APLA ViT for two epochs:
the loss falls, frozen weights stay bit for bit, every trainable tensor
moves, the checkpoint reloads, the test table prints.  Then: a run stopped
by SIGTERM mid-epoch leaves a checkpoint, and resuming from it finishes
with exactly the weights of an uninterrupted run (the shuffle and the
per-step draws are deterministic, so the skipped batches replay); the
`python -m apla_tpu_torch.main` entry, for the supervised recipe and for
`--byol`, `--simsiam` and `--dino`; the kNN rows of the test table
(`knn_eval`); the CPU only when asked for; and every knob the port does not
have yet raises naming its ROADMAP item.
"""

import os
import signal

import numpy as np
import pytest
import torch

from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch import main as tmain
from apla_tpu_torch.train.checkpoint import load_checkpoint
from apla_tpu_torch.train.trainer import Trainer
from apla_tpu_torch.wrapper import DefaultWrapper

PARAMS = os.path.join(os.path.dirname(__file__), "..", "params", "synthetic",
                      "vit_tiny", "apla.yml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(save_dir, epochs=2, size=256, **training):
    params = load_merged_params(PARAMS)
    params.training_params.update(epochs=epochs, log_every=1,
                                  save_dir=str(save_dir), **training)
    params.dataset_params.synthetic_size = size
    params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.num_workers = 0
    return params


def _snapshot(tensors):
    return {n: t.detach().clone() for n, t in tensors.items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    wrapper = DefaultWrapper(_params(tmp_path_factory.mktemp("ckpt"),
                                     knn_eval=True))
    wrapper.instantiate()
    trainer = Trainer(wrapper)
    frozen = _snapshot(trainer.state.frozen())
    trainable = _snapshot(trainer.state.trainable())
    trainer.train()
    return trainer, frozen, trainable


def test_loss_falls_over_two_epochs(trained):
    trainer, _, _ = trained
    losses = [r["train_loss"] for _, r in trainer.history
              if "train_loss" in r]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[4:]) < np.mean(losses[:4]), losses


def test_frozen_unchanged_and_trainables_moved(trained):
    trainer, frozen, trainable = trained
    for name, t in trainer.state.frozen().items():
        assert torch.equal(t, frozen[name]), name
    for name, t in trainer.state.trainable().items():
        assert not torch.equal(t, trainable[name]), name
    assert all(not p.requires_grad for p in trainer.state.frozen().values())


def test_checkpoint_reloads(trained, tmp_path):
    trainer, _, _ = trained
    path = trainer.checkpoint_path
    assert sorted(os.listdir(path)) == ["frozen.pt", "manifest.json",
                                        "parameters.pkl", "state.pt"]
    wrapper = DefaultWrapper(_params(tmp_path))
    wrapper.instantiate(seed=1)          # other weights, replaced on load
    manifest, best = load_checkpoint(path, wrapper.state)
    assert manifest["iters"] == trainer.iters == wrapper.state.step
    assert set(manifest) >= {"iters", "epoch", "best_val_target",
                             "scheduler"}
    assert best is not None
    for name, t in trainer.state.trainable().items():
        assert torch.equal(wrapper.state.trainable()[name], t), name
    for name, t in trainer.state.frozen().items():
        assert torch.equal(wrapper.state.frozen()[name], t), name


def test_test_table(trained, capsys):
    trainer, _, _ = trained
    results = trainer.test()
    out = capsys.readouterr().out
    assert "TEST RESULTS" in out and "test_accuracy" in out
    assert results["test_accuracy"] > 0.3          # chance is 0.1
    # knn_eval: the kNN rows from the feature bank of the training images
    assert "knn_test_accuracy" in out
    assert results["knn_test_accuracy"] > 0.3


def _run(save_dir, stop_at=None, restore=False):
    """One epoch of 4 steps; SIGTERM delivered during step `stop_at`."""
    wrapper = DefaultWrapper(_params(save_dir, epochs=1,
                                     restore_session=restore))
    wrapper.instantiate()
    trainer = Trainer(wrapper)
    step, calls = trainer.train_step, []

    def counting(*args):
        calls.append(1)
        if len(calls) == stop_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*args)

    trainer.train_step = counting
    trainer.train()
    return trainer, len(calls)


def test_sigterm_checkpoint_and_mid_epoch_resume(tmp_path):
    handler = signal.getsignal(signal.SIGTERM)
    full, _ = _run(tmp_path / "full")
    stopped, n = _run(tmp_path / "split", stop_at=2)
    assert n == 2 and stopped._preempted
    manifest = load_checkpoint(stopped.checkpoint_path, stopped.state)[0]
    assert manifest["iters"] == 2
    # train() put the previous handler back
    assert signal.getsignal(signal.SIGTERM) == handler
    resumed, n = _run(tmp_path / "split", restore=True)
    assert n == 2 and resumed.iters == full.iters == 4
    for name, t in full.state.trainable().items():
        assert torch.equal(resumed.state.trainable()[name], t), name


def test_cli_tests_a_checkpoint(trained, capsys):
    trainer, _, _ = trained
    results = tmain.run_cli(["--params_path", PARAMS, "--test",
                             "--pretrained_path", trainer.checkpoint_path,
                             "--num_workers", "0", "--device", "cpu"])
    assert "TEST RESULTS" in capsys.readouterr().out
    # the YAML's own test set (512 images): the trained weights, not chance
    assert results["test_accuracy"] > 0.3


@pytest.mark.parametrize("where,key,value", [
    ("system_params", "tensor_parallel", 2),
    ("system_params", "pipeline_parallel", 2),
    ("system_params", "sequence_parallel", True),
    ("system_params", "n_devices", 4),
    ("system_params", "param_sharding", "fsdp"),
    ("dataset_params", "dataset", "ImageNet"),
    ("optimization_params", "LAMB", None),
    ("ssl", "quantize_frozen", True),
])
def test_unported_knobs_raise(tmp_path, where, key, value):
    """What the port refuses.  W8A8 training (`quantize_frozen`) runs in
    the supervised wrapper only: the SSL wrappers refuse it, as the JAX SSL
    wrappers never read it."""
    from apla_tpu_torch.ssl.byol import BYOLWrapper
    params = _params(tmp_path)
    wrapper_cls = DefaultWrapper
    if where == "optimization_params":
        params.optimization_params.default.optimizer.type = "LAMB"
    elif where == "ssl":
        params.model_params[key] = value
        wrapper_cls = BYOLWrapper
    else:
        params[where][key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wrapper_cls(params).instantiate()


SSL_RECIPES = {"--byol": ("byol.yml", "BYOL heads"),
               "--simsiam": ("byol.yml", "SimSiam heads"),
               "--dino": ("dino.yml", "DINO head")}


@pytest.mark.parametrize("flag", ["--byol", "--simsiam", "--dino"])
def test_cli_ssl_flags_run(flag, tmp_path, monkeypatch, capsys):
    """Each SSL flag's synthetic recipe: without a card and without
    `--device cpu` it raises; with `--device cpu` it trains one epoch,
    checkpoints, and `--test --pretrained_path` prints the kNN table of the
    checkpoint.  SimSiam's choice stays with its own wrapper: the BYOL
    wrapper class keeps `use_momentum`."""
    from apla_tpu_torch.ssl import get_ssl_wrapper_and_trainer
    from apla_tpu_torch.ssl.byol import BYOLWrapper
    yml, heads = SSL_RECIPES[flag]
    path = os.path.join(os.path.dirname(PARAMS), yml)

    def load(p):
        params = load_merged_params(p)
        params.dataset_params.synthetic_size = 64
        for ld in params.dataloader_params.values():
            ld.update(batch_size=16, num_workers=0)
        params.training_params.update(log_every=1, save_dir=str(tmp_path))
        return params

    monkeypatch.setattr(tmain, "load_merged_params", load)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [flag, "--params_path", path]
    with pytest.raises(RuntimeError, match="--device cpu"):
        tmain.run_cli(flags + ["--epochs", "1"])
    flags += ["--device", "cpu"]
    assert tmain.run_cli(flags + ["--epochs", "1", "--model_name", "cli"]) \
        is None
    ckpt = os.path.join(str(tmp_path), "cli")
    assert os.path.isfile(os.path.join(ckpt, "state.pt"))
    out = capsys.readouterr().out
    assert f"vit_tiny + {heads}" in out and "[knn val @ it 4]" in out
    results = tmain.run_cli(flags + ["--test", "--pretrained_path", ckpt])
    assert "SSL TEST RESULTS (kNN)" in capsys.readouterr().out
    assert 0.0 <= results["knn_test_accuracy"] <= 1.0
    wrapper_cls, _ = get_ssl_wrapper_and_trainer(
        tmain.parse_arguments(["--params_path", path, "--byol"]))
    assert wrapper_cls.keywords == {"use_momentum": True}
    assert BYOLWrapper.use_momentum is True


def test_a_missing_card_raises_unless_the_cpu_is_asked_for(tmp_path,
                                                           monkeypatch):
    """The entry points run on the card; without one they raise, and the
    CPU is taken only when `system_params.device` (`--device`) says so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = _params(tmp_path)
    del params.system_params["device"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        DefaultWrapper(params)
    params.system_params.device = "cuda:0"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DefaultWrapper(params)
    args = tmain.parse_arguments(["--params_path", PARAMS, "--device", "cpu"])
    params = tmain.update_params_from_args(_params(tmp_path), args)
    assert DefaultWrapper(params).device == torch.device("cpu")


def test_profile_dir_traces_steps_10_to_20(tmp_path, capsys):
    params = _params(tmp_path / "ckpt", epochs=1, size=168,
                     profile_dir=str(tmp_path / "prof"))
    for ld in params.dataloader_params.values():
        ld.batch_size = 8               # 21 steps
    wrapper = DefaultWrapper(params)
    wrapper.instantiate()
    Trainer(wrapper).train()
    assert (tmp_path / "prof" / "train_trace.json").stat().st_size > 0
    assert "profiler trace of steps 10..20" in capsys.readouterr().out
