"""Transfer learning (`transfer_learning_params.pretrained_path`) in the
port, against the JAX package.

Each package reads its own checkpoint format (the port's `state.pt` /
`frozen.pt`, JAX's msgpack), so the same weights are written twice:

- *a trained supervised checkpoint*: the `params/synthetic/vit_tiny/
  apla.yml` classifier (f32, APLA-16) is imported from one seeded `.pth`
  into both `DefaultWrapper`s (the port's head set to JAX's), each takes
  one AdamW step on the same batch and saves its own checkpoint with its
  best snapshot.  A fresh supervised wrapper of each adopts it in full
  (each bit-equal to its own checkpoint; the two within 1e-4, the step's
  sum order); a DINOv2 wrapper cannot (its frozen mask token is missing)
  and a BYOL wrapper takes the backbone alone;
- *an SSL checkpoint*: a JAX DINOv2 wrapper's state (the teacher's backbone
  as the best snapshot) saved by JAX and, carried across by
  `dinov2_state_from_jax`, by the port.  A fresh supervised wrapper adopts
  the backbone only, the adopted tensors bit-equal in the two packages; a
  DINOv2 wrapper of the port adopts all of it (JAX's the backbone alone,
  see `test_ssl_checkpoint_into_dinov2`).

The error cases (missing names, a rank that differs) raise `ValueError`
in both, and `adopt_state` keeps `adopt_pytree`'s strictness.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.train import checkpoint as jckpt
from apla_tpu.train import losses as jlosses
from apla_tpu.train import steps as jsteps
from apla_tpu.utils.config import load_merged_params
from apla_tpu.wrapper import DefaultWrapper as JWrapper
from apla_tpu_torch.train import checkpoint as tckpt
from apla_tpu_torch.train import losses as tlosses
from apla_tpu_torch.train import steps as tsteps
from apla_tpu_torch.utils.pretrained import (dinov2_state_from_jax,
                                             params_from_jax)
from apla_tpu_torch.wrapper import DefaultWrapper
from tests.test_torch_pretrained import _vit_tiny_hub

TOL = 1e-4
DIR = os.path.join(os.path.dirname(__file__), "..", "params", "synthetic",
                   "vit_tiny")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(yml="apla.yml", pretrained=None, transfer=None, **adapt):
    params = load_merged_params(os.path.join(DIR, yml))
    params.system_params.device = "cpu"
    params.training_params.use_mixed_precision = False
    params.model_params.pretrained = bool(pretrained)
    params.model_params.pretrained_checkpoint = pretrained or ""
    params.transfer_learning_params.pretrained_path = transfer or ""
    params.model_params.adaptation.params.update(adapt)
    return params


_LOADERS = types.SimpleNamespace(trainloader=[None] * 4)


def _jax_wrapper(params, cls=JWrapper):
    w = cls(params)
    w.model_params.n_classes = 10
    w.mesh = w.init_mesh()
    w.init_model()
    return w


def _port_wrapper(params, cls=DefaultWrapper):
    w = cls(params)
    w.model_params.n_classes = 10
    w.init_model()
    return w


def _state(model):
    """(trainable, frozen) name -> tensor maps of a port model."""
    live = {n for n, p in model.named_parameters() if p.requires_grad}
    state = model.state_dict()
    return ({n: t for n, t in state.items() if n in live},
            {n: t for n, t in state.items() if n not in live})


def _jax_state(trainable, frozen):
    return params_from_jax(jax.tree.map(np.asarray, trainable),
                           jax.tree.map(np.asarray, frozen))


def _assert_equal(got, want, names=None):
    for n in (want if names is None else names):
        assert torch.equal(got[n], want[n]), n


@pytest.fixture(scope="module")
def supervised_ckpts(tmp_path_factory):
    """Both packages' checkpoints after one step from the same weights:
    (jax dir, port dir, port (trainable, frozen) saved)."""
    tmp = tmp_path_factory.mktemp("sup")
    pth = str(tmp / "tiny.pth")
    torch.save(_vit_tiny_hub(), pth)
    params = _params(pretrained=pth)
    jw, tw = _jax_wrapper(params), _port_wrapper(params)
    with torch.no_grad():
        for leaf in ("kernel", "bias"):
            getattr(tw.model.fc, leaf).copy_(torch.from_numpy(
                np.array(jw.trainable["fc"][leaf])))
    for w in (jw, tw):
        w.dataloaders = _LOADERS
        w.init_optimization()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8)
    jstep = jsteps.make_train_step(jw.vit_cfg, jw.tx, jlosses.cross_entropy)
    jstate, _ = jstep(jw.state, jw.frozen, {"image": jnp.asarray(x),
                                            "label": jnp.asarray(y)},
                      1e-3, jax.random.PRNGKey(0))
    tstep = tsteps.make_train_step(tw.vit_cfg, tw.optimizer,
                                   tlosses.cross_entropy)
    tstate, _ = tstep(tw.state, {"image": torch.from_numpy(x),
                                 "label": torch.from_numpy(y)}, 1e-3,
                      torch.Generator().manual_seed(0))
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")
    jckpt.save_checkpoint(jdir, state=jstate, frozen=jw.frozen,
                          parameters=dict(params),
                          best_trainable=jstate.trainable)
    best = {n: t.detach().clone() for n, t in tstate.trainable().items()}
    tckpt.save_checkpoint(tdir, state=tstate, parameters=dict(params),
                          best_trainable=best)
    return jdir, tdir, _state(tstate.model)


def test_supervised_checkpoint_adopted_in_full(supervised_ckpts, capsys):
    jdir, tdir, (saved_t, saved_f) = supervised_ckpts
    jw = _jax_wrapper(_params(transfer=jdir))
    j_line = capsys.readouterr().out
    tw = _port_wrapper(_params(transfer=tdir))
    t_line = capsys.readouterr().out
    assert f"Transfer-loaded full weights from {jdir}" in j_line
    assert f"Transfer-loaded full weights from {tdir}" in t_line
    got_t, got_f = _state(tw.model)
    assert set(got_t) == set(saved_t) and set(got_f) == set(saved_f)
    _assert_equal(got_t, saved_t)
    _assert_equal(got_f, saved_f)
    want_t, want_f = _jax_state(jw.trainable, jw.frozen)
    assert set(want_t) == set(got_t) and set(want_f) == set(got_f)
    _assert_equal(got_f, want_f)          # the import, untouched by a step
    for n, t in want_t.items():
        np.testing.assert_allclose(got_t[n].numpy(), t.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=n)
    # the step moved the APLA columns away from the import
    assert not torch.equal(got_t["backbone.blocks.0.attn.proj_wt"],
                           got_f["backbone.blocks.0.attn.proj.kernel"][
                               :, got_f["backbone.blocks.0.attn.inds"]])


def test_supervised_checkpoint_into_ssl_wrappers(supervised_ckpts, capsys):
    """DINOv2's frozen mask token is not in a supervised checkpoint: both
    packages refuse it.  BYOL's backbone is: the backbone alone moves."""
    from apla_tpu.ssl import byol as jb
    from apla_tpu.ssl import dinov2 as jd
    from apla_tpu_torch.ssl import byol as tb
    from apla_tpu_torch.ssl import dinov2 as td
    jdir, tdir, (saved_t, saved_f) = supervised_ckpts
    with pytest.raises(ValueError, match="mask_token"):
        _jax_wrapper(_params("dinov2.yml", transfer=jdir), jd.DINOv2Wrapper)
    with pytest.raises(ValueError, match="mask_token"):
        _port_wrapper(_params("dinov2.yml", transfer=tdir), td.DINOv2Wrapper)
    capsys.readouterr()
    jw = _jax_wrapper(_params("byol.yml", transfer=jdir), jb.BYOLWrapper)
    assert "Transfer-loaded backbone-only weights" in capsys.readouterr().out
    tw = _port_wrapper(_params("byol.yml", transfer=tdir), tb.BYOLWrapper)
    assert "Transfer-loaded backbone-only weights" in capsys.readouterr().out
    got_t, got_f = _state(tw.model)
    names = [n for n in saved_t if n.startswith("backbone.")]
    _assert_equal(got_t, saved_t, names)
    _assert_equal(got_f, saved_f)
    want_t, want_f = _jax_state(jw.trainable, jw.frozen)
    _assert_equal(got_f, want_f)
    for n in names:
        np.testing.assert_allclose(got_t[n].numpy(), want_t[n].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=n)


def test_rank_mismatch_raises(supervised_ckpts):
    jdir, tdir, _ = supervised_ckpts
    with pytest.raises(ValueError, match="shape mismatch"):
        _jax_wrapper(_params(transfer=jdir, partial_size=8))
    with pytest.raises(ValueError, match="shape mismatch"):
        _port_wrapper(_params(transfer=tdir, partial_size=8))


def test_load_parameters(supervised_ckpts):
    jdir, tdir, _ = supervised_ckpts
    assert tckpt.load_parameters(tdir) == jckpt.load_parameters(jdir)
    assert tckpt.load_parameters(tdir)["model_params"]["backbone_type"] \
        == "vit_tiny"
    assert tckpt.load_parameters(os.path.dirname(tdir)) is None


@pytest.fixture(scope="module")
def ssl_ckpts(tmp_path_factory):
    """A JAX DINOv2 wrapper's state saved by both packages, the teacher's
    backbone as the best snapshot (what `Dinov2Trainer` keeps)."""
    from apla_tpu.ssl import dinov2 as jd
    tmp = tmp_path_factory.mktemp("ssl")
    params = _params("dinov2.yml")
    params.dataset_params.synthetic_size = 16
    w = jd.DINOv2Wrapper(params)
    w.instantiate()
    rng = np.random.default_rng(1)
    # a trained-looking student: every trainable moved off the teacher
    student = jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(np.shape(a)).astype(
            np.float32) * 1e-2, w.trainable)
    teacher = jax.tree.map(np.asarray, w.teacher)
    frozen = jax.tree.map(np.asarray, w.frozen)
    jstate = types.SimpleNamespace(trainable=student, opt_state={},
                                   step=np.int32(1))
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")
    jckpt.save_checkpoint(jdir, state=jstate, frozen=frozen,
                          best_trainable=teacher["backbone"])
    st = dinov2_state_from_jax(types.SimpleNamespace(
        trainable=student, teacher=teacher, dino_center=np.zeros((1, 4)),
        ibot_center=np.zeros((1, 4))), frozen)
    t_best, _ = params_from_jax({"backbone": teacher["backbone"]}, {})
    tstate = types.SimpleNamespace(
        step=1, optimizer=types.SimpleNamespace(state_dict=lambda: {}),
        trainable=lambda: st["trainable"], frozen=lambda: st["frozen"])
    tckpt.save_checkpoint(tdir, state=tstate, best_trainable=t_best)
    return jdir, tdir, st, t_best


def test_ssl_checkpoint_into_supervised(ssl_ckpts, capsys):
    """Backbone-only: the APLA columns are the teacher's best snapshot,
    grafted; the frozen backbone adopted whole, its mask token ignored."""
    jdir, tdir, st, t_best = ssl_ckpts
    jw = _jax_wrapper(_params(transfer=jdir))
    assert "Transfer-loaded backbone-only weights" in capsys.readouterr().out
    tw = _port_wrapper(_params(transfer=tdir))
    assert "Transfer-loaded backbone-only weights" in capsys.readouterr().out
    got_t, got_f = _state(tw.model)
    want_t, want_f = _jax_state(jw.trainable, jw.frozen)
    assert set(got_f) == set(want_f)
    assert "backbone.mask_token" not in got_f
    _assert_equal(got_f, want_f)
    bb = [n for n in want_t if n.startswith("backbone.")]
    assert bb and set(bb) == set(t_best)
    _assert_equal(got_t, want_t, bb)
    _assert_equal(got_t, t_best)
    for n in bb:
        assert not torch.equal(got_t[n], st["trainable"][n]), n


def test_ssl_checkpoint_into_dinov2(ssl_ckpts, capsys):
    """The port adopts its own DINOv2 checkpoint in full.  JAX adopts the
    backbone alone: its msgpack reads the DINO head's list of layers back
    as a dict, which never matches the template's list, so its heads keep
    their init; the backbone and the frozen state are the same tensors in
    both."""
    from apla_tpu.ssl import dinov2 as jd
    from apla_tpu_torch.ssl import dinov2 as td
    jdir, tdir, st, t_best = ssl_ckpts
    jw = _jax_wrapper(_params("dinov2.yml", transfer=jdir), jd.DINOv2Wrapper)
    assert "Transfer-loaded backbone-only weights" in \
        capsys.readouterr().out
    tw = _port_wrapper(_params("dinov2.yml", transfer=tdir),
                       td.DINOv2Wrapper)
    assert "Transfer-loaded full weights" in capsys.readouterr().out
    got_t, got_f = _state(tw.model)
    want_t, want_f = _jax_state(jw.trainable, jw.frozen)
    assert set(got_t) == set(want_t) and set(got_f) == set(want_f)
    _assert_equal(got_t, want_t, [n for n in want_t
                                  if n.startswith("backbone.")])
    _assert_equal(got_f, want_f)
    assert torch.equal(got_f["backbone.mask_token"],
                       st["frozen"]["backbone.mask_token"])
    # the trainables: the teacher's backbone grafted over the student's,
    # the student's heads
    for n, t in got_t.items():
        assert torch.equal(t, t_best[n] if n in t_best
                           else st["trainable"][n]), n


def test_adopt_state_strictness():
    """`adopt_state` against `adopt_pytree` on the same trees: extra names
    ignored, a missing name or a shape raises."""
    t = {"a": np.zeros((2, 3), np.float32), "b": {"c": np.ones(4,
                                                             np.float32)}}
    flat = lambda tree: params_from_jax(tree, {})[0]  # noqa: E731
    loaded = {"a": np.full((2, 3), 2, np.float32),
              "b": {"c": np.arange(4, dtype=np.float32)},
              "extra": np.zeros(1, np.float32)}
    want = flat(jckpt.adopt_pytree(t, loaded))
    got = tckpt.adopt_state(flat(t), flat(loaded))
    assert set(got) == set(want) == {"a", "b.c"}
    _assert_equal(got, want)
    for bad, match in (({"a": loaded["a"]}, "missing"),
                       ({**loaded, "a": np.zeros((3, 2), np.float32)},
                        "shape mismatch")):
        with pytest.raises(ValueError, match=match):
            jckpt.adopt_pytree(t, bad)
        with pytest.raises(ValueError, match=match):
            tckpt.adopt_state(flat(t), flat(bad))


def test_cli_trains_from_a_checkpoint(supervised_ckpts, tmp_path,
                                      monkeypatch, capsys):
    """`python -m apla_tpu_torch.main --pretrained_path CKPT` adopts the
    checkpoint, then trains."""
    from apla_tpu_torch import main as tmain
    _, tdir, (saved_t, _) = supervised_ckpts

    def load(path):
        params = _params()
        params.dataset_params.synthetic_size = 32
        for ld in params.dataloader_params.values():
            ld.update(batch_size=16, num_workers=0)
        params.training_params.update(log_every=1, save_dir=str(tmp_path))
        return params
    monkeypatch.setattr(tmain, "load_merged_params", load)
    results = tmain.run_cli(["--params_path", os.path.join(DIR, "apla.yml"),
                             "--pretrained_path", tdir, "--epochs", "1",
                             "--device", "cpu", "--model_name", "tl"])
    out = capsys.readouterr().out
    assert f"Transfer-loaded full weights from {tdir}" in out
    assert "TEST RESULTS" in out and "test_accuracy" in results
