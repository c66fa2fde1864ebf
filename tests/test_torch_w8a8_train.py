"""W8A8 training (`model_params.quantize_frozen`) in the port, against the
JAX package's `DefaultWrapper` with the same knob.

The model is `tests/test_quant.py`'s (2 blocks, C = 64, 4 heads, patch 8
at 32 px, here with LayerScale), registered in both packages' builder
tables as `vit_micro` and built by the wrappers from
`params/synthetic/vit_tiny/apla.yml` in f32; its weights come from one
seeded `.pth` that both wrappers import (the port's head is set to JAX's),
and both quantize the frozen qkv / fc1 / fc2 kernels before building the
optimizer.  Held: the int8 weight codes and scales bit-equal to JAX's; a
three-step AdamW trajectory (clip 1.0, the recipe's optimizer) on the same
b4 batches, at accumulation 1 and 2 and under APLA-16 and APLA "full": every
step's loss and grad norm and the final trainables within 1e-4 (f32, sum
order), the weight codes unchanged, and the int8 product's plain version
(what the wrapper runs on CPU tensors) in every quantized product of every
micro-step.

Why this model: the activations are rounded to int8 per row, so an f32
sum-order difference upstream (1e-7) moves a value across a rounding
boundary now and then, and one code moves an output by about max|x| max|w|
/ 127, ~1% of a typical one at K = 192.  At vit_tiny's 12 blocks a b8
forward rounds ~1.9M activations and JAX and the port part in ~20 codes,
its logits by up to 1.5%: no 1e-4 bound holds there, for any two
implementations.  So each step also checks the precondition: every
activation code of every product of the step's forward is the same in
both packages (at this model and batch none sits on a boundary; at b8
one code of APLA "full"'s second step does).

Then what W8A8 training must keep: no gradient or optimizer state on a
quantized kernel, a trainable bias added outside the int8 product with its
gradient, the "full" projection float, and a checkpoint that saves,
resumes and `test()`s (also into a float model, through
`quantize_like_state`).
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.models import classifier as jclf
from apla_tpu.models import vit as jvit
from apla_tpu.ops import quant as jquant
from apla_tpu.train import losses as jlosses
from apla_tpu.train import steps as jsteps
from apla_tpu.utils.config import load_merged_params
from apla_tpu.wrapper import DefaultWrapper as JWrapper
from apla_tpu_torch.models import classifier as tclf
from apla_tpu_torch.models import vit as tvit
from apla_tpu_torch.ops import int8_matmul as tim
from apla_tpu_torch.ops import quant
from apla_tpu_torch.train import losses as tlosses
from apla_tpu_torch.train import steps as tsteps
from apla_tpu_torch.train.checkpoint import load_checkpoint
from apla_tpu_torch.train.trainer import Trainer
from apla_tpu_torch.utils.pretrained import params_from_jax
from apla_tpu_torch.wrapper import DefaultWrapper
from tests.test_torch_pretrained import _hub

TOL = 1e-4
YML = os.path.join(os.path.dirname(__file__), "..", "params", "synthetic",
                   "vit_tiny", "apla.yml")
N_STEPS, BATCH = 3, 4
DEPTH = 2
MICRO = dict(embed_dim=64, depth=DEPTH, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def vit_micro(monkeypatch):
    """`vit_micro` in both builder tables: `tests/test_quant.py`'s CFG."""
    for mod in (jvit, tvit):
        def build(_cfg=mod.ViTConfig, **kw):
            kw.setdefault("qkv_bias", True)
            return _cfg(**MICRO, **kw)
        monkeypatch.setitem(mod.VIT_BUILDERS, "vit_micro", build)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w8a8") / "micro.pth")
    torch.save(_hub(seed=7), path)
    return path


@pytest.fixture
def int8_calls(monkeypatch):
    """Counts the int8 product's plain version (what `fused_int8_matmul`
    runs on CPU tensors)."""
    calls = {"n": 0}
    fn = tim.fused_int8_matmul_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(tim, "fused_int8_matmul_reference", counted)
    return calls


def _params(pth, partial=16, quantize=True, **training):
    params = load_merged_params(YML)
    params.system_params.device = "cpu"
    params.training_params.use_mixed_precision = False
    params.training_params.update(training)
    params.model_params.pretrained = True
    params.model_params.pretrained_checkpoint = pth
    params.model_params.quantize_frozen = quantize
    params.model_params.adaptation.params.partial_size = partial
    params.model_params.backbone_type = "vit_micro"
    params.model_params.transformers_params.block_conf = {
        "has_layerscale": True, "layerscale_init_values": 1.0}
    return params


def _wrappers(params, capsys):
    jw = JWrapper(params)
    jw.model_params.n_classes = 10
    jw.mesh = jw.init_mesh()
    jw.init_model()
    assert "Quantized frozen backbone kernels to int8 (W8A8)" in \
        capsys.readouterr().out
    tw = DefaultWrapper(params)
    tw.model_params.n_classes = 10
    tw.init_model()
    assert "Quantized frozen backbone kernels to int8 (W8A8)" in \
        capsys.readouterr().out
    with torch.no_grad():
        for leaf in ("kernel", "bias"):
            getattr(tw.model.fc, leaf).copy_(torch.from_numpy(
                np.array(jw.trainable["fc"][leaf])))
    loaders = types.SimpleNamespace(trainloader=[None] * 4)
    for w in (jw, tw):
        w.dataloaders = loaders
        w.init_optimization()
    return jw, tw


def _activation_codes(jw, jstate, tw, x, monkeypatch):
    """The int8 activation codes of every quantized product of one forward
    of `x`, in order: (JAX's, the port's)."""
    jcodes, tcodes = [], []
    rows = jquant._quantize_rows

    def jrec(xf):
        x_i8, scale = rows(xf)
        jax.debug.callback(lambda c: jcodes.append(np.asarray(c)), x_i8,
                           ordered=True)
        return x_i8, scale
    with monkeypatch.context() as m:
        m.setattr(jquant, "_quantize_rows", jrec)
        jax.clear_caches()      # int8_matmul's trace is cached by function
        host = functools.partial(jax.tree.map, np.asarray)  # one device
        jax.block_until_ready(jclf.classifier_forward(
            host(jstate.trainable), host(jw.frozen), jnp.asarray(x),
            jw.vit_cfg))
        jax.effects_barrier()
    jax.clear_caches()
    ref = tim.fused_int8_matmul_reference

    def trec(xt, *args, **kwargs):
        tcodes.append(quant._quantize_rows(xt)[0].numpy())
        return ref(xt, *args, **kwargs)
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(tim, "fused_int8_matmul_reference", trec)
        tclf.classifier_forward(tw.model, torch.from_numpy(x), tw.vit_cfg)
    return [c.reshape(-1, c.shape[-1]) for c in jcodes], tcodes


def _codes(state: dict) -> dict:
    return {n: t for n, t in state.items()
            if n.endswith((".kernel.w_int8", ".kernel.scale"))}


@pytest.mark.parametrize("partial", [16, "full"])
@pytest.mark.parametrize("accum", [1, 2])
def test_w8a8_trajectory_matches_jax(partial, accum, pth, capsys,
                                     int8_calls, monkeypatch):
    jw, tw = _wrappers(_params(pth, partial), capsys)
    _, want_f = params_from_jax(jax.tree.map(np.asarray, jw.trainable),
                                jax.tree.map(np.asarray, jw.frozen))
    codes = _codes(want_f)
    assert len(codes) == 2 * 3 * DEPTH
    state = tw.model.state_dict()
    for n, t in codes.items():
        assert state[n].dtype == t.dtype and torch.equal(state[n], t), n
    jstep = jsteps.make_train_step(jw.vit_cfg, jw.tx, jlosses.cross_entropy,
                                   accum_steps=accum)
    tstep = tsteps.make_train_step(tw.vit_cfg, tw.optimizer,
                                   tlosses.cross_entropy, accum_steps=accum)
    jstate, tstate = jw.state, tw.state
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    int8_calls["n"] = 0
    for i in range(N_STEPS):
        x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, BATCH)
        lr = 1e-3 * (i + 1) / N_STEPS
        calls = int8_calls["n"]
        jc, tc = _activation_codes(jw, jstate, tw, x, monkeypatch)
        int8_calls["n"] = calls
        assert len(jc) == len(tc) == 3 * DEPTH
        for k, (a, b) in enumerate(zip(jc, tc)):
            assert np.array_equal(a, b), f"step {i}: product {k}"
        jstate, jm = jstep(jstate, jw.frozen, {"image": jnp.asarray(x),
                                               "label": jnp.asarray(y)},
                           lr, jax.random.PRNGKey(0))
        tstate, m = tstep(tstate, {"image": torch.from_numpy(x),
                                   "label": torch.from_numpy(y)}, lr, gen)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{key} step {i}")
    # qkv, fc1, fc2 of every block of every micro-step (forward only: the
    # backward is the plain dequantised product)
    assert int8_calls["n"] == 3 * DEPTH * accum * N_STEPS
    want_t, _ = params_from_jax(jax.tree.map(np.asarray, jstate.trainable),
                                jax.tree.map(np.asarray, jw.frozen))
    got_t = tstate.trainable()
    assert set(got_t) == set(want_t)
    for n, t in want_t.items():
        np.testing.assert_allclose(got_t[n].detach().numpy(), t.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=n)
    state = tw.model.state_dict()
    for n, t in codes.items():
        assert torch.equal(state[n], t), n


def test_no_gradient_or_optimizer_state_on_int8(pth, capsys):
    jw, tw = _wrappers(_params(pth), capsys)
    model = tw.model
    quantized = [d.kernel for d in quant._candidates(model)]
    assert len(quantized) == 3 * DEPTH and all(
        isinstance(k, quant.QuantizedKernel) for k in quantized)
    assert not any(p.requires_grad for k in quantized
                   for p in k.parameters())
    live = {n for n, p in model.named_parameters() if p.requires_grad}
    assert live == {f"backbone.blocks.{i}.attn.{leaf}" for i in range(DEPTH)
                    for leaf in ("proj_wt", "proj_bt")} | {"fc.kernel",
                                                          "fc.bias"}
    step = tsteps.make_train_step(tw.vit_cfg, tw.optimizer,
                                  tlosses.cross_entropy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    step(tw.state, {"image": x, "label": torch.arange(4)}, 1e-3,
         torch.Generator())
    params = {id(p) for p in tw.optimizer.params}
    assert params == {id(p) for n, p in model.named_parameters()
                      if n in live}
    held = set()
    for state in tw.optimizer.state_dict()["state"].values():
        held |= {k for k in state if torch.is_tensor(state[k])}
    assert held          # AdamW moments exist for the trainables only
    # the frozen biases of the quantized products stay frozen
    for dense in quant._candidates(model):
        assert not dense.bias.requires_grad and dense.bias.grad is None


def test_trainable_bias_added_outside_the_kernel(int8_calls):
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    qk = quant.QuantizedKernel(*quant.quantize_weight(w))
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32)) \
        .requires_grad_(True)
    bias = torch.from_numpy(rng.standard_normal(8).astype(np.float32)) \
        .requires_grad_(True)
    y = quant.maybe_quantized_dot(x, qk, bias)
    y_frozen = quant.maybe_quantized_dot(x, qk, bias.detach())
    torch.testing.assert_close(y, y_frozen, rtol=0, atol=0)
    g = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    y.backward(g)
    torch.testing.assert_close(bias.grad, g.sum(0))
    torch.testing.assert_close(
        x.grad, g @ quant.dequantize_weight(qk.w_int8, qk.scale).t())
    with pytest.raises(ValueError, match="frozen bias"):
        quant.int8_matmul(x, qk.w_int8, qk.scale, bias=bias)


def test_full_mode_projection_stays_float(pth, capsys):
    jw, tw = _wrappers(_params(pth, "full"), capsys)
    for blk in tw.model.backbone.blocks:
        assert isinstance(blk.attn.proj.kernel, torch.nn.Parameter)
        assert blk.attn.proj.kernel.requires_grad
        assert isinstance(blk.attn.qkv.kernel, quant.QuantizedKernel)
    assert "kernel" in jw.trainable["backbone"]["blocks"]["attn"]["proj"]


def _tiny_run(pth, tmp_path, quantize=True):
    params = _params(pth, quantize=quantize, epochs=1, log_every=1,
                     save_dir=str(tmp_path), model_name="w8a8")
    params.dataset_params.synthetic_size = 32
    for ld in params.dataloader_params.values():
        ld.update(batch_size=16, num_workers=0)
    w = DefaultWrapper(params)
    w.instantiate()
    return Trainer(w)


def test_checkpoint_saves_resumes_and_tests(pth, tmp_path, capsys):
    trainer = _tiny_run(pth, tmp_path)
    before = {n: t.clone() for n, t in trainer.state.frozen().items()}
    trainer.train()
    results = trainer.test()
    frozen = trainer.state.frozen()
    assert set(frozen) == set(before)
    assert not any(n.endswith("w_kmajor") for n in frozen)
    for n, t in frozen.items():
        assert torch.equal(t, before[n]), n
    saved = torch.load(os.path.join(trainer.checkpoint_path, "frozen.pt"))
    assert set(saved) == set(frozen)
    assert saved["backbone.blocks.0.mlp.fc1.kernel.w_int8"].dtype \
        == torch.int8
    for quantize in (True, False):
        other = _tiny_run(pth, tmp_path / str(quantize), quantize=quantize)
        _, best = load_checkpoint(trainer.checkpoint_path, other.state)
        state, want = other.state.model.state_dict(), \
            trainer.state.model.state_dict()
        assert set(state) == set(want)
        for n, t in want.items():
            assert torch.equal(state[n], t), n
        # the K-major copy the kernel reads was made anew at the load
        for dense in quant._candidates(other.state.model):
            assert torch.equal(dense.kernel.w_kmajor,
                               dense.kernel.w_int8.t())
        assert other.test(chpt_path=trainer.checkpoint_path) == results
