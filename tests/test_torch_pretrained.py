"""DINOv2 checkpoint import into the port, against the JAX package.

A seeded DINO-style torch ViT (`tests/test_torch_parity.py:TorchViT`, 2
blocks, C = 64, 4 heads, LayerScale) writes its state dict in the public
layouts: the torch.hub `blocks.i.*` layout, with the `module.` / `backbone.`
prefixes, the chunked `blocks.c.i.*` layout, separate q / k / v, the older
`gamma_1` LayerScale names, register and mask tokens, SwiGLU `w12` / `w3`,
and Hugging Face `Dinov2Model`, each from the same tensors.  Every layout
must give port tensors bit-equal to the JAX converter's output carried
across by `params_from_jax`; `export_torch_vit_state_dict` must invert the
import; `load_torch_checkpoint` must unwrap the training checkpoints'
wrappers; `maybe_load_pretrained_backbone` must leave a classifier (APLA-k,
APLA "full", full fine-tune, linear probe) with the JAX result's trainable
and frozen tensors, bit for bit, and warn and keep the seeded init without a
file; the wrappers (supervised, DINOv2) must import through
`model_params.pretrained`.  The imported model's forward is held against the
torch model's in f32 (rtol = atol = 1e-4: sum order only).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.models import classifier as jclf
from apla_tpu.models.vit import ViTConfig as JViTConfig
from apla_tpu.utils import pretrained as jpre
from apla_tpu_torch.models import classifier as tclf
from apla_tpu_torch.models.vit import ViTConfig, vit_features
from apla_tpu_torch.utils import pretrained as tpre
from apla_tpu_torch.utils.pretrained import params_from_jax
from tests.test_torch_parity import TorchViT

TOL = 1e-4
DEPTH, DIM, HEADS = 2, 64, 4
TINY = dict(img_size=32, patch_size=8, embed_dim=DIM, depth=DEPTH,
            num_heads=HEADS, has_layerscale=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_vit(seed=0):
    torch.manual_seed(seed)
    return TorchViT(layerscale=0.5).eval()


def _hub(seed=0) -> dict:
    """The torch.hub layout of the seeded model (detached tensors); the
    LayerScale of each block made distinct so a swap would show."""
    sd = {k: v.detach().clone()
          for k, v in _torch_vit(seed).dinov2_state_dict().items()}
    rng = np.random.default_rng(seed)
    for i in range(DEPTH):
        for ls in ("ls1", "ls2"):
            sd[f"blocks.{i}.{ls}.gamma"] = torch.from_numpy(
                rng.uniform(0.1, 1.0, DIM).astype(np.float32))
    return sd


def _extras(seed=1) -> dict:
    rng = np.random.default_rng(seed)
    return {"register_tokens": torch.from_numpy(
                rng.standard_normal((1, 4, DIM)).astype(np.float32)),
            "mask_token": torch.from_numpy(
                rng.standard_normal((1, DIM)).astype(np.float32))}


def _chunked(sd):
    """DINOv2's BlockChunk layout: block i of chunk c as `blocks.c.i.`."""
    out = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            i = int(k.split(".")[1])
            k = f"blocks.{i}.{k[len('blocks.'):]}"
        out[k] = v
    return out


def _sep_qkv(sd):
    out = {}
    for k, v in sd.items():
        if k.endswith("attn.qkv.weight") or k.endswith("attn.qkv.bias"):
            pre, leaf = k.rsplit(".qkv.", 1)
            for n, part in zip("qkv", v.chunk(3, dim=0)):
                out[f"{pre}.{n}.{leaf}"] = part.clone()
        else:
            out[k] = v
    return out


def _old_gamma(sd):
    return {k.replace("ls1.gamma", "gamma_1").replace("ls2.gamma",
                                                      "gamma_2"): v
            for k, v in sd.items()}


def _swiglu(sd, seed=2):
    rng = np.random.default_rng(seed)
    hidden = 64
    out = {k: v for k, v in sd.items() if ".mlp." not in k}
    for i in range(DEPTH):
        for name, shape in (("w12", (2 * hidden, DIM)), ("w3", (DIM, hidden))):
            out[f"blocks.{i}.mlp.{name}.weight"] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
            out[f"blocks.{i}.mlp.{name}.bias"] = torch.from_numpy(
                rng.standard_normal(shape[0]).astype(np.float32))
    return out


def _hf(sd):
    """The same tensors in Hugging Face `Dinov2Model` naming."""
    out = {"embeddings.patch_embeddings.projection.weight":
           sd["patch_embed.proj.weight"],
           "embeddings.patch_embeddings.projection.bias":
           sd["patch_embed.proj.bias"],
           "embeddings.cls_token": sd["cls_token"],
           "embeddings.position_embeddings": sd["pos_embed"],
           "layernorm.weight": sd["norm.weight"],
           "layernorm.bias": sd["norm.bias"]}
    for name in ("mask_token", "register_tokens"):
        if name in sd:
            out[f"embeddings.{name}"] = sd[name]
    for i in range(DEPTH):
        p, b = f"blocks.{i}.", f"encoder.layer.{i}."
        for n, w, bias in zip(("query", "key", "value"),
                              sd[p + "attn.qkv.weight"].chunk(3),
                              sd[p + "attn.qkv.bias"].chunk(3)):
            out[f"{b}attention.attention.{n}.weight"] = w.clone()
            out[f"{b}attention.attention.{n}.bias"] = bias.clone()
        for ours, theirs in (("attn.proj", "attention.output.dense"),
                             ("norm1", "norm1"), ("norm2", "norm2"),
                             ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                out[f"{b}{theirs}.{leaf}"] = sd[f"{p}{ours}.{leaf}"]
        out[b + "layer_scale1.lambda1"] = sd[p + "ls1.gamma"]
        out[b + "layer_scale2.lambda1"] = sd[p + "ls2.gamma"]
    return out


LAYOUTS = {
    "hub": lambda: _hub(),
    "prefixed": lambda: {f"module.backbone.{k}": v
                         for k, v in _hub().items()},
    "chunked": lambda: _chunked(_hub()),
    "sep_qkv": lambda: _sep_qkv(_hub()),
    "gamma_1": lambda: _old_gamma(_hub()),
    "tokens": lambda: {**_hub(), **_extras()},
    "swiglu": lambda: _swiglu(_hub()),
    "hf": lambda: _hf({**_hub(), **_extras()}),
}


def _jax_state(tree):
    """A JAX ViT tree (numpy or jnp leaves) -> the port's bare names."""
    return params_from_jax(jax.tree.map(np.asarray, tree), {})[0]


def _assert_equal_states(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_converter_matches_jax(layout):
    sd = LAYOUTS[layout]()
    swiglu = layout == "swiglu"
    if layout == "hf":
        want = _jax_state(jpre.convert_vit_hf_dinov2_state_dict(sd, DEPTH))
        got = tpre.convert_vit_hf_dinov2_state_dict(sd, DEPTH)
    else:
        want = _jax_state(jpre.convert_torch_vit_state_dict(
            sd, DEPTH, use_swiglu=swiglu, has_layerscale=True))
        got = tpre.convert_torch_vit_state_dict(
            sd, DEPTH, use_swiglu=swiglu, has_layerscale=True)
    _assert_equal_states(got, want)
    # every layout of the same tensors gives the same port state
    if layout in ("prefixed", "chunked", "sep_qkv", "gamma_1"):
        _assert_equal_states(got, tpre.convert_torch_vit_state_dict(
            _hub(), DEPTH, has_layerscale=True))
    if layout == "hf":
        _assert_equal_states(got, tpre.convert_torch_vit_state_dict(
            {**_hub(), **_extras()}, DEPTH, has_layerscale=True))


def test_layerscale_only_when_configured():
    got = tpre.convert_torch_vit_state_dict(_hub(), DEPTH)
    assert not any(".ls" in n for n in got)
    _assert_equal_states(got, _jax_state(
        jpre.convert_torch_vit_state_dict(_hub(), DEPTH)))


@pytest.mark.parametrize("layout", ["hub", "tokens", "swiglu"])
def test_export_round_trip(layout):
    sd = LAYOUTS[layout]()
    swiglu = layout == "swiglu"
    state = tpre.convert_torch_vit_state_dict(sd, DEPTH, use_swiglu=swiglu,
                                              has_layerscale=True)
    back = tpre.export_torch_vit_state_dict(state, use_swiglu=swiglu)
    want = {k: torch.from_numpy(np.array(v)) for k, v in
            jpre.export_torch_vit_state_dict(
                jpre.convert_torch_vit_state_dict(
                    sd, DEPTH, use_swiglu=swiglu, has_layerscale=True),
                use_swiglu=swiglu).items()}
    _assert_equal_states(back, want)
    _assert_equal_states(back, {k: v.float() for k, v in sd.items()})
    with pytest.raises(ValueError, match="merge"):
        tpre.export_torch_vit_state_dict(
            {**state, "blocks.0.attn.proj_wt": torch.zeros(1)})


@pytest.mark.parametrize("wrapper", [None, "teacher", "student", "model",
                                     "state_dict"])
def test_load_torch_checkpoint_unwraps(wrapper, tmp_path):
    sd = _hub()
    path = str(tmp_path / "ckpt.pth")
    torch.save(sd if wrapper is None else {wrapper: sd, "epoch": 3}, path)
    got, want = tpre.load_torch_checkpoint(path), \
        jpre.load_torch_checkpoint(path)
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], sd[k])


MODES = {
    "apla_k": dict(apla_cfg=JAplaConfig(partial_size=8)),
    "apla_full": dict(apla_cfg=JAplaConfig(partial_size="full")),
    "full_finetune": dict(),
    "linear_probe": dict(freeze_backbone=True),
}


def _classifier(mode):
    """A JAX classifier's trees (f32) and the port's module on the same
    weights (and the same APLA indices)."""
    jcfg = JViTConfig(compute_dtype=jnp.float32, **TINY)
    tcfg = ViTConfig(compute_dtype=torch.float32, **TINY)
    trainable, frozen = jclf.init_classifier(jax.random.PRNGKey(3), jcfg, 10,
                                             **MODES[mode])
    trainable = jax.tree.map(np.asarray, trainable)
    frozen = jax.tree.map(np.asarray, frozen)
    model = tclf.classifier_from_state(tcfg, *params_from_jax(trainable,
                                                              frozen),
                                       torch.device("cpu"))
    return jcfg, tcfg, trainable, frozen, model


def _split(model):
    state = model.state_dict()
    live = {n for n, p in model.named_parameters() if p.requires_grad}
    return ({n: t for n, t in state.items() if n in live},
            {n: t for n, t in state.items() if n not in live})


@pytest.mark.parametrize("layout", ["hub", "hf", "tokens"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_maybe_load_pretrained_backbone_matches_jax(mode, layout, tmp_path):
    path = str(tmp_path / "dinov2.pth")
    torch.save({"teacher": LAYOUTS[layout]()}, path)
    mp = {"pretrained": True, "pretrained_checkpoint": path}
    jcfg, tcfg, trainable, frozen, model = _classifier(mode)
    j_t, j_f = jpre.maybe_load_pretrained_backbone(trainable, frozen, mp,
                                                   jcfg)
    want_t, want_f = params_from_jax(jax.tree.map(np.asarray, j_t),
                                     jax.tree.map(np.asarray, j_f))
    assert tpre.maybe_load_pretrained_backbone(model.backbone, mp, tcfg)
    got_t, got_f = _split(model)
    _assert_equal_states(got_t, want_t)
    _assert_equal_states(got_f, want_f)
    if mode == "apla_k":        # the trainable columns are the projection's
        for i, blk in enumerate(model.backbone.blocks):
            assert torch.equal(blk.attn.proj_wt,
                               blk.attn.proj.kernel[:, blk.attn.inds])
    # the imported model answers as the JAX one does
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    j_logits = jclf.classifier_forward(j_t, j_f, jnp.asarray(x), jcfg)
    with torch.no_grad():
        t_logits = tclf.classifier_forward(model, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)


def test_imported_backbone_matches_the_torch_model(tmp_path):
    """The port's ViT features of the imported checkpoint = the torch
    model's own forward (exact GELU, f32)."""
    ref = _torch_vit()
    sd = {k: v.detach() for k, v in ref.dinov2_state_dict().items()}
    path = str(tmp_path / "hub.pth")
    torch.save(sd, path)
    _, tcfg, _, _, model = _classifier("apla_k")
    tpre.maybe_load_pretrained_backbone(
        model.backbone, {"pretrained_checkpoint": path}, tcfg)
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        got = vit_features(model.backbone, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_missing_checkpoint_warns_and_keeps_the_init(tmp_path):
    mp = {"pretrained": True,
          "pretrained_checkpoint": str(tmp_path / "absent.pth")}
    jcfg, tcfg, trainable, frozen, model = _classifier("apla_k")
    before = {n: t.clone() for n, t in model.state_dict().items()}
    with pytest.warns(UserWarning, match="no local checkpoint found") as rec:
        assert not tpre.maybe_load_pretrained_backbone(model.backbone, mp,
                                                       tcfg)
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        jpre.maybe_load_pretrained_backbone(trainable, frozen, mp, jcfg)
    assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
    for n, t in model.state_dict().items():
        assert torch.equal(t, before[n]), n


def _wrapper_params(tmp_path, pretrained_path, yml="apla.yml"):
    from apla_tpu.utils.config import load_merged_params
    params = load_merged_params(os.path.join(
        os.path.dirname(__file__), "..", "params", "synthetic", "vit_tiny",
        yml))
    params.model_params.pretrained = True
    params.model_params.pretrained_checkpoint = pretrained_path
    params.system_params.device = "cpu"
    params.training_params.save_dir = str(tmp_path)
    return params


def _vit_tiny_hub(seed=6, mask_token=False):
    """A seeded hub-layout vit_tiny (12 x 192, patch 8 at 32 px, no
    LayerScale) state dict."""
    rng = np.random.default_rng(seed)
    d, h = 192, 768

    def t(*shape):
        return torch.from_numpy(
            (0.02 * rng.standard_normal(shape)).astype(np.float32))
    sd = {"cls_token": t(1, 1, d), "pos_embed": t(1, 17, d),
          "patch_embed.proj.weight": t(d, 3, 8, 8),
          "patch_embed.proj.bias": t(d), "norm.weight": 1 + t(d),
          "norm.bias": t(d)}
    for i in range(12):
        p = f"blocks.{i}."
        for name, shape in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                            ("mlp.fc1", (h, d)), ("mlp.fc2", (d, h))):
            sd[p + name + ".weight"] = t(*shape)
            sd[p + name + ".bias"] = t(shape[0])
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"] = 1 + t(d)
            sd[p + n + ".bias"] = t(d)
    if mask_token:
        sd["mask_token"] = t(1, d)
    return sd


def test_supervised_wrapper_imports_like_jax(tmp_path):
    """`model_params.pretrained` through both `DefaultWrapper.init_model`s:
    the backbone's tensors (frozen and the APLA columns) bit-equal."""
    from apla_tpu.wrapper import DefaultWrapper as JWrapper
    from apla_tpu_torch.wrapper import DefaultWrapper
    path = str(tmp_path / "tiny.pth")
    torch.save(_vit_tiny_hub(), path)
    params = _wrapper_params(tmp_path, path)
    jw = JWrapper(params)
    jw.model_params.n_classes = 10
    jw.mesh = jw.init_mesh()
    jw.init_model()
    tw = DefaultWrapper(params)
    tw.model_params.n_classes = 10
    tw.init_model()
    want_t, want_f = params_from_jax(jax.tree.map(np.asarray, jw.trainable),
                                     jax.tree.map(np.asarray, jw.frozen))
    got_t, got_f = _split(tw.model)
    _assert_equal_states(got_f, want_f)
    # the head is the seeded init of each package; the backbone's columns
    # come from the file
    assert set(got_t) == set(want_t)
    for n in want_t:
        if n.startswith("backbone."):
            assert torch.equal(got_t[n], want_t[n]), n


@pytest.mark.parametrize("mask_token", [False, True])
def test_dinov2_wrapper_mask_token(mask_token, tmp_path):
    """The DINOv2 wrapper imports before its teacher copy and keeps its own
    mask token when the checkpoint has none (JAX: `ssl/dinov2.py:
    869-889`)."""
    from apla_tpu_torch.ssl.dinov2 import DINOv2Wrapper
    sd = _vit_tiny_hub(mask_token=mask_token)
    path = str(tmp_path / "tiny.pth")
    torch.save(sd, path)
    seeded = DINOv2Wrapper(_wrapper_params(tmp_path, "", "dinov2.yml"))
    seeded.model_params.n_classes = 10
    with pytest.warns(UserWarning, match="no local checkpoint found"):
        seeded.init_model()
    w = DINOv2Wrapper(_wrapper_params(tmp_path, path, "dinov2.yml"))
    w.model_params.n_classes = 10
    w.init_model()
    token = w.model.backbone.mask_token
    assert not token.requires_grad
    want = sd["mask_token"].reshape(1, 1, -1) if mask_token \
        else seeded.model.backbone.mask_token
    assert torch.equal(token, want)
    assert torch.equal(w.model.backbone.blocks[3].attn.qkv.kernel,
                       sd["blocks.3.attn.qkv.weight"].t())
    w.dataloaders = type("L", (), {"trainloader": [0]})()
    w.init_optimization()
    for n, t in w.state.teacher.items():
        assert torch.equal(t, w.state.trainable()[n]), n
