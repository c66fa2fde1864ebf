"""The port's W8A8 path against the JAX package: `ops/int8_matmul.py` (the
int8 kernel's plain version), `ops/quant.py` and the quantized classifier,
segmenter and detector artifacts.

The same numpy inputs go to both.  Tolerances, each with its reason:

- `quantize_weight`: codes equal, scales within 1 f32 ulp.
- `fused_int8_matmul`'s plain version against JAX's row-13 kernel
  (`pallas_int8_matmul.fused_int8_matmul`, Pallas interpreter): float32
  within 2 f32 ulps of max|ref| (XLA orders the two scale products of the
  kernel body its own way: one ulp seen), bfloat16 within one bf16 ulp of
  max|ref| (2^-7 max|ref|: that f32 ulp can cross a bf16 rounding
  boundary).
- with one group over K against `quant.int8_matmul`: equal, in both dtypes.
- ragged M (the kernel masks it, row 13 cannot take it) against a numpy
  blockwise reference: rtol = atol = 1e-5.
- `int8_matmul`'s gradient against `jax.grad`: 1e-5.
- `maybe_quantized_dot` with a `QuantizedKernel` and a bias (a frozen one
  goes into `int8_matmul`, whose kernel adds it after the rounding; its
  plain version here) against JAX's on the quant dict: equal, in both
  dtypes (the same two roundings, then one add in f32 and a rounding).
- the quantized classifier, segmenter and detector in float32 against
  JAX's: rtol = atol = 1e-4, the bound of the float artifacts.  Upstream
  sums in another order could move an activation across a rounding
  boundary and flip one int8 code; none flipped at these sizes (the
  logits agree to 1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn
from apla_tpu.ops import pallas_int8_matmul as pim
from apla_tpu.ops import quant as jquant
from apla_tpu_torch import serve as tserve
from apla_tpu_torch.ops import quant as tquant
from apla_tpu_torch.ops import int8_matmul as tim
from apla_tpu_torch.ops.int8_matmul import (fused_int8_matmul,
                                            fused_int8_matmul_reference,
                                            int8_plan)

F32_ULPS = 2
BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    pim.INTERPRET = True
    pallas_apla_attn.INTERPRET = True
    monkeypatch.setenv("APLA_FUSED_MIN_N", "0")
    yield
    pim.INTERPRET = False
    pallas_apla_attn.INTERPRET = False


def _operands(m, k, n, seed):
    """x [m, k] (normal), w [k, n] (normal * 0.05), float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.05).astype(np.float32))


def _quantized(w):
    """JAX's (w_int8, scale) as numpy, and the port's as tensors."""
    jw, js = jquant.quantize_weight(jnp.asarray(w))
    return (np.asarray(jw), np.asarray(js)), tquant.quantize_weight(
        torch.from_numpy(w))


def _f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) \
        if not isinstance(t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("shape,seed", [((64, 128), 0), ((768, 2304), 1),
                                        ((96, 288), 2)])
def test_quantize_weight_matches_jax(shape, seed):
    w = _operands(1, *shape, seed)[1]
    (jw, js), (tw, ts) = _quantized(w)
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=1)
    back = tquant.dequantize_weight(tw, ts).numpy()
    np.testing.assert_array_equal(back, np.asarray(
        jquant.dequantize_weight(jnp.asarray(jw), jnp.asarray(js))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_row13_kernel(dtype):
    """Groups of 128 over K = 512 (4 groups), against the TPU kernel in the
    interpreter at blocks of 128."""
    x, w = _operands(256, 512, 128, seed=3)
    (jw, js), (tw, ts) = _quantized(w)
    ref = _f32(pim.fused_int8_matmul(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(jw),
        jnp.asarray(js), block_m=128, block_n=128, block_k=128))
    got = fused_int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                            tw, ts, group=128)
    assert got.shape == (256, 128) and got.dtype == getattr(torch, dtype)
    err = np.abs(_f32(got) - ref).max()
    bound = (F32_ULPS * 2.0 ** -23 if dtype == "float32" else BF16_REL) \
        * np.abs(ref).max()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_group_is_int8_matmul(dtype):
    """group = K computes `quant.int8_matmul`'s forward exactly; so does the
    port's `int8_matmul` on [..., K] activations."""
    x, w = _operands(96, 768, 256, seed=4)
    (jw, js), (tw, ts) = _quantized(w)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = _f32(jquant.int8_matmul(jx, jnp.asarray(jw), jnp.asarray(js)))
    np.testing.assert_array_equal(_f32(fused_int8_matmul(tx, tw, ts,
                                                         group=768)), ref)
    got = tquant.int8_matmul(tx.reshape(4, 24, 768), tw, ts)
    assert got.shape == (4, 24, 256) and got.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(got).reshape(96, 256), ref)


@pytest.mark.parametrize("m,group", [(37, 128), (129, 64), (1, 384)])
def test_ragged_rows_against_a_blockwise_reference(m, group):
    """Any M (row 13 needs multiples of its block), against the kernel's
    function written out in numpy group by group."""
    x, w = _operands(m, 384, 96, seed=m)
    _, (tw, ts) = _quantized(w)
    got = fused_int8_matmul(torch.from_numpy(x), tw, ts, group=group)
    acc = np.zeros((m, 96), np.float32)
    for k0 in range(0, 384, group):
        xb = x[:, k0:k0 + group]
        sx = np.maximum(np.abs(xb).max(axis=1, keepdims=True) / 127.0,
                        np.float32(1e-12))
        xi = np.clip(np.round(xb / sx), -127, 127).astype(np.int32)
        part = xi @ tw.numpy()[k0:k0 + group].astype(np.int32)
        acc += part.astype(np.float32) * sx * ts.numpy()[None, :]
    np.testing.assert_allclose(got.numpy(), acc, rtol=1e-5, atol=1e-5)


def test_plain_checks_its_arguments():
    x = torch.zeros(4, 96)
    w, s = tquant.quantize_weight(torch.randn(96, 16))
    with pytest.raises(ValueError, match="does not divide"):
        fused_int8_matmul(x, w, s, group=64)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_int8_matmul(x.half(), w, s, group=96)
    with pytest.raises(ValueError, match="int8"):
        fused_int8_matmul(x, w.float(), s, group=96)
    with pytest.raises(ValueError, match="no int8 kernel for device"):
        fused_int8_matmul(x.to("meta"), w.to("meta"), s.to("meta"), 96)


def test_int8_matmul_gradient_matches_jax():
    """dx = g @ dequant(W)^T through the autograd Function, against the
    JAX custom VJP (float32)."""
    x, w = _operands(32, 64, 96, seed=5)
    g = np.random.default_rng(6).standard_normal((32, 96)).astype(np.float32)
    (jw, js), (tw, ts) = _quantized(w)
    j_dx = jax.vjp(lambda a: jquant.int8_matmul(a, jnp.asarray(jw),
                                                jnp.asarray(js)),
                   jnp.asarray(x))[1](jnp.asarray(g))[0]
    tx = torch.from_numpy(x).requires_grad_(True)
    tquant.int8_matmul(tx, tw, ts).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), rtol=1e-5,
                               atol=1e-5)
    # and jax.grad of a scalar loss through it
    j_grad = jax.grad(lambda a: jnp.sum(jquant.int8_matmul(
        a, jnp.asarray(jw), jnp.asarray(js)) ** 2))(jnp.asarray(x))
    tx.grad = None
    (tquant.int8_matmul(tx, tw, ts) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_matches_jax_maybe_quantized_dot(dtype, bias_dtype):
    """A frozen bias through `int8_matmul` (the plain version of the
    kernel's epilogue: y rounded, + bias rounded to y's dtype, rounded)
    equals JAX's `maybe_quantized_dot`, which adds it after the product;
    so does `fused_int8_matmul_reference(..., bias=...)`."""
    x, w = _operands(96, 768, 256, seed=7)
    b = (np.random.default_rng(8).standard_normal(256) * 0.5).astype(
        np.float32)
    (jw, js), (tw, ts) = _quantized(w)
    ref = _f32(jquant.maybe_quantized_dot(
        jnp.asarray(x, getattr(jnp, dtype)),
        {"w_int8": jnp.asarray(jw), "scale": jnp.asarray(js)},
        jnp.asarray(b, getattr(jnp, bias_dtype))))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, bias_dtype))
    got = tquant.maybe_quantized_dot(tx.reshape(4, 24, 768),
                                     tquant.QuantizedKernel(tw, ts), tb)
    assert got.shape == (4, 24, 256) and got.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(got).reshape(96, 256), ref)
    np.testing.assert_array_equal(
        _f32(fused_int8_matmul_reference(tx, tw, ts, 768, tb)), ref)
    np.testing.assert_array_equal(
        _f32(fused_int8_matmul(tx, tw, ts, 768, bias=tb)), ref)


def test_only_a_frozen_bias_goes_into_the_kernel(monkeypatch):
    """`maybe_quantized_dot` hands a frozen bias to the int8 product (the
    kernel adds it in its epilogue) and adds a trainable one after it, so
    that its gradient flows; both give the same values.  `int8_matmul`
    refuses a trainable bias."""
    seen = []
    real = tquant.fused_int8_matmul

    def spy(*args, **kwargs):
        seen.append(kwargs.get("bias"))
        return real(*args, **kwargs)
    monkeypatch.setattr(tquant, "fused_int8_matmul", spy)
    x, w = _operands(12, 64, 16, seed=9)
    _, (tw, ts) = _quantized(w)
    qk = tquant.QuantizedKernel(tw, ts)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    frozen = torch.linspace(-1, 1, 16)
    trainable = frozen.clone().requires_grad_(True)
    y_frozen = tquant.maybe_quantized_dot(tx, qk, frozen)
    assert seen[-1] is frozen
    y_trainable = tquant.maybe_quantized_dot(tx, qk, trainable)
    assert seen[-1] is None
    assert torch.equal(y_frozen, y_trainable.detach())
    y_trainable.float().sum().backward()
    assert torch.equal(trainable.grad, torch.full((16,), 12.0))
    with pytest.raises(ValueError, match="frozen bias"):
        tquant.int8_matmul(tx, tw, ts, qk.w_kmajor, trainable)


def test_plain_checks_the_bias():
    x = torch.zeros(4, 96)
    w, s = tquant.quantize_weight(torch.randn(96, 16))
    with pytest.raises(ValueError, match="bias must be"):
        fused_int8_matmul(x, w, s, 96, bias=torch.zeros(15))
    with pytest.raises(ValueError, match="bias must be"):
        fused_int8_matmul(x, w, s, 96, bias=torch.zeros(16).half())


# (M, N, K, group, x dtype) -> (BN, stages): chip_smoke.py phase 10a's
# shapes (the plans it measured), the segmenter's fc1 b8, the Swin stage-0
# fc2 and fc2 b64 in f32 (one group, groups of 256), and the edges: M = 1,
# K = 96, N = 288 (not a multiple of any tile width), groups of 256 and 32
PLANS = [
    ((8 * 1025, 4096, 1024, 1024, torch.bfloat16), (128, 3)),
    ((16 * 56 * 56, 96, 384, 384, torch.float32), (128, 3)),
    ((64 * 257, 768, 3072, 3072, torch.float32), (256, 4)),
    ((64 * 257, 768, 3072, 256, torch.float32), (64, 4)),
    ((64 * 257, 2304, 768, 768, torch.bfloat16), (128, 3)),
    ((64 * 257, 3072, 768, 768, torch.bfloat16), (128, 3)),
    ((64 * 257, 768, 3072, 3072, torch.bfloat16), (256, 4)),
    ((257, 2304, 768, 768, torch.bfloat16), (128, 3)),
    ((257, 3072, 768, 768, torch.bfloat16), (128, 3)),
    ((257, 768, 3072, 3072, torch.bfloat16), (128, 3)),
    ((8 * 1025, 1024, 4096, 4096, torch.bfloat16), (256, 4)),
    ((16 * 56 * 56, 288, 96, 96, torch.float32), (128, 3)),
    ((64 * 257 - 5, 768, 3072, 256, torch.bfloat16), (64, 4)),
    ((1, 3072, 768, 768, torch.bfloat16), (128, 3)),
    ((1, 8, 32, 32, torch.float32), (128, 3)),
    ((49, 768, 3072, 3072, torch.float32), (128, 3)),
    ((300, 200, 256, 32, torch.bfloat16), (64, 4)),
]


@pytest.mark.parametrize("shape,expect", PLANS)
def test_int8_plan_fits_the_card(shape, expect):
    """The launch plan covers y with its tiles, stages the output tile in
    its ring, fits a block's shared memory, and quantizes a group with a
    team of at most 32 threads."""
    m, n, k, g, dtype = shape
    p = int8_plan(*shape)
    es = torch.finfo(dtype).bits // 8
    assert (p.bn, p.stages) == expect
    assert p.bn == 64 if g < k else p.bn in (128, 256)
    assert (p.row_tiles - 1) * tim.BM < m <= p.row_tiles * tim.BM
    assert (p.col_tiles - 1) * p.bn < n <= p.col_tiles * p.bn
    assert p.grid == (p.col_tiles, p.row_tiles)
    assert p.blocks == p.row_tiles * p.col_tiles
    assert p.smem_bytes == tim.smem_bytes(p.bn, p.stages) <= 232448
    assert p.stages * tim.stage_bytes(p.bn) >= 2 * 64 * p.bn * es
    assert p.vectors in tim.VECTORS and p.team in (1, 2, 4, 8, 16, 32)
    assert p.team * p.vectors * 16 >= g * es
    assert p.team == 1 or (p.team // 2) * p.vectors * 16 < g * es
    assert p.sx_offset % 256 == 0 and p.sx_offset >= m * k
    assert p.scratch_bytes == p.sx_offset + 4 * m * (k // g)
    # the quantize blocks give each (row, group) a team, none to spare
    teams = lambda blocks: blocks * tim.QUANT_THREADS // p.team
    assert teams(p.quantize_blocks - 1) < m * (k // g) \
        <= teams(p.quantize_blocks)
    assert p.quantize_grid(132) == min(p.quantize_blocks, 132)


@pytest.mark.parametrize("args,match", [
    ((64, 256, 112, 112), "multiples of 32"),
    ((64, 256, 768, 48), "multiples of 32"),
    ((64, 256, 768, 512), "multiples of 32"),
    ((64, 250, 768, 768), "multiples of 8"),
    ((0, 256, 768, 768), "no int8 plan"),
    ((64, 256, 768, 768, torch.float16), "bfloat16 or float32"),
    ((64, 256, 32768, 32768), "too long"),
    ((65536 * 128, 256, 768, 768), "grid"),
])
def test_int8_plan_raises(args, match):
    with pytest.raises(ValueError, match=match):
        int8_plan(*args)


# ------------------------------------------------------------------ #
# module trees
# ------------------------------------------------------------------ #

VIT_KW = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
              has_layerscale=True, layerscale_init=1.0, gelu_tanh=True,
              use_fused_apla=True)
SWIN_KW = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
               num_heads=(1, 2), window_size=7)
SEG_KW = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4)


def _jax_classifier(n_classes=7):
    from apla_tpu.apla.core import AplaConfig
    from apla_tpu.models.classifier import init_classifier
    from apla_tpu.models.vit import ViTConfig
    jcfg = ViTConfig(compute_dtype=jnp.float32, **VIT_KW)
    t, f = init_classifier(jax.random.PRNGKey(0), jcfg, n_classes,
                           apla_cfg=AplaConfig(partial_size=16))
    return jax.tree.map(np.asarray, t), jax.tree.map(np.asarray, f), jcfg


def _torch_vit_cfg(kw=VIT_KW):
    from apla_tpu_torch.models.vit import ViTConfig
    return ViTConfig(compute_dtype=torch.float32, **kw)


def _jax_seg():
    """A JAX "full" SETR-PUP segmenter with 3 aux heads, weights perturbed
    (the projections trainable, in place)."""
    from apla_tpu.models import seg as jseg
    from apla_tpu.models.vit import ViTConfig
    jcfg = ViTConfig(compute_dtype=jnp.float32, **SEG_KW)
    t, f = jseg.init_segmenter(jax.random.PRNGKey(0), jcfg, 6, channels=16,
                               n_aux_heads=3, aux_channels=8)
    rng = np.random.default_rng(0)
    t, f = (jax.tree.map(lambda a: np.asarray(a) + (rng.standard_normal(
        np.shape(a)) * 0.05).astype(np.float32), tree) for tree in (t, f))
    return t, f, jcfg


def _jax_det():
    from apla_tpu.models.detection import _conv_init, init_fcos_head
    from apla_tpu.models.swin import (SwinConfig, build_apla_swin,
                                      init_swin_params)
    jcfg = SwinConfig(compute_dtype=jnp.float32, **SWIN_KW)
    bb_t, bb_f = build_apla_swin(init_swin_params(jax.random.PRNGKey(0),
                                                  jcfg))
    t = {"backbone": bb_t,
         "head": init_fcos_head(jax.random.PRNGKey(1), 32, 3, channels=16,
                                n_levels=2),
         "laterals": [_conv_init(jax.random.PRNGKey(5), 1, 32, 32),
                      _conv_init(jax.random.PRNGKey(6), 1, 64, 32)]}
    return jax.tree.map(np.asarray, t), jax.tree.map(np.asarray, bb_f), jcfg


def _port_model(kind):
    """(JAX trainable, JAX frozen, the port's float model on the same
    weights) of a classifier, segmenter or detector."""
    from apla_tpu_torch.models.classifier import classifier_from_state
    from apla_tpu_torch.models.swin import SwinConfig
    from apla_tpu_torch.utils.pretrained import (det_state_from_jax,
                                                 params_from_jax,
                                                 seg_state_from_jax)
    cpu = torch.device("cpu")
    if kind == "classifier":
        t, f, _ = _jax_classifier()
        return t, f, classifier_from_state(_torch_vit_cfg(),
                                           *params_from_jax(t, f), cpu)
    if kind == "segmenter":
        t, f, _ = _jax_seg()
        return t, f, tserve.segmenter_from_state(
            _torch_vit_cfg(dict(SEG_KW, use_fused_apla=True)),
            *seg_state_from_jax(t, f), cpu)
    t, f, _ = _jax_det()
    cfg = SwinConfig(compute_dtype=torch.float32, **SWIN_KW)
    return t, f, tserve.detector_from_state(cfg, 3, *det_state_from_jax(t, f),
                                            cpu)


def _jax_quantized_state(kind, t, f):
    """The port's state names of JAX's quantized frozen tree."""
    from apla_tpu_torch.utils.pretrained import (params_from_jax,
                                                 swin_state_from_tree)
    fq = jax.tree.map(np.asarray, jquant.quantize_frozen_backbone(f))
    if kind == "detector":
        return fq, swin_state_from_tree(fq, "backbone.")
    return fq, params_from_jax({"backbone": {}} if kind == "segmenter"
                               else t, fq)[1]


@pytest.mark.parametrize("kind", ["classifier", "segmenter", "detector"])
def test_quantize_frozen_backbone_takes_jax_leaves(kind):
    """The same kernels become int8 as in JAX's tree (ViT, Swin and the
    segmenter's "full" tree), with JAX's codes and scales; every projection
    stays a float parameter; `is_quantized` agrees before and after, and a
    second call changes nothing."""
    t, f, model = _port_model(kind)
    assert not tquant.is_quantized(model) and not jquant.is_quantized(f)
    fq, j_state = _jax_quantized_state(kind, t, f)
    assert jquant.is_quantized(fq)
    tquant.quantize_frozen_backbone(model)
    assert tquant.is_quantized(model)
    state = model.state_dict()
    int8 = {n for n, v in state.items() if v.dtype == torch.int8}
    assert int8 == {n for n, v in j_state.items() if v.dtype == torch.int8}
    assert int8 and all(n.endswith(".kernel.w_int8") for n in int8)
    for name in int8:
        scale = name[:-len("w_int8")] + "scale"
        torch.testing.assert_close(state[name], j_state[name], rtol=0, atol=0)
        torch.testing.assert_close(state[scale], j_state[scale], rtol=0,
                                   atol=0)
    projections = [n for n, _ in model.named_parameters()
                   if ".attn.proj.kernel" in n]
    assert projections and all(".proj." not in n for n in int8)
    before = {n: v.clone() for n, v in model.state_dict().items()}
    tquant.quantize_frozen_backbone(model)
    assert all(torch.equal(before[n], v)
               for n, v in model.state_dict().items())


def test_trainable_kernels_stay_float():
    """A full fine-tune's kernels are trainable (absent from JAX's frozen
    tree) and stay float; `which` picks the kernels by name."""
    _, _, model = _port_model("classifier")
    blk = model.backbone.blocks[0]
    blk.mlp.fc1.kernel.requires_grad_(True)
    tquant.quantize_frozen_backbone(model, which=("fc1", "fc2"))
    assert isinstance(blk.mlp.fc1.kernel, torch.nn.Parameter)
    assert isinstance(blk.mlp.fc2.kernel, tquant.QuantizedKernel)
    assert isinstance(blk.attn.qkv.kernel, torch.nn.Parameter)
    assert isinstance(model.backbone.blocks[1].mlp.fc1.kernel,
                      tquant.QuantizedKernel)


def test_quantized_kernel_state_round_trip():
    """`w_kmajor` is the int8 weight K-major, made at quantize time and
    again at every state load, and never stored."""
    w_i8, scale = tquant.quantize_weight(torch.randn(64, 96))
    qk = tquant.QuantizedKernel(w_i8, scale)
    assert set(qk.state_dict()) == {"w_int8", "scale"}
    assert torch.equal(qk.w_kmajor, w_i8.t()) and qk.w_kmajor.is_contiguous()
    other = tquant.QuantizedKernel.empty(64, 96)
    other.load_state_dict(qk.state_dict())
    assert torch.equal(other.w_kmajor, w_i8.t())


def test_params_from_jax_carries_a_quantized_tree():
    """A JAX classifier with a quantized frozen tree -> the port's state
    (int8 `w_int8`, f32 `scale`, per block) -> a module whose int8 kernels
    hold JAX's codes."""
    from apla_tpu_torch.models.classifier import classifier_from_state
    from apla_tpu_torch.utils.pretrained import params_from_jax
    t, f, _ = _jax_classifier()
    fq = jax.tree.map(np.asarray, jquant.quantize_frozen_backbone(f))
    ts, fs = params_from_jax(t, fq)
    name = "backbone.blocks.1.mlp.fc2.kernel"
    assert fs[name + ".w_int8"].dtype == torch.int8
    assert fs[name + ".w_int8"].shape == (512, 128)
    assert fs[name + ".scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        fs[name + ".w_int8"].numpy(),
        fq["backbone"]["blocks"]["mlp"]["fc2"]["kernel"]["w_int8"][1])
    model = classifier_from_state(_torch_vit_cfg(), ts, fs,
                                  torch.device("cpu"))
    qk = model.backbone.blocks[1].mlp.fc2.kernel
    assert isinstance(qk, tquant.QuantizedKernel)
    assert torch.equal(qk.w_kmajor, fs[name + ".w_int8"].t())
    assert tquant.is_quantized(model)


@pytest.mark.parametrize("n", [1, 5])
def test_quantized_classifier_artifact_matches_jax(tmp_path, n):
    """The port's W8A8 classifier artifact (`export_classifier(...,
    quantize_frozen=True)` -> `load_predictor`) against JAX's
    `classifier_forward` on its quantized frozen tree, float32; the caller's
    model stays float."""
    from apla_tpu.models.classifier import classifier_forward
    t, f, model = _port_model("classifier")
    jcfg = _jax_classifier()[2]
    path = str(tmp_path / "art")
    meta = tserve.export_classifier(path, model, _torch_vit_cfg(),
                                    batch_sizes=(1, 4),
                                    quantize_frozen=True)
    assert meta["quantized_frozen"] is True
    assert not tquant.is_quantized(model)
    pred = tserve.load_predictor(path, "cpu")
    assert tquant.is_quantized(pred.model)
    fq = jquant.quantize_frozen_backbone(f)
    x = np.random.default_rng(n).standard_normal((n, 32, 32, 3)).astype(
        np.float32)
    logits, emb = pred.predict_and_embed(x)
    j_logits, j_emb = classifier_forward(t, fq, jnp.asarray(x), jcfg,
                                         return_embedding=True)
    np.testing.assert_allclose(logits, np.asarray(j_logits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(emb, np.asarray(j_emb), rtol=1e-4, atol=1e-4)


def test_quantized_segmenter_artifact_matches_jax(tmp_path):
    """`export_segmenter(..., quantize_frozen=True)` -> `SegPredictor`
    against JAX's W8A8 segmenter artifact on the same weights (float32):
    per-pixel logits; the "full" projections stay float and trainable."""
    from apla_tpu.serve import export_segmenter as j_export
    from apla_tpu.serve import load_predictor as j_load
    t, f, model = _port_model("segmenter")
    jcfg = _jax_seg()[2]
    j_path = str(tmp_path / "jax_seg")
    j_meta = j_export(j_path, t, f, jcfg, batch_sizes=(1, 2),
                      quantize_frozen=True)
    t_path = str(tmp_path / "torch_seg")
    meta = tserve.export_segmenter(t_path, model, _torch_vit_cfg(
        dict(SEG_KW, use_fused_apla=True)), batch_sizes=(1, 2),
        quantize_frozen=True)
    assert meta["quantized_frozen"] is j_meta["quantized_frozen"] is True
    pred = tserve.load_predictor(t_path, "cpu")
    assert isinstance(pred.model.backbone.blocks[0].attn.proj.kernel,
                      torch.nn.Parameter)
    assert pred.model.backbone.blocks[0].attn.proj.kernel.requires_grad
    assert isinstance(pred.model.backbone.blocks[2].mlp.fc2.kernel,
                      tquant.QuantizedKernel)
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_allclose(pred.predict(x), j_load(j_path).predict(x),
                               rtol=1e-4, atol=1e-4)


def test_quantized_detector_artifact_matches_jax(tmp_path):
    """`export_detector(..., quantize_frozen=True)` -> `DetPredictor`
    against JAX's W8A8 detector artifact (float32): raw maps and
    detections."""
    from apla_tpu.serve import export_detector as j_export
    from apla_tpu.serve import load_predictor as j_load
    t, f, model = _port_model("detector")
    jcfg = _jax_det()[2]
    j_path = str(tmp_path / "jax_det")
    j_export(j_path, t, f, jcfg, (4, 8), batch_sizes=(2,),
             quantize_frozen=True)
    t_path = str(tmp_path / "torch_det")
    cfg = model.backbone.cfg
    meta = tserve.export_detector(t_path, model, cfg, (4, 8),
                                  batch_sizes=(1, 2), quantize_frozen=True)
    assert meta["quantized_frozen"] is True
    with np.load(os.path.join(t_path, "params.npz")) as z:
        assert z["frozen/backbone.stages.1.blocks.1.mlp.fc2.kernel.w_int8"] \
            .dtype == np.int8
    pred = tserve.load_predictor(t_path, "cpu")
    assert tquant.is_quantized(pred.model)
    x = np.random.default_rng(2).standard_normal((3, 56, 56, 3)).astype(
        np.float32)
    got, ref = pred.predict(x), j_load(j_path).predict(x)
    for g_lvl, r_lvl in zip(got, ref, strict=True):
        for g, r in zip(g_lvl, r_lvl, strict=True):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)


def test_export_quantizes_once():
    """`_maybe_quantize` quantizes a copy, and leaves a model that is
    already quantized (say with a custom `which`) as it is."""
    _, _, model = _port_model("classifier")
    assert tserve._maybe_quantize(model, False) is model
    q = tserve._maybe_quantize(model, True)
    assert q is not model and tquant.is_quantized(q)
    assert not tquant.is_quantized(model)
    tquant.quantize_frozen_backbone(model, which=("fc2",))
    assert tserve._maybe_quantize(model, True) is model
    assert isinstance(model.backbone.blocks[0].attn.qkv.kernel,
                      torch.nn.Parameter)
