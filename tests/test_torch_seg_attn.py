"""The port's fused APLA attention at the segmentation side-car's geometry
against the JAX package's q-strip long kernel (TPU rows 5-7).

At ViT-L/16 @ 512 with APLA "full" (N = 1025, C = k = 1024) the JAX
dispatch names `pallas_apla_attn_long.fused_apla_attention_long`: the
monolithic kernel's VMEM model declines the geometry, the long kernel's
admits it at the budget the JAX seg loop sets.  The port runs rows 1/2's
kernels there (`FusedAplaAttention`).  Here the port's function on CPU
tensors (the kernels' plain versions) takes the same inputs as the long
kernel in interpret mode (`APLA_FUSED_LONG_BQ=64`, as
tests/test_pallas_apla_attn_long.py runs it) at a small width with every
projection column trainable (k = C) and N ragged across several 64-row
strips: the forward, dqkv, dW_t and db_t.

Tolerances: float32 rtol = atol = 1e-4 (only the order of f32 sums
differs); bfloat16 rtol = atol = 2e-2.  In bf16 the two also differ in
where delta is formed: the long backward takes sum(dO * o) with o from the
bf16-rounded p (`pallas_apla_attn_long.py:164-166`), the port (as the
monolithic kernel) rowsum(dp * p) on the f32 p; the test prints the
measured gap of each output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn, pallas_apla_attn_long
from apla_tpu_torch.ops import fused_apla_attn as tfa

C, H = 128, 2
SCALE = (C // H) ** -0.5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode(monkeypatch):
    pallas_apla_attn_long.INTERPRET = True
    # 64-row strips, so a toy N spans several grid blocks
    monkeypatch.setenv("APLA_FUSED_LONG_BQ", "64")
    yield
    pallas_apla_attn_long.INTERPRET = False


def test_jax_dispatch_names_the_long_kernel_at_vit_l_512(monkeypatch):
    """N = 1025, C = k = 1024: `fused_fits` declines at the 15 MB budget
    of the JAX seg loop (`segdet.py:251`) and `long_fused_ok` admits (at
    the recipe's b8); without that budget the long kernel declines too."""
    monkeypatch.setenv("APLA_FUSED_VMEM_MB", "15")
    assert not pallas_apla_attn.fused_fits(1025, 1024, 1024)
    assert pallas_apla_attn_long.long_fused_ok(1025, 1024, 1024, b=8)
    monkeypatch.delenv("APLA_FUSED_VMEM_MB")
    assert not pallas_apla_attn_long.long_fused_ok(1025, 1024, 1024, b=8)


def test_jax_full_seg_blocks_take_the_dense_projection(monkeypatch):
    """What JAX's `segdet seg` runs under "full": its trainable block tree
    holds `attn.proj`, not `proj_wt`, so `_block_forward` goes to
    `multi_head_attention` whatever `use_fused_apla` says, and neither
    fused kernel is reached.  (The port routes its "full" blocks through
    `apla_attention` with the projection as the rank-C trainable columns,
    so that `use_fused_apla` reaches its fused kernels; the model tests
    hold both against each other.)"""
    from apla_tpu.models import seg as jseg
    from apla_tpu.models import vit as jvit
    from apla_tpu.ops import attention as jattn

    cfg = jvit.ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                         num_heads=1, compute_dtype=jnp.float32,
                         use_fused_apla=True)
    t, f = jseg.init_segmenter(jax.random.PRNGKey(0), cfg, n_classes=3,
                               channels=8)
    assert "proj" in t["backbone"]["blocks"]["attn"]
    assert "proj_wt" not in t["backbone"]["blocks"]

    def refuse(*a, **k):
        raise AssertionError("apla_attention reached")

    monkeypatch.setattr(jattn, "apla_attention", refuse)
    monkeypatch.setattr(jvit, "apla_attention", refuse)
    out = jseg.segmenter_forward(t, f, jnp.ones((1, 32, 32, 3)), cfg)
    assert out.shape == (1, 32, 32, 3)


def _inputs(n, seed, b=2):
    rng = np.random.default_rng(seed)
    return {
        "qkv": rng.standard_normal((b, n, 3 * C)).astype(np.float32),
        "w_t": (rng.standard_normal((C, C)) * 0.05).astype(np.float32),
        "b_t": (rng.standard_normal(C) * 0.05).astype(np.float32),
        "w_frozen": (rng.standard_normal((C, C)) * 0.05).astype(np.float32),
        "b_frozen": (rng.standard_normal(C) * 0.05).astype(np.float32),
        "g": rng.standard_normal((b, n, C)).astype(np.float32),
    }


def _jax_long(inp, inds, dtype):
    """(out, dqkv, dW_t, db_t) of the long kernel, float32 numpy."""
    def fwd(qkv, w_t, b_t):
        return pallas_apla_attn_long.fused_apla_attention_long(
            qkv, w_t, b_t, jnp.asarray(inp["w_frozen"]),
            jnp.asarray(inp["b_frozen"]), jnp.asarray(inds), H, SCALE)

    args = (jnp.asarray(inp["qkv"], dtype), jnp.asarray(inp["w_t"]),
            jnp.asarray(inp["b_t"]))
    out = fwd(*args)
    grads = jax.grad(lambda *a: jnp.sum(fwd(*a).astype(jnp.float32)
                                        * jnp.asarray(inp["g"])),
                     argnums=(0, 1, 2))(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out,) + grads]


def _torch_fused(inp, inds, dtype):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    qkv = t["qkv"].to(dtype).requires_grad_()
    w_t = t["w_t"].clone().requires_grad_()
    b_t = t["b_t"].clone().requires_grad_()
    out = tfa.fused_apla_attention(qkv, w_t, b_t, t["w_frozen"],
                                   t["b_frozen"], torch.from_numpy(inds).long(),
                                   H, SCALE)
    (out.float() * t["g"]).sum().backward()
    return [x.detach().float().numpy()
            for x in (out, qkv.grad, w_t.grad, b_t.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,inds_kind", [(150, "all"), (193, "all"),
                                         (129, "permuted")])
def test_fused_attention_matches_the_long_kernel(interpret_mode, n,
                                                 inds_kind, dtype):
    """k = C: every projection column trainable, as APLA "full" on the seg
    path (the port's `arange`; a permutation of all columns too), N ragged
    over 3-4 strips of 64."""
    inp = _inputs(n, seed=n)
    inds = (np.arange(C) if inds_kind == "all"
            else np.random.default_rng(n).permutation(C)).astype(np.int32)
    ref = _jax_long(inp, inds, getattr(jnp, dtype))
    got = _torch_fused(inp, inds, getattr(torch, dtype))
    tol = TOL[dtype]
    for name, a, r in zip(("out", "dqkv", "dW_t", "db_t"), got, ref):
        print(f"{dtype} N={n} {name}: max|d| {np.abs(a - r).max():.3g}")
        np.testing.assert_allclose(a, r, rtol=tol, atol=tol, err_msg=name)


def test_full_columns_equal_the_dense_projection():
    """With inds = 0..C-1 the fused function is the dense attention
    projection with the trainable matrix: x @ W_t + b_t (the frozen matrix
    is wholly shadowed), and its gradients are the dense ones."""
    inp = _inputs(70, seed=7)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    inds = torch.arange(C)
    qkv = t["qkv"].clone().requires_grad_()
    w_t = t["w_t"].clone().requires_grad_()
    b_t = t["b_t"].clone().requires_grad_()
    out = tfa.fused_apla_attention(qkv, w_t, b_t, t["w_frozen"] * 7,
                                   t["b_frozen"] * 7, inds, H, SCALE)
    (out * t["g"]).sum().backward()
    q2 = t["qkv"].clone().requires_grad_()
    w2 = t["w_t"].clone().requires_grad_()
    b2 = t["b_t"].clone().requires_grad_()
    q, k, v = (x.unflatten(-1, (H, C // H)).transpose(1, 2)
               for x in q2.chunk(3, dim=-1))
    o = torch.softmax(q @ k.transpose(-1, -2) * SCALE, -1) @ v
    dense = o.transpose(1, 2).flatten(-2) @ w2 + b2
    (dense * t["g"]).sum().backward()
    for a, r in ((out, dense), (qkv.grad, q2.grad), (w_t.grad, w2.grad),
                 (b_t.grad, b2.grad)):
        np.testing.assert_allclose(a.detach().numpy(), r.detach().numpy(),
                                   rtol=1e-4, atol=1e-4)
