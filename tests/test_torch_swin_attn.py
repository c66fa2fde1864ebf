"""The port's fused Swin window attention (kernel rows 3, 4) against the JAX
package's.

`apla_tpu.ops.pallas_apla_attn.fused_swin_attention` (its custom VJP, the
Pallas kernels in interpret mode, as tests/test_fused_swin_attn.py runs
them) and the port's `FusedSwinAttention` autograd `Function` on CPU tensors
(the plain versions of both kernels) take the same inputs and the same
output cotangent, drawn with numpy: the forward, dqkv, dW and db; no
gradient reaches the bias or the mask.  Cases: N = 49 (a 7x7 window, one
64-row kernel tile) and N = 9; H = 3 heads of 32 (Swin-T's stage 0, C = 96);
shifted (a per-window mask, nW not dividing the batch) and unshifted.

Tolerances: float32 rtol = atol = 1e-4 (only the order of f32 sums
differs); bfloat16 rtol = atol = 2e-2 (both round p, o, dO and ds to bf16,
so an element may differ by one bf16 ulp of values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn
from apla_tpu_torch.ops import fused_swin_attn as tfs

C, H = 96, 3
SCALE = (C // H) ** -0.5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_apla_attn.INTERPRET = True
    yield
    pallas_apla_attn.INTERPRET = False


def _inputs(n, shifted, seed, b=6, n_w=4):
    rng = np.random.default_rng(seed)
    if shifted:
        blk = rng.uniform(size=(n_w, n, n)) > 0.6
        blk = blk & blk.transpose(0, 2, 1) & ~np.eye(n, dtype=bool)[None]
        mask = np.where(blk, -1e9, 0.0).astype(np.float32)
    else:
        mask = None
    return {
        "qkv": rng.standard_normal((b, n, 3 * C)).astype(np.float32),
        "w": (rng.standard_normal((C, C)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(C) * 0.1).astype(np.float32),
        "bias": (rng.standard_normal((H, n, n)) * 0.5).astype(np.float32),
        "mask": mask,
        "g": rng.standard_normal((b, n, C)).astype(np.float32),
    }


def _jax(x, dtype):
    jdt = jnp.dtype(dtype)
    wmask = x["mask"] if x["mask"] is not None else np.zeros(
        (1,) + x["bias"].shape[1:], np.float32)

    def f(qkv, w, b):
        return pallas_apla_attn.fused_swin_attention(
            qkv, w, b, jnp.asarray(x["bias"]), jnp.asarray(wmask), H, SCALE)

    out, vjp = jax.vjp(f, jnp.asarray(x["qkv"], jdt), jnp.asarray(x["w"]),
                       jnp.asarray(x["b"]))
    grads = vjp(jnp.asarray(x["g"], out.dtype))
    return [np.asarray(jnp.asarray(a, jnp.float32))
            for a in (out,) + tuple(grads)]


def _torch(x, dtype, qkv_grad=True):
    tdt = getattr(torch, dtype)
    qkv = torch.tensor(x["qkv"]).to(tdt).requires_grad_(qkv_grad)
    w = torch.tensor(x["w"], requires_grad=True)
    b = torch.tensor(x["b"], requires_grad=True)
    bias = torch.tensor(x["bias"], requires_grad=True)
    mask = None if x["mask"] is None else torch.tensor(x["mask"])
    out = tfs.fused_swin_attention(qkv, w, b, bias, mask, H, SCALE)
    out.backward(torch.tensor(x["g"]).to(out.dtype))
    assert bias.grad is None           # frozen: no cotangent
    return out, qkv, w, b


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [49, 9])
@pytest.mark.parametrize("shifted", [True, False])
def test_forward_and_vjp_match_jax(n, shifted, dtype):
    x = _inputs(n, shifted, seed=n + shifted)
    j_out, j_dqkv, j_dw, j_db = _jax(x, dtype)
    out, qkv, w, b = _torch(x, dtype)
    _close(out.detach().float(), j_out, dtype, "out")
    _close(qkv.grad.float(), j_dqkv, dtype, "dqkv")
    _close(w.grad, j_dw, dtype, "dW")
    _close(b.grad, j_db, dtype, "db")


@pytest.mark.parametrize("shifted", [True, False])
def test_plain_backward_alone_matches_jax(shifted):
    """`fused_swin_attn_bwd_reference` (the kernel's plain version, without
    the autograd Function) against the JAX cotangents, float32."""
    x = _inputs(49, shifted, seed=7)
    _, j_dqkv, j_dw, _ = _jax(x, "float32")
    mask = None if x["mask"] is None else torch.tensor(x["mask"])
    dqkv, dw = tfs.fused_swin_attn_bwd_reference(
        torch.tensor(x["qkv"]), torch.tensor(x["w"]), torch.tensor(x["g"]),
        torch.tensor(x["bias"]), mask, H, SCALE)
    _close(dqkv, j_dqkv, "float32", "dqkv")
    _close(dw, j_dw, "float32", "dW")


def test_frozen_input_still_gives_dw_and_db():
    """Stage 0 block 0: qkv comes from the frozen patch embedding and needs
    no gradient; dW and db are still those of the JAX VJP."""
    x = _inputs(49, True, seed=3)
    _, _, j_dw, j_db = _jax(x, "float32")
    _, qkv, w, b = _torch(x, "float32", qkv_grad=False)
    assert qkv.grad is None
    _close(w.grad, j_dw, "float32", "dW")
    _close(b.grad, j_db, "float32", "db")


def test_wrappers_count_nothing_on_the_cpu_and_reject_other_devices():
    x = _inputs(49, False, seed=1)
    qkv = torch.tensor(x["qkv"]).bfloat16()
    w = torch.tensor(x["w"]).bfloat16()
    bias = torch.tensor(x["bias"])
    before = (tfs.fused_swin_attn_fwd.launches,
              tfs.fused_swin_attn_bwd.launches)
    tfs.fused_swin_attn_fwd(qkv, w, bias, None, H, SCALE)
    tfs.fused_swin_attn_bwd(qkv, w, torch.zeros(6, 49, C).bfloat16(), bias,
                            None, H, SCALE)
    assert (tfs.fused_swin_attn_fwd.launches,
            tfs.fused_swin_attn_bwd.launches) == before
    with pytest.raises(ValueError, match="no fused Swin attention"):
        tfs.fused_swin_attn_fwd(qkv.to("meta"), w.to("meta"),
                                bias.to("meta"), None, H, SCALE)


@pytest.mark.parametrize("bad, match", [
    ("dtype", "bfloat16"), ("head_dim", "head dim 32"),
    ("bias", "bias must be"), ("mask", "mask must be")])
def test_kernel_argument_checks(bad, match):
    """The checks a CUDA tensor meets before a launch, run on CPU tensors
    (no card needed): each names why the kernel cannot run."""
    qkv = torch.zeros(4, 49, 3 * C, dtype=torch.bfloat16)
    w = torch.zeros(C, C, dtype=torch.bfloat16)
    bias = torch.zeros(H, 49, 49)
    mask = torch.zeros(2, 49, 49)
    heads = H
    if bad == "dtype":
        qkv = qkv.float()
    elif bad == "head_dim":
        heads = 2
        bias = torch.zeros(2, 49, 49)
    elif bad == "bias":
        bias = torch.zeros(H, 49, 48)
    else:
        mask = torch.zeros(2, 49, 49, dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        tfs._check(qkv, w, bias, mask, heads)
