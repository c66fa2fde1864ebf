"""The port's `apla_proj` (the `AplaProj` autograd `Function`) against the
JAX package's custom VJP (`apla_tpu/ops/apla_proj.py`).

Same numpy inputs and output cotangent; outputs and the gradients of x,
w_t and b_t compared.  Tolerances: float32 rtol = atol = 1e-4 (sum order);
bfloat16 rtol = atol = 2e-2 (the output and dx are bf16 matmuls rounded
once; one ulp of values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops.apla_proj import apla_proj as japla_proj
from apla_tpu_torch.ops.apla_proj import apla_proj

D, K = 96, 12
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((3, 7, D)).astype(np.float32),
        "w_t": (rng.standard_normal((D, K)) * 0.1).astype(np.float32),
        "b_t": (rng.standard_normal(K) * 0.1).astype(np.float32),
        "w_f": (rng.standard_normal((D, D)) * 0.1).astype(np.float32),
        "b_f": (rng.standard_normal(D) * 0.1).astype(np.float32),
        "inds": rng.permutation(D)[:K].astype(np.int32),
        "g": rng.standard_normal((3, 7, D)).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apla_proj_output_and_grads_match_jax(dtype):
    inp = _inputs(0)
    jdt = getattr(jnp, dtype)

    def loss(x, w_t, b_t):
        out = japla_proj(x, w_t, b_t, jnp.asarray(inp["w_f"]),
                         jnp.asarray(inp["b_f"]), jnp.asarray(inp["inds"]))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(inp["g"])), out

    (_, j_out), j_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(inp["x"], jdt), jnp.asarray(inp["w_t"]),
        jnp.asarray(inp["b_t"]))

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x = t["x"].to(getattr(torch, dtype)).requires_grad_()
    w_t = t["w_t"].clone().requires_grad_()
    b_t = t["b_t"].clone().requires_grad_()
    w_f = t["w_f"].clone().requires_grad_()
    b_f = t["b_f"].clone().requires_grad_()
    out = apla_proj(x, w_t, b_t, w_f, b_f, t["inds"].long())
    (out.float() * t["g"]).sum().backward()

    tol = TOL[dtype]
    assert out.dtype == x.dtype
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for got, want in zip((x.grad, w_t.grad, b_t.grad), j_grads):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    assert w_t.grad.dtype == torch.float32 and x.grad.dtype == x.dtype
    # the frozen matrix and bias get no gradient
    assert w_f.grad is None and b_f.grad is None
