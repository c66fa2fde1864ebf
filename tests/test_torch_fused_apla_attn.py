"""The port's fused APLA attention against the JAX package's Pallas kernel.

`apla_tpu_torch.ops.fused_apla_attn.fused_apla_attention` on CPU tensors runs
its plain PyTorch version; it is held against
`apla_tpu.ops.pallas_apla_attn.fused_apla_attention` run in the Pallas
interpreter (as tests/test_pallas_apla_attn.py runs it), on the same inputs
drawn with numpy.

Tolerances: float32 rtol = atol = 1e-4 (only the order of f32 sums differs);
bfloat16 rtol = atol = 2e-2 (both round p, o and the output to bf16, so an
element may differ by one bf16 ulp of values of order 1).

The CUDA kernel itself is checked against the plain version on the card by
tests/test_torch_cuda.py (skipped without a card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn
from apla_tpu_torch.ops import cuda_build
from apla_tpu_torch.ops import fused_apla_attn as tfa

C, H, K = 128, 2, 16
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    pallas_apla_attn.INTERPRET = True
    # the tiny test lengths sit below the production min-seq gate
    monkeypatch.setenv("APLA_FUSED_MIN_N", "0")
    yield
    pallas_apla_attn.INTERPRET = False


def _inputs(n, seed, b=2):
    rng = np.random.default_rng(seed)
    return {
        "qkv": rng.standard_normal((b, n, 3 * C)).astype(np.float32),
        "w_t": (rng.standard_normal((C, K)) * 0.05).astype(np.float32),
        "b_t": (rng.standard_normal(K) * 0.05).astype(np.float32),
        "w_frozen": (rng.standard_normal((C, C)) * 0.05).astype(np.float32),
        "b_frozen": (rng.standard_normal(C) * 0.05).astype(np.float32),
        "inds": rng.permutation(C)[:K].astype(np.int32),
    }


def _jax(inp, dtype, seg):
    out = pallas_apla_attn.fused_apla_attention(
        jnp.asarray(inp["qkv"], dtype), jnp.asarray(inp["w_t"]),
        jnp.asarray(inp["b_t"]), jnp.asarray(inp["w_frozen"]),
        jnp.asarray(inp["b_frozen"]), jnp.asarray(inp["inds"]), H,
        (C // H) ** -0.5, seg)
    return np.asarray(out.astype(jnp.float32))


def _torch(inp, dtype, seg):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = tfa.fused_apla_attention(
        t["qkv"].to(dtype), t["w_t"], t["b_t"], t["w_frozen"], t["b_frozen"],
        t["inds"].long(), H, (C // H) ** -0.5, seg)
    assert out.dtype == dtype and out.shape == t["qkv"].shape[:2] + (C,)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,seg", [(17, 0), (40, 0), (40, 10), (17, 5)])
def test_matches_jax_kernel(n, seg, dtype):
    inp = _inputs(n, seed=n + seg)
    ref = _jax(inp, getattr(jnp, dtype), seg)
    got = _torch(inp, getattr(torch, dtype), seg)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_segments_do_not_mix():
    """With segment_len, changing one segment's tokens leaves every other
    segment's output unchanged."""
    inp = _inputs(40, seed=3)
    base = _torch(inp, torch.float32, 10)
    inp["qkv"][:, 30:40] += 1.0
    moved = _torch(inp, torch.float32, 10)
    np.testing.assert_array_equal(moved[:, :30], base[:, :30])
    assert not np.allclose(moved[:, 30:], base[:, 30:])


def test_cpu_path_never_builds(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no nvcc lookup, no
    library load, no launch counted."""
    def no_build(*a, **k):
        raise AssertionError("a CPU call tried to build the CUDA kernel")

    monkeypatch.setattr(tfa, "load_library", no_build)
    monkeypatch.setattr(cuda_build, "build_library", no_build)
    monkeypatch.setattr(cuda_build, "find_nvcc", no_build)
    before = tfa.fused_apla_attn_fwd.launches
    qkv = torch.randn(2, 17, 3 * C, dtype=torch.bfloat16)
    w = torch.randn(C, C, dtype=torch.bfloat16)
    out = tfa.fused_apla_attn_fwd(qkv, w, H, 0.125)
    assert out.shape == (2, 17, C) and torch.isfinite(out.float()).all()
    assert tfa.fused_apla_attn_fwd.launches == before


def test_other_devices_raise():
    qkv = torch.empty(2, 17, 3 * C, device="meta")
    with pytest.raises(ValueError, match="no fused APLA attention"):
        tfa.fused_apla_attn_fwd(qkv, torch.empty(C, C, device="meta"), H, 1.0)


@pytest.mark.parametrize("case,match", [
    ("f32", "bfloat16"),
    ("head_dim", "head dim 64"),
    ("w_shape", "w must be"),
    ("strided", "contiguous"),
    ("seg", "segment_len"),
])
def test_kernel_argument_checks(case, match):
    """The checks the CUDA path runs before a launch (pure shape/dtype
    logic, so they are testable here)."""
    bf = torch.bfloat16
    qkv = torch.zeros(2, 17, 3 * 128, dtype=bf)
    w = torch.zeros(128, 128, dtype=bf)
    heads, seg = 2, 0
    if case == "f32":
        qkv = qkv.float()
    elif case == "head_dim":
        heads = 4
    elif case == "w_shape":
        w = torch.zeros(128, 64, dtype=bf)
    elif case == "strided":
        qkv = torch.zeros(2, 3 * 128, 17, dtype=bf).transpose(1, 2)
    elif case == "seg":
        seg = -1
    with pytest.raises(ValueError, match=match):
        tfa._check_cuda_args(qkv, w, heads, seg)
