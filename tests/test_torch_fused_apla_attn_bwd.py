"""The port's fused APLA attention backward against the JAX package's.

`jax.grad` of `apla_tpu.ops.pallas_apla_attn.fused_apla_attention` (its
custom VJP, Pallas kernels in interpret mode, as tests/test_pallas_apla_attn.py
runs them) and the port's `FusedAplaAttention` autograd `Function` on CPU
tensors (the plain versions of both kernels) take the same inputs and the
same output cotangent, drawn with numpy.  Also the plain backward alone
(`fused_apla_attn_bwd_reference`) against the JAX gradients.

Tolerances: float32 rtol = atol = 1e-4 (only the order of f32 sums
differs); bfloat16 rtol = atol = 2e-2 (both round dO, p, o and ds to bf16,
so an element may differ by one bf16 ulp of values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.ops import pallas_apla_attn
from apla_tpu_torch.ops import cuda_build
from apla_tpu_torch.ops import fused_apla_attn as tfa

C, H, K = 128, 2, 16
SCALE = (C // H) ** -0.5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    pallas_apla_attn.INTERPRET = True
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
        "g": rng.standard_normal((b, n, C)).astype(np.float32),
    }


def _jax_grads(inp, dtype, seg):
    def loss(qkv, w_t, b_t):
        out = pallas_apla_attn.fused_apla_attention(
            qkv, w_t, b_t, jnp.asarray(inp["w_frozen"]),
            jnp.asarray(inp["b_frozen"]), jnp.asarray(inp["inds"]), H, SCALE,
            seg)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(inp["g"]))

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(inp["qkv"], dtype), jnp.asarray(inp["w_t"]),
        jnp.asarray(inp["b_t"]))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_leaves(inp, dtype):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    qkv = t["qkv"].to(dtype).requires_grad_()
    w_t = t["w_t"].clone().requires_grad_()
    b_t = t["b_t"].clone().requires_grad_()
    w_f = t["w_frozen"].clone().requires_grad_()
    b_f = t["b_frozen"].clone().requires_grad_()
    return qkv, w_t, b_t, w_f, b_f, t["inds"].long(), t["g"]


def _close(got, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,seg", [(17, 0), (40, 0), (40, 10), (17, 5)])
def test_function_grads_match_jax(n, seg, dtype):
    inp = _inputs(n, seed=100 + n + seg)
    ref = _jax_grads(inp, getattr(jnp, dtype), seg)
    qkv, w_t, b_t, w_f, b_f, inds, g = _torch_leaves(inp, getattr(torch,
                                                                  dtype))
    out = tfa.fused_apla_attention(qkv, w_t, b_t, w_f, b_f, inds, H, SCALE,
                                   seg)
    (out.float() * g).sum().backward()
    assert qkv.grad.dtype == qkv.dtype and w_t.grad.dtype == torch.float32
    for got, want in zip((qkv.grad, w_t.grad, b_t.grad), ref):
        _close(got.float(), want, dtype)
    # no gradient for the frozen matrix or bias
    assert w_f.grad is None and b_f.grad is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,seg", [(40, 0), (40, 10)])
def test_plain_backward_matches_jax(n, seg, dtype):
    """The plain backward alone: dqkv and dW_t against jax.grad's qkv and
    w_t gradients (dW_t is the w_t gradient: w_t enters only at inds)."""
    inp = _inputs(n, seed=200 + n + seg)
    ref_dqkv, ref_dwt, _ = _jax_grads(inp, getattr(jnp, dtype), seg)
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    inds = t["inds"].long()
    w = t["w_frozen"].index_copy(1, inds, t["w_t"]).to(dt)
    dqkv, dwt = tfa.fused_apla_attn_bwd(t["qkv"].to(dt), w, t["g"].to(dt),
                                        inds, H, SCALE, seg)
    assert dqkv.dtype == dt and dwt.dtype == torch.float32
    _close(dqkv.float(), ref_dqkv, dtype)
    _close(dwt, ref_dwt, dtype)


def test_bwd_cpu_path_never_builds(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU call tried to build the CUDA kernel")

    monkeypatch.setattr(tfa, "load_library", no_build)
    monkeypatch.setattr(cuda_build, "build_library", no_build)
    before = tfa.fused_apla_attn_bwd.launches
    qkv = torch.randn(2, 17, 3 * C, dtype=torch.bfloat16)
    w = torch.randn(C, C, dtype=torch.bfloat16)
    g = torch.randn(2, 17, C, dtype=torch.bfloat16)
    dqkv, dwt = tfa.fused_apla_attn_bwd(qkv, w, g, torch.arange(K), H, 0.125)
    assert dqkv.shape == qkv.shape and dwt.shape == (C, K)
    assert tfa.fused_apla_attn_bwd.launches == before


def test_bwd_other_devices_raise():
    qkv = torch.empty(2, 17, 3 * C, device="meta")
    with pytest.raises(ValueError, match="no fused APLA attention"):
        tfa.fused_apla_attn_bwd(qkv, torch.empty(C, C, device="meta"),
                                torch.empty(2, 17, C, device="meta"),
                                torch.arange(K, device="meta"), H, 1.0)


@pytest.mark.parametrize("case,match", [
    ("g_dtype", "g must be"),
    ("g_shape", "g must be"),
    ("g_strided", "contiguous"),
    ("inds_empty", "inds must be"),
    ("inds_2d", "inds must be"),
    ("f32", "bfloat16"),
])
def test_bwd_argument_checks(case, match):
    """The checks the CUDA backward runs before a launch."""
    bf = torch.bfloat16
    qkv = torch.zeros(2, 17, 3 * C, dtype=bf)
    w = torch.zeros(C, C, dtype=bf)
    g = torch.zeros(2, 17, C, dtype=bf)
    inds = torch.arange(K)
    if case == "g_dtype":
        g = g.float()
    elif case == "g_shape":
        g = torch.zeros(2, 16, C, dtype=bf)
    elif case == "g_strided":
        g = torch.zeros(2, C, 17, dtype=bf).transpose(1, 2)
    elif case == "inds_empty":
        inds = torch.arange(0)
    elif case == "inds_2d":
        inds = torch.arange(K).reshape(2, -1)
    elif case == "f32":
        qkv, w = qkv.float(), w.float()
    with pytest.raises(ValueError, match=match):
        tfa._check_bwd_args(qkv, w, g, inds, H, 0)


@pytest.mark.parametrize("m,c,kp,n_sm", [
    (8 * 257, 768, 128, 132), (64 * 257, 768, 128, 132),
    (1, 768, 64, 132), (2 * 1370, 1024, 1024, 132), (17, 128, 64, 8)])
def test_dw_chunk_plan_covers_every_row(m, c, kp, n_sm):
    """The dW_t partials: chunks of whole 64-row steps, none empty, every
    row in exactly one."""
    rows, n = tfa.dw_chunks(m, c, kp, n_sm)
    assert rows % 64 == 0 and n >= 1
    assert (n - 1) * rows < m <= n * rows


@pytest.mark.parametrize("m,c,kp,n_sm,want", [
    (64 * 257, 768, 128, 132, (768, 22)),
    (8 * 1025, 1024, 1024, 132, (4160, 2)),
    (8 * 257, 768, 128, 132, (128, 17)),
    (512 * 50, 768, 128, 132, (1216, 22))])
def test_dw_chunk_plan_is_the_first_kernels(m, c, kp, n_sm, want):
    """The chunks fix the dW_t partials' sum order, so they stay those of
    the 64 x 64 tiles the first kernel summed over (the bits of dW_t are
    that kernel's), whatever tiles the GEMM now takes."""
    assert tfa.dw_chunks(m, c, kp, n_sm) == want


class _Lib:
    def __init__(self):
        self.calls = []

    def fused_apla_attn_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("b,n,c,k,seg", [(64, 257, 768, 128, 0),
                                         (8, 1025, 1024, 1024, 0),
                                         (8, 200, 768, 100, 50)])
def test_bwd_routes_through_its_plans(monkeypatch, b, n, c, k, seg):
    """The CUDA route of the fused backward with the C entry replaced by a
    recorder: one call queues the five launches (parts 15) with the eleven
    plan ints (`mha.bwd_plan`'s five, then the dO GEMM's and the dW GEMM's
    tile width, stages and shared memory), Kp = k rounded up to 64, the
    dW chunks of `dw_chunks` at the device's SM count, and returns dW_t's
    first k columns; `fused_apla_attn_bwd_part` queues the launches it
    names.  Neither counts a launch: `fused_apla_attn_bwd` counts its
    calls."""
    import contextlib
    import types
    heads = c // 64
    lib = _Lib()
    monkeypatch.setattr(tfa, "_bwd_library", lambda: lib)
    monkeypatch.setattr(tfa, "device_index", lambda t: 0)
    monkeypatch.setattr(tfa, "device_smem", lambda *a: 232448)
    monkeypatch.setattr(tfa.mha, "device_smem", lambda *a: 232448)
    monkeypatch.setattr(tfa, "launch_context",
                        lambda t: contextlib.nullcontext(7))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    bf = torch.bfloat16
    qkv = torch.zeros((b, n, 3 * c), dtype=bf)
    w = torch.zeros((c, c), dtype=bf)
    g = torch.zeros((b, n, c), dtype=bf)
    inds = torch.arange(k)
    before = tfa.fused_apla_attn_bwd.launches
    dqkv, dwt = tfa._launch_bwd(qkv, w, g, inds, heads, 0.125, seg)
    tfa.fused_apla_attn_bwd_part(qkv, w, g, inds, heads, 0.125,
                                 tfa.mha.PART_DW, seg)
    assert tfa.fused_apla_attn_bwd.launches == before
    assert dqkv.shape == qkv.shape and dwt.shape == (c, k)
    (args, part_args) = lib.calls
    kp = -(-k // 64) * 64
    attn, do_gemm, dw_gemm = tfa.bwd_plans(b, n, c, heads, kp, seg)
    assert args[0] == qkv.data_ptr() and args[1] == w.data_ptr()
    assert args[2] == g.data_ptr() and args[4] == dqkv.data_ptr()
    # the heads' width C, then the projection's width (C here: the
    # square w; a tensor-parallel rank's w [C/T, C] passes C/T, then C)
    assert args[10:18] == (b, n, c, c, heads, kp, 0.125, seg)
    assert args[18:20] == tfa.dw_chunks(b * n, c, kp, 132)
    assert list(args[20]) == list(attn.args()) + [
        do_gemm.bn, do_gemm.stages, do_gemm.smem_bytes,
        dw_gemm.bn, dw_gemm.stages, dw_gemm.smem_bytes]
    assert args[21] == tfa.PARTS_ALL == 15 and args[22] == 7
    assert part_args[21] == tfa.mha.PART_DW
    # the dO GEMM covers the B * N rows at C, the dW GEMM C x Kp
    assert (do_gemm.rows, do_gemm.width) == (b * n, c)
    assert (dw_gemm.rows, dw_gemm.width, dw_gemm.bn) == (c, kp, 128)
