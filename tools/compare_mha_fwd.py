#!/usr/bin/env python3
"""Time this checkout's attention kernels against an earlier checkout's,
on one CUDA card, in one call, and count the output values the two give
bit for bit alike: the memory-efficient attention forward (`mha_fwd`, TPU
row 8) by default; with `--kernel fused` the fused APLA attention forward
(`fused_apla_attn_fwd`, TPU rows 1 and 5); with `--kernel bwd` the fused
APLA backward (`fused_apla_attn_bwd`, TPU rows 2 and 6-7); with `--kernel
mha_bwd` the memory-efficient attention backward (`mha_bwd`, TPU row 9);
with `--kernel int8` the W8A8 GEMM (`fused_int8_matmul`, TPU row 13); with
`--kernel swin` the Swin window attention forward (`fused_swin_attn_fwd`,
TPU row 3); with `--kernel swin_bwd` its backward (`fused_swin_attn_bwd`,
TPU row 4); with `--kernel proto` the prototype cross-entropy forward and
backward (`proto_ce_fwd`, `proto_ce_dxs`, `proto_ce_dws`, TPU rows 10-12).

    python3 tools/compare_mha_fwd.py --parent DIR [--kernel KIND] [--full]

DIR is a checkout of the earlier commit (e.g. `git archive <commit> | tar
-x -C DIR`, into a directory `.gitignore` lists).  The checkouts run in
turns, each in a process of its own (earlier, this, this, earlier), so the
two are compared on one card under the same conditions.  Each turn builds
its checkout's kernels and times the kernel at the shapes the port's paths
give it with CUDA events over calls launched one by one and over a CUDA
graph of 20 calls (device time alone), and the host's time to launch one
(the wrapper, its checks, the launches; the least of 15 rounds of 200 calls
with no wait), beside a PyTorch yardstick on the same inputs, and keeps its
outputs so that the summary can say how many of this checkout's output
values equal the earlier checkout's, bit for bit (per output: o; dq, dk, dv
and dW_t).

  mha, fused   b1, b8, b64 at N=257, [512, 50], [2, 1370] at C = 768, and
               [8, 1025] at C = 1024 (the segmenter's, where the fused
               forward's attention half runs `mha_fwd`'s kernel); yardstick
               F.scaled_dot_product_attention (`fused`: and one
               torch.matmul).
  bwd          chip_smoke.py phase 4's timed shapes (b64 at N=257, [512,
               50], [2, 1370] at C = 768 with the shipped block-0 indices,
               k = 128) and [8, 1025] at C = k = 1024 (phase 9a's);
               yardstick autograd through SDPA + torch.matmul.
  mha_bwd      phase 7a's timed shapes (b64, b1, b8 at N=257, [512, 50],
               [2, 1370] at C = 768); yardstick SDPA's autograd.
  int8         phase 10a's shapes (the classifier's qkv, fc1, fc2 at b64
               and b1, the segmenter's fc2 at b8, the Swin-T stage-0 qkv in
               f32, groups of 256 with a ragged M) and fc1 b64 with its
               bias: fused where the checkout's wrapper takes a bias, else
               the kernel followed by `y + bias.to(y.dtype)`, which the
               fused epilogue must equal; each call's kernels' device ms
               apart (torch.profiler: the quantize pass, the GEMM, the bias
               add); yardsticks torch._int_mm (the int8 product alone) and
               torch.matmul in x's dtype with the dequantized weight
               (torch.addmm with the bias).
  swin         chip_smoke.py phase 8a's cases (the Swin-T detector's
               windows at b16, every stage shifted and not where it has
               shifted blocks, and b1 at stage 0), b8 at stage 0 (a served
               batch), N = 64 (a window of 8 x 8, one full key tile) and
               N = 144 (Swin-B at 384: windows of 12 x 12, the two-pass
               kernel); bias N(0, 1), the stage's shift mask; yardstick
               F.scaled_dot_product_attention with bias + mask as its
               additive mask, and one torch.matmul.
  swin_bwd     the same cases and inputs, with g N(0, 1); outputs dq, dk,
               dv (the thirds of dqkv) and dW; each call's kernels' device
               ms apart (torch.profiler); yardstick autograd through the
               forward's two calls, from a CUDA graph of the backward.
  proto        chip_smoke.py phase 6a's cases (the iBOT site R=16384, the
               DINO global R=128, the local pairs R=1024, all at K=65536,
               and a ragged R=K=1000), each at both teacher temperatures,
               and the iBOT site at the collate's layout (g = 0 past the
               masked patches); outputs ce, lse_s, lse_t, dxs, dws (values
               that differ only in the sign of a zero are counted apart);
               each of the three kernels timed apart; no single PyTorch
               call computes them: the forward's yardstick at the iBOT site
               is several (two bf16 torch.matmul, then logsumexp and the
               softmax-weighted sum in f32; not the kernel's bits), from a
               CUDA graph.

With --full a turn also runs its checkout's `chip_smoke.py` phases and
reports the rates: phase 7b (`mha`, `mha_bwd`: APLA "full" served at b64
and trained at accum 8 and 1), phases 3 and 9b (`fused`: the classifier
served at b64, the segmenter trained and served), phases 5, 7b and 9b
(`bwd`: the supervised recipe, "full" and the segmenter trained, with
their first-step |dloss| against the plain arm), phases 10b and 8b
(`int8`: the classifier served W8A8 and float at b64, with 10b's profile,
and the detector, whose W8A8 artifact serves in f32), phase 8b (`swin`,
`swin_bwd`: the detector trained at b16 and served at b8 and b16, with
its first-step readings and, for `swin_bwd`, its profile's groups),
phase 6b (`proto`: the DINOv2 recipe trained at b64, with its profile's
proto-CE kernel ms).  Prints one JSON line per turn and a summary; exits
non-zero without a card.
"""

import argparse
import contextlib
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import time

SHAPES = {"mha": ((1, 257, 768), (8, 257, 768), (64, 257, 768),
                  (512, 50, 768), (2, 1370, 768), (8, 1025, 1024)),
          "fused": ((1, 257, 768), (8, 257, 768), (64, 257, 768),
                    (512, 50, 768), (2, 1370, 768), (8, 1025, 1024)),
          "bwd": ((64, 257, 768), (512, 50, 768), (2, 1370, 768),
                  (8, 1025, 1024)),
          "mha_bwd": ((64, 257, 768), (1, 257, 768), (8, 257, 768),
                      (512, 50, 768), (2, 1370, 768))}
# (name, M, K, N, group, x dtype, with a bias): chip_smoke.py phase 10a's
INT8_SHAPES = (
    ("qkv b64", 64 * 257, 768, 2304, 768, "bfloat16", False),
    ("fc1 b64", 64 * 257, 768, 3072, 768, "bfloat16", False),
    ("fc2 b64", 64 * 257, 3072, 768, 3072, "bfloat16", False),
    ("qkv b1", 257, 768, 2304, 768, "bfloat16", False),
    ("fc1 b1", 257, 768, 3072, 768, "bfloat16", False),
    ("fc2 b1", 257, 3072, 768, 3072, "bfloat16", False),
    ("seg fc2 b8", 8 * 1025, 4096, 1024, 4096, "bfloat16", False),
    ("swin stage-0 qkv b16", 16 * 56 * 56, 96, 288, 96, "float32", False),
    ("row 13 fc2, groups of 256, M ragged", 64 * 257 - 5, 3072, 768, 256,
     "bfloat16", False),
    ("fc1 b64 + bias", 64 * 257, 768, 3072, 768, "bfloat16", True))
SHAPES["int8"] = tuple(case[0] for case in INT8_SHAPES)
# (name, windows, N, C, side of the stage's feature map for the shift mask
# (0: no mask), random mask planes (N = 64, no Swin-T stage))
SWIN_SHAPES = (
    ("b16 stage 0 shifted", 1024, 49, 96, 56, 0),
    ("b16 stage 0", 1024, 49, 96, 0, 0),
    ("b16 stage 1 shifted", 256, 49, 192, 28, 0),
    ("b16 stage 1", 256, 49, 192, 0, 0),
    ("b16 stage 2 shifted", 64, 49, 384, 14, 0),
    ("b16 stage 2", 64, 49, 384, 0, 0),
    ("b16 stage 3", 16, 49, 768, 0, 0),
    ("b1 stage 0 shifted", 64, 49, 96, 56, 0),
    ("b8 stage 0 shifted", 512, 49, 96, 56, 0),
    ("N=64, 4 mask planes", 256, 64, 96, 0, 4),
    ("b1 window 12 (Swin-B at 384) stage 0 shifted", 64, 144, 128, 96, 0))
SHAPES["swin"] = tuple(case[0] for case in SWIN_SHAPES)
SHAPES["swin_bwd"] = SHAPES["swin"]
# (R, K, teacher temperature, g at the collate's layout): phase 6a's
PROTO_SHAPES = tuple((r, k, tt, False) for r, k in (
    (16384, 65536), (128, 65536), (1024, 65536), (1000, 1000))
    for tt in (0.04, 0.07)) + ((16384, 65536, 0.04, True),)
SHAPES["proto"] = tuple(f"R={r} K={k} tau_t={tt}"
                        + (" collate layout" if collate else "")
                        for r, k, tt, collate in PROTO_SHAPES)
PROTO_KERNELS = ("fwd", "dxs", "dws")
OUTPUTS = {"mha": ("o",), "fused": ("o",), "bwd": ("dq", "dk", "dv", "dW_t"),
           "mha_bwd": ("dq", "dk", "dv"), "int8": ("y",), "swin": ("out",),
           "swin_bwd": ("dq", "dk", "dv", "dW"),
           "proto": ("ce", "lse_s", "lse_t", "dxs", "dws")}
SCALE = 0.125
# The recipe's rank-128 index file (chip_smoke.py RECIPE): phase 4 times
# the backward with block 0's columns.
INDS = "params/finetune/dinov2/ImageNet/vit_b/inds-vit_b-rand_128.json"


def _time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(torch, fn, calls=200, rounds=15):
    """The host's ms to launch one call of `fn`: the least of `rounds`
    rounds of `calls` calls, each from an idle device (a run of small
    calls is bound by the host, whose time varies with the machine's
    other load)."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return best


def _graph_ms(torch, fn, calls=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(torch, graph.replay, iters=10, warmup=2) / calls


def _grad_graph_ms(torch, forward, inputs, g, calls=5):
    """Device ms of one autograd backward of `forward(*inputs)` against the
    cotangent g, from a CUDA graph: the forward runs on the capture stream,
    so that autograd queues the backward's kernels there; None where the
    capture fails."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(stream):
            out = forward(*inputs)
            for _ in range(2):
                torch.autograd.grad(out, inputs, g, retain_graph=True)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                torch.autograd.grad(out, inputs, g, retain_graph=True)
    except RuntimeError as err:
        print(f"autograd graph not captured: {err}", file=sys.stderr)
        return None
    return _time_ms(torch, graph.replay, iters=10, warmup=2) / calls


def _kernel_ms(torch, fn, calls=20):
    """Device ms per call of `fn` by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "") \
                .split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() \
                / 1e3 / calls
    return out


def _int8_calls(torch, case, gen, dev):
    """(kernel call, [_int_mm, matmul] yardsticks, plain version) of a
    phase 10a case on seeded inputs, in this turn's checkout."""
    from apla_tpu_torch.ops import int8_matmul as tim
    from apla_tpu_torch.ops.quant import (QuantizedKernel, dequantize_weight,
                                          quantize_weight)
    _, m, k, n, group, dt, with_bias = case
    dtype = getattr(torch, dt)
    x = torch.randn((m, k), generator=gen).to(dev, dtype)
    w = torch.randn((k, n), generator=gen) * k ** -0.5
    qk = QuantizedKernel(*quantize_weight(w)).to(dev)
    bias = (torch.randn((n,), generator=gen) * 0.1).to(dev) \
        if with_bias else None
    codes = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
    w_mm = dequantize_weight(qk.w_int8, qk.scale).to(dtype)
    args = (x, qk.w_int8, qk.scale, group, qk.w_kmajor)
    if bias is None:
        def call():
            return tim.fused_int8_matmul(*args)

        def plain():
            return tim.fused_int8_matmul_reference(*args[:4])
        matmul = (lambda: torch.matmul(x, w_mm))
    else:
        b_x = bias.to(dtype)
        if "bias" in inspect.signature(tim.fused_int8_matmul).parameters:
            def call():
                return tim.fused_int8_matmul(*args, bias=bias)
        else:
            def call():
                y = tim.fused_int8_matmul(*args)
                return y + bias.to(y.dtype)

        def plain():
            return tim.fused_int8_matmul_reference(*args[:4]) + b_x
        matmul = (lambda: torch.addmm(b_x, x, w_mm))
    return call, [lambda: torch._int_mm(codes, qk.w_kmajor.t()), matmul], \
        plain


def _int8_worker(torch, dev, out, saved):
    gen = torch.Generator().manual_seed(0)
    for case in INT8_SHAPES:
        call, (int_mm, matmul), plain = _int8_calls(torch, case, gen, dev)
        got = call()
        saved.append((got.cpu(),))
        err = (got.float() - plain().float()).abs().max().item()
        host_ms = _host_ms(torch, call)
        out["calls"].append({
            "shape": case[0], "max_abs_err": err, "host_ms": host_ms,
            "ms": _time_ms(torch, call), "graph_ms": _graph_ms(torch, call),
            "kernels_ms": _kernel_ms(torch, call),
            "library_ms": _time_ms(torch, int_mm),
            "library_graph_ms": _graph_ms(torch, int_mm),
            "matmul_ms": _time_ms(torch, matmul),
            "matmul_graph_ms": _graph_ms(torch, matmul)})


def _swin_calls(torch, case, gen, dev, backward=False):
    """(kernel call, SDPA + matmul yardstick, plain version) of a Swin
    case on seeded inputs, in this turn's checkout; `backward`: the
    backward's, its yardstick as (forward, inputs, cotangent) for
    _grad_graph_ms."""
    from apla_tpu_torch.models.swin import _shift_mask
    from apla_tpu_torch.ops import fused_swin_attn as fs
    _, b, n, c, side, planes = case
    heads, scale = c // 32, 32 ** -0.5
    qkv = torch.randn((b, n, 3 * c), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(dev,
                                                           torch.bfloat16)
    bias = torch.randn((heads, n, n), generator=gen).to(dev)
    mask = None
    if side:
        win = int(round(n ** 0.5))
        mask = torch.from_numpy(_shift_mask(side, side, win,
                                            win // 2)).to(dev)
    elif planes:
        m = torch.rand((planes, n, n), generator=gen) > 0.6
        m = m & m.transpose(1, 2) & ~torch.eye(n, dtype=torch.bool)[None]
        mask = torch.where(m, -1e9, 0.0).to(dev)
    terms = bias[None]
    if mask is not None:
        terms = terms + mask[torch.arange(b, device=dev)
                             % mask.shape[0]][:, None]
    attn_mask = terms.to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(x, wx):
        q, k, v = x.unflatten(-1, (3, heads, 32)).permute(2, 0, 3, 1, 4)
        return torch.matmul(sdpa(q, k, v, attn_mask=attn_mask, scale=scale)
                            .transpose(1, 2).reshape(b, n, c), wx)

    if not backward:
        return (lambda: fs.fused_swin_attn_fwd(qkv, w, bias, mask, heads,
                                               scale),
                lambda: library(qkv, w),
                lambda: fs.fused_swin_attn_fwd_reference(qkv, w, bias, mask,
                                                         heads, scale))
    g = torch.randn((b, n, c), generator=gen).to(dev, torch.bfloat16)
    lq, lw = qkv.clone().requires_grad_(), w.clone().requires_grad_()
    return (lambda: fs.fused_swin_attn_bwd(qkv, w, g, bias, mask, heads,
                                           scale),
            (library, (lq, lw), g),
            lambda: fs.fused_swin_attn_bwd_reference(qkv, w, g, bias, mask,
                                                     heads, scale))


def _proto_inputs(torch, r, k, gen, dev, collate):
    """chip_smoke.py phase 6a's inputs: unit-norm rows xs, xt [r, 256] and
    prototype columns ws, wt [256, k] in bf16, a center [k], g [r]; with
    `collate`, g is 0 past the masked patches of 64 crops that each mask
    U(0.1, 0.5) of 256."""
    def unit(shape, dim):
        x = torch.randn(shape, generator=gen)
        return (x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)).to(
            dev, torch.bfloat16)

    g = torch.rand(r, generator=gen) / 64
    if collate:
        ratios = 0.1 + 0.4 * torch.rand(64, generator=gen)
        g[int((ratios * 256).long().sum()):] = 0
    return (unit((r, 256), -1), unit((256, k), 0), unit((r, 256), -1),
            unit((256, k), 0), (0.1 * torch.randn(k, generator=gen)).to(dev),
            g.to(dev))


def _proto_worker(torch, dev, out, saved):
    """Phase 6a's cases in this turn's checkout: outputs saved, each
    kernel timed apart (the forward's lse feed the backward)."""
    from apla_tpu_torch.ops import proto_ce as pc
    gen = torch.Generator().manual_seed(2)
    inputs = {}
    for r, k, tt, collate in PROTO_SHAPES:
        if (r, k, collate) not in inputs:
            inputs = {(r, k, collate): _proto_inputs(torch, r, k, gen, dev,
                                                     collate)}
        xs, ws, xt, wt, c, g = inputs[(r, k, collate)]
        ce, ls, lt = pc.proto_ce_fwd(xs, ws, xt, wt, c, tt, 0.1)
        bargs = (xs, ws, xt, wt, c, tt, 0.1, ls, lt, g)
        dxs, dws = pc.proto_ce_dxs(*bargs), pc.proto_ce_dws(*bargs)
        saved.append(tuple(x.cpu() for x in (ce, ls, lt, dxs, dws)))
        calls = {"fwd": lambda: pc.proto_ce_fwd(xs, ws, xt, wt, c, tt, 0.1),
                 "dxs": lambda: pc.proto_ce_dxs(*bargs),
                 "dws": lambda: pc.proto_ce_dws(*bargs)}
        rec = {"shape": [r, k, tt, collate]}
        for name, call in calls.items():
            rec[f"{name}_host_ms"] = _host_ms(torch, call, calls=20,
                                              rounds=5)
            rec[f"{name}_ms"] = _time_ms(torch, call, iters=10, warmup=2)
            rec[f"{name}_graph_ms"] = _graph_ms(torch, call, calls=5)
        if (r, k, collate) == PROTO_SHAPES[0][:2] + (False,):
            def library():
                s = torch.matmul(xs, ws).float().div_(0.1)
                t = torch.matmul(xt, wt).float().sub_(c).div_(tt)
                lse_s = torch.logsumexp(s, dim=-1)
                return (lse_s - (torch.softmax(t, dim=-1) * s).sum(dim=-1),
                        lse_s, torch.logsumexp(t, dim=-1))
            rec["library_graph_ms"] = _graph_ms(torch, library, calls=2)
        out["calls"].append(rec)
        del ce, ls, lt, dxs, dws, bargs, calls


def _split(kernel, got):
    """A call's outputs as a tuple in OUTPUTS[kernel]'s order."""
    if kernel in ("mha", "fused", "swin"):
        return (got,)
    with_dw = kernel in ("bwd", "swin_bwd")
    dqkv = got[0] if with_dw else got
    c = dqkv.shape[-1] // 3
    parts = tuple(dqkv[..., i * c:(i + 1) * c] for i in range(3))
    return parts + ((got[1],) if with_dw else ())


def _calls(torch, kernel, b, n, c, gen, dev):
    """(kernel call, library call, plain version) on seeded inputs."""
    heads = c // 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qkv = torch.randn((b, n, 3 * c), generator=gen).to(dev, torch.bfloat16)

    def split(x):
        return x.unflatten(-1, (3, heads, 64)).permute(2, 0, 3, 1, 4)

    q, k, v = split(qkv)
    if kernel == "mha":
        from apla_tpu_torch.ops import mha as tmha
        return (lambda: tmha.mha_fwd(qkv, heads, SCALE),
                lambda: sdpa(q, k, v, scale=SCALE),
                lambda: tmha.mha_fwd_reference(qkv, heads, SCALE))
    if kernel == "mha_bwd":
        from apla_tpu_torch.ops import mha as tmha
        d_o = torch.randn((b, n, c), generator=gen).to(dev, torch.bfloat16)
        lq = qkv.clone().requires_grad_()
        lout = sdpa(*split(lq), scale=SCALE)
        lg = d_o.unflatten(-1, (heads, 64)).transpose(1, 2)
        return (lambda: tmha.mha_bwd(qkv, d_o, heads, SCALE),
                lambda: torch.autograd.grad(lout, lq, lg, retain_graph=True),
                lambda: tmha.mha_bwd_reference(qkv, d_o, heads, SCALE))
    from apla_tpu_torch.ops import fused_apla_attn as fa
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(dev,
                                                           torch.bfloat16)
    if kernel == "fused":
        return (lambda: fa.fused_apla_attn_fwd(qkv, w, heads, SCALE),
                lambda: torch.matmul(sdpa(q, k, v, scale=SCALE)
                                     .transpose(1, 2).reshape(b, n, c), w),
                lambda: fa.fused_apla_attn_fwd_reference(qkv, w, heads,
                                                         SCALE))
    g = torch.randn((b, n, c), generator=gen).to(dev, torch.bfloat16)
    if c == 768:
        from apla_tpu_torch.apla.core import load_indices
        inds = torch.as_tensor(load_indices(INDS, 12, 768)[0],
                               dtype=torch.int64).to(dev)
    else:
        inds = torch.arange(c, device=dev)
    lq, lw = qkv.clone().requires_grad_(), w.clone().requires_grad_()
    lq_, lk_, lv_ = split(lq)
    lout = torch.matmul(sdpa(lq_, lk_, lv_, scale=SCALE).transpose(1, 2)
                        .reshape(b, n, c), lw)
    return (lambda: fa.fused_apla_attn_bwd(qkv, w, g, inds, heads, SCALE),
            lambda: torch.autograd.grad(lout, (lq, lw), g,
                                        retain_graph=True),
            lambda: fa.fused_apla_attn_bwd_reference(qkv, w, g, inds, heads,
                                                     SCALE))


def worker(tree: str, kernel: str, full: bool, outputs: str) -> dict:
    """One turn, inside `tree`: its own package and chip_smoke; the kernel's
    outputs saved as `outputs`."""
    sys.path.insert(0, tree)
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = {"tree": tree, "calls": []}
    saved = []
    t0 = time.perf_counter()
    if kernel == "int8":
        _int8_calls(torch, ("", 64, 64, 64, 64, "bfloat16", False),
                    torch.Generator(), dev)[0]()
    elif kernel in ("swin", "swin_bwd"):
        _swin_calls(torch, ("", 1, 9, 32, 0, 0), torch.Generator(), dev,
                    kernel == "swin_bwd")[0]()
    elif kernel == "proto":
        from apla_tpu_torch.ops import proto_ce as pc
        one = [torch.ones((8, 256), device=dev), torch.ones((256, 8),
                                                           device=dev)]
        ce, ls, lt = pc.proto_ce_fwd(*one, *one, torch.zeros(8, device=dev),
                                     0.04, 0.1)
        pc.proto_ce_dxs(*one, *one, torch.zeros(8, device=dev), 0.04, 0.1,
                        ls, lt, ce)
    else:
        _calls(torch, kernel, 1, 1, 64, torch.Generator(), dev)[0]()
    out["build_s"] = time.perf_counter() - t0
    cases = {"int8": (), "proto": (), "swin": SWIN_SHAPES,
             "swin_bwd": SWIN_SHAPES}.get(kernel, SHAPES[kernel])
    for case in cases:
        if kernel in ("swin", "swin_bwd"):
            call, library, plain = _swin_calls(torch, case, gen, dev,
                                               kernel == "swin_bwd")
            b, n, c = case[1:4]
        else:
            b, n, c = case
            call, library, plain = _calls(torch, kernel, b, n, c, gen, dev)
        got = _split(kernel, call())
        saved.append(tuple(x.cpu() for x in got))
        ref = _split(kernel, plain())
        err = max((x.float() - r.float()).abs().max().item()
                  for x, r in zip(got, ref))
        del ref
        host_ms = _host_ms(torch, call)
        rec = {"shape": [b, n, 3 * c], "max_abs_err": err, "host_ms": host_ms,
               "ms": _time_ms(torch, call),
               "graph_ms": _graph_ms(torch, call)}
        if kernel == "swin_bwd":
            rec["kernels_ms"] = _kernel_ms(torch, call)
            rec["library_graph_ms"] = _grad_graph_ms(torch, *library)
            forward, inputs, g = library
            lout = forward(*inputs)
            rec["library_ms"] = _time_ms(torch, lambda: torch.autograd.grad(
                lout, inputs, g, retain_graph=True))
            del lout
        else:
            rec["library_ms"] = _time_ms(torch, library)
            # autograd does not capture into a CUDA graph as it is called
            rec["library_graph_ms"] = (
                None if kernel in ("bwd", "mha_bwd")
                else _graph_ms(torch, library))
        out["calls"].append(rec)
    if kernel == "int8":
        _int8_worker(torch, dev, out, saved)
    if kernel == "proto":
        _proto_worker(torch, dev, out, saved)
    torch.save(saved, outputs)
    if full:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(tree, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            _phases(smoke, kernel, dev, out)
        # the first step's kernel arm against the plain arm, as printed;
        # int8: 10b's and 8b's W8A8 lines; proto, swin_bwd: the profiles
        out["first_step"] = [ln for ln in log.getvalue().splitlines()
                             if "vs plain arm: |dloss|" in ln
                             or (kernel == "int8" and (
                                 ln.startswith("[10b w8a8]")
                                 or "W8A8 artifact" in ln))
                             or (kernel == "proto" and (
                                 "profile by group" in ln
                                 or "profile, fused arm" in ln))
                             or (kernel == "swin_bwd"
                                 and "[8b det] profile" in ln
                                 and "top kernel" not in ln)]
        print(log.getvalue()[-20000:], file=sys.stderr)
    return out


def _phases(smoke, kernel, dev, out):
    """--full: the turn's chip_smoke phases, rates into `out`."""
    smoke.phase_build()
    if kernel in ("mha", "mha_bwd", "bwd"):
        serve, train = smoke.phase_full(dev)
        out["full_serve_img_s"] = {"kernel": serve[1], "plain": serve[2]}
        out["full_train_img_s"] = {f"{name} accum {acc}": r
                                   for (name, acc), (r, _) in
                                   sorted(train[1].items())}
    if kernel == "fused":
        serve = smoke.phase_slice(dev)
        out["serve_img_s"] = {"fused": serve[1], "plain": serve[2]}
    if kernel == "bwd":
        _, rates = smoke.phase_train(dev)
        out["train_img_s"] = {f"{name} accum {acc}": r
                              for (name, acc), (r, _) in
                              sorted(rates.items())}
    if kernel == "int8":
        _, out["w8a8_img_s"] = smoke.phase_w8a8(dev)
    if kernel in ("int8", "swin", "swin_bwd"):
        _, det = smoke.phase_det(dev)
        out["det_img_s"] = {f"{what} {name}": r for (what, name), (r, _)
                            in sorted(det.items())}
    if kernel == "proto":
        launches, ssl = smoke.phase_ssl(dev)
        out["ssl_img_s"] = {name: r for name, (r, _) in sorted(ssl.items())}
        out["ssl_launches"] = list(launches)
    if kernel in ("fused", "bwd"):
        _, seg = smoke.phase_seg(dev)
        out["seg_img_s"] = {f"{what} {name}": r for (what, name), (r, _)
                            in sorted(seg.items())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    ap.add_argument("--kernel", choices=tuple(SHAPES), default="mha",
                    help="the kernel to compare (default: mha)")
    ap.add_argument("--full", action="store_true",
                    help="also run each checkout's chip_smoke phases (mha, "
                         "mha_bwd: 7b; fused: 3 and 9b; bwd: 5, 7b, 9b; "
                         "int8: 10b and 8b; swin, swin_bwd: 8b; proto: "
                         "6b)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--outputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker, args.kernel,
                                            args.full, args.outputs)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_mha_fwd: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(args.parent)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    turns = []
    tmp = tempfile.TemporaryDirectory(prefix="compare_mha_fwd_")
    for i, (name, tree) in enumerate((("parent", parent), ("this", here),
                                      ("this", here), ("parent", parent))):
        cmd = [sys.executable, os.path.abspath(__file__), "--parent", parent,
               "--worker", tree, "--outputs",
               os.path.join(tmp.name, f"{i}.pt"), "--kernel", args.kernel] \
            + (["--full"] if args.full else [])
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = {"turn": name, **json.loads(lines[-1][len("RESULT "):])}
        turns.append(res)
        print(json.dumps(res), flush=True)
    outs = [torch.load(os.path.join(tmp.name, f"{i}.pt")) for i in range(4)]
    tmp.cleanup()
    yard = {"mha": "SDPA", "fused": "SDPA + matmul",
            "bwd": "autograd through SDPA + matmul",
            "mha_bwd": "SDPA's autograd", "int8": "torch._int_mm",
            "swin": "SDPA (bias + mask) + matmul",
            "swin_bwd": "autograd through SDPA (bias + mask) + matmul",
            "proto": "fwd: two bf16 matmuls, logsumexp, softmax-weighted "
                     "sum (several calls, not the same bits)"}[args.kernel]
    for i, shape in enumerate(SHAPES[args.kernel]):
        cells = []
        for j, name in enumerate(OUTPUTS[args.kernel]):
            a, b = outs[1][i][j], outs[0][i][j]
            bits = (a.view(torch.int32) == b.view(torch.int32)) \
                if a.dtype == torch.float32 else (a == b)
            same = bits.float().mean().item()
            zeros = int(((a == b) & ~bits).sum())
            cells.append(f"{name}: this == parent bit for bit for "
                         f"{same:.6%} of the values"
                         + (f" ({zeros} more equal as values: +0 / -0)"
                            if zeros else ""))
        if args.kernel == "proto":
            runs = all(torch.equal(outs[1][i][j], outs[2][i][j])
                       and torch.equal(outs[0][i][j], outs[3][i][j])
                       for j in range(len(OUTPUTS[args.kernel])))
            cells.append(f"reruns bit-equal: {runs}")
            for kern in PROTO_KERNELS:
                for key in ("ms", "graph_ms", "host_ms"):
                    for who in ("parent", "this"):
                        vals = [t["calls"][i][f"{kern}_{key}"] for t in turns
                                if t["turn"] == who]
                        cells.append(f"{kern} {who} {key} " + "/".join(
                            f"{v:.4f}" for v in vals))
            lib = [t["calls"][i]["library_graph_ms"] for t in turns
                   if "library_graph_ms" in t["calls"][i]]
            if lib:
                cells.append(f"{yard} graph_ms {min(lib):.4f}-"
                             f"{max(lib):.4f}")
            print(f"{shape}: " + ", ".join(cells))
            continue
        runs = all(torch.equal(outs[1][i][j], outs[2][i][j])
                   and torch.equal(outs[0][i][j], outs[3][i][j])
                   for j in range(len(OUTPUTS[args.kernel])))
        cells.append(f"reruns bit-equal: {runs}")
        for key in ("ms", "graph_ms", "host_ms"):
            for who in ("parent", "this"):
                vals = [t["calls"][i][key] for t in turns
                        if t["turn"] == who]
                cells.append(f"{who} {key} " + "/".join(
                    f"{v:.4f}" for v in vals))
        keys = ("library_ms", "library_graph_ms", "matmul_ms",
                "matmul_graph_ms") if args.kernel == "int8" else (
            ("library_ms",) if args.kernel in ("bwd", "mha_bwd")
            else ("library_ms", "library_graph_ms")
            if args.kernel == "swin_bwd" else ("library_graph_ms",))
        for key in keys:
            lib = [t["calls"][i][key] for t in turns
                   if t["calls"][i][key] is not None]
            if not lib:
                cells.append(f"{yard} {key.split('_', 1)[1]} not measured")
                continue
            name = yard if key.startswith("library") else "torch.matmul"
            cells.append(f"{name} {key.split('_', 1)[1]} "
                         f"{min(lib):.4f}-{max(lib):.4f}")
        if args.kernel in ("int8", "swin_bwd"):
            for who in ("parent", "this"):
                split = [t["calls"][i]["kernels_ms"] for t in turns
                         if t["turn"] == who][0]
                cells.append(f"{who} per kernel (profiler ms) " + "; ".join(
                    f"{k} {v:.4f}" for k, v in split.items()))
        label = shape if args.kernel in ("int8", "swin", "swin_bwd") else \
            f"[{shape[0]}, {shape[1]}, {3 * shape[2]}]"
        print(f"{label}: " + ", ".join(cells))
    if args.full:
        for t in turns:
            print(f"{t['turn']}: " + ", ".join(
                f"{k} {t[k]}" for k in ("full_serve_img_s",
                                        "full_train_img_s", "serve_img_s",
                                        "train_img_s", "seg_img_s",
                                        "w8a8_img_s", "det_img_s",
                                        "ssl_img_s", "ssl_launches")
                if k in t))
            for line in t.get("first_step", []):
                print(f"  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
