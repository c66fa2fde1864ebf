#!/usr/bin/env python3
"""Time this checkout's attention forward against an earlier checkout's,
on one CUDA card, in one call: the memory-efficient attention forward
(`mha_fwd`, TPU row 8) by default, or with `--kernel fused` the fused APLA
attention forward (`fused_apla_attn_fwd`, TPU rows 1 and 5).

    python3 tools/compare_mha_fwd.py --parent DIR [--kernel fused] [--full]

DIR is a checkout of the earlier commit (e.g. `git archive <commit> | tar
-x -C DIR`, into a directory `.gitignore` lists).  The checkouts run in
turns, each in a process of its own (earlier, this, this, earlier), so the
two are compared on one card under the same conditions.  Each turn builds
its checkout's kernels and times the forward at the shapes the port's
paths give it (b1, b8, b64 at N=257, [512, 50], [2, 1370], C = 768, and
[8, 1025] at C = 1024, the segmenter's, where the fused forward's
attention half runs `mha_fwd`'s kernel) with CUDA
events over calls launched one by one and over a CUDA graph of 20 calls
(device time alone), and the host's time to launch one (the wrapper, its
checks, the launches; 100 calls with no wait), beside
F.scaled_dot_product_attention (`fused`: and one torch.matmul, the
two-call yardstick) on the same inputs, and keeps its outputs so that the
summary can say how many of this checkout's output values equal the
earlier checkout's, bit for bit.  With --full a turn also runs its
checkout's `chip_smoke.py` phase 7b (APLA "full" served at b64 and
trained at accum 8 and 1; `fused`: phases 3 and 9b, the classifier served
at b64 and the segmenter trained and served) and reports the rates.
Prints one JSON line per turn and a summary; exits non-zero without a
card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

SHAPES = {"mha": ((1, 257, 768), (8, 257, 768), (64, 257, 768),
                  (512, 50, 768), (2, 1370, 768), (8, 1025, 1024)),
          "fused": ((1, 257, 768), (8, 257, 768), (64, 257, 768),
                    (512, 50, 768), (2, 1370, 768), (8, 1025, 1024))}
SCALE = 0.125


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


def _graph_ms(torch, fn, calls=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(torch, graph.replay, iters=10, warmup=2) / calls


def _calls(torch, kernel, b, n, c, gen, dev):
    """(kernel call, library call, plain version) on seeded inputs."""
    heads = c // 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qkv = torch.randn((b, n, 3 * c), generator=gen).to(dev, torch.bfloat16)
    q, k, v = qkv.unflatten(-1, (3, heads, 64)).permute(2, 0, 3, 1, 4)
    if kernel == "mha":
        from apla_tpu_torch.ops import mha as tmha
        return (lambda: tmha.mha_fwd(qkv, heads, SCALE),
                lambda: sdpa(q, k, v, scale=SCALE),
                lambda: tmha.mha_fwd_reference(qkv, heads, SCALE))
    from apla_tpu_torch.ops import fused_apla_attn as fa
    w = (torch.randn((c, c), generator=gen) * c ** -0.5).to(dev,
                                                           torch.bfloat16)
    return (lambda: fa.fused_apla_attn_fwd(qkv, w, heads, SCALE),
            lambda: torch.matmul(sdpa(q, k, v, scale=SCALE).transpose(1, 2)
                                 .reshape(b, n, c), w),
            lambda: fa.fused_apla_attn_fwd_reference(qkv, w, heads, SCALE))


def worker(tree: str, kernel: str, full: bool, outputs: str) -> dict:
    """One turn, inside `tree`: its own package and chip_smoke; the forward's
    outputs saved as `outputs`."""
    sys.path.insert(0, tree)
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = {"tree": tree, "fwd": []}
    saved = []
    t0 = time.perf_counter()
    _calls(torch, kernel, 1, 1, 64, torch.Generator(), dev)[0]()
    out["build_s"] = time.perf_counter() - t0
    for b, n, c in SHAPES[kernel]:
        call, library, plain = _calls(torch, kernel, b, n, c, gen, dev)
        got = call()
        saved.append(got.cpu())
        err = (got.float() - plain().float()).abs().max().item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        host_ms = (time.perf_counter() - t0) * 10
        torch.cuda.synchronize()
        out["fwd"].append({
            "shape": [b, n, 3 * c], "max_abs_err": err, "host_ms": host_ms,
            "ms": _time_ms(torch, call),
            "graph_ms": _graph_ms(torch, call),
            "library_ms": _time_ms(torch, library),
            "library_graph_ms": _graph_ms(torch, library)})
    torch.save(saved, outputs)
    if full:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(tree, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smoke.phase_build()
        if kernel == "mha":
            serve, train = smoke.phase_full(dev)
            out["full_serve_img_s"] = {"kernel": serve[1], "plain": serve[2]}
            out["full_train_img_s"] = {f"{name} accum {acc}": r
                                       for (name, acc), (r, _) in
                                       sorted(train[1].items())}
        else:
            serve = smoke.phase_slice(dev)
            out["serve_img_s"] = {"fused": serve[1], "plain": serve[2]}
            _, seg = smoke.phase_seg(dev)
            out["seg_img_s"] = {f"{what} {name}": r for (what, name), (r, _)
                                in sorted(seg.items())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    ap.add_argument("--kernel", choices=("mha", "fused"), default="mha",
                    help="the forward to compare (default: mha)")
    ap.add_argument("--full", action="store_true",
                    help="also run each checkout's chip_smoke phase 7b "
                         "(fused: phases 3 and 9b)")
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
    for i, (b, n, c) in enumerate(SHAPES[args.kernel]):
        same = (outs[1][i] == outs[0][i]).float().mean().item()
        runs = torch.equal(outs[1][i], outs[2][i]) and \
            torch.equal(outs[0][i], outs[3][i])
        cells = [f"this == parent for {same:.6%} of the output values "
                 f"(reruns bit-equal: {runs})"]
        for key in ("ms", "graph_ms", "host_ms"):
            for who in ("parent", "this"):
                vals = [t["fwd"][i][key] for t in turns if t["turn"] == who]
                cells.append(f"{who} {key} " + "/".join(
                    f"{v:.4f}" for v in vals))
        lib = [t["fwd"][i]["library_graph_ms"] for t in turns]
        print(f"[{b}, {n}, {3 * c}]: " + ", ".join(cells)
              + f", {'SDPA' if args.kernel == 'mha' else 'SDPA + matmul'} "
              f"graph_ms {min(lib):.4f}-{max(lib):.4f}")
    if args.full:
        for t in turns:
            if args.kernel == "mha":
                print(f"{t['turn']}: full serve b64 "
                      f"{t['full_serve_img_s']}, train "
                      f"{t['full_train_img_s']}")
            else:
                print(f"{t['turn']}: serve b64 {t['serve_img_s']}, "
                      f"segmenter b8 {t['seg_img_s']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
