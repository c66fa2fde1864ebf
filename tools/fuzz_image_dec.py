#!/usr/bin/env python3
"""Fuzz the port's BMP, GIF and TIFF decoders under AddressSanitizer and
UBSan.

    python3 tools/fuzz_image_dec.py [--trials 300] [--out DIR] [FILE ...]

Compiles `apla_tpu_torch/native/{bmp,gif,tiff}_dec.cpp` with
`-fsanitize=address,undefined -fno-sanitize-recover=all` into DIR (a
temporary directory by default), then runs a child Python with the ASan
runtime preloaded, whose `native.build_library` hands out those builds:
it reads each file (the committed fixtures under `tests/data/{bmp,gif,
tiff}` by default) and `--trials` seeded mutations of it (one to six
bytes set or bit-flipped, the stream cut short, and in a third of the
trials the parsed header's fields changed too: width and height within
1-300, the layout's bits, samples and flags, the RLE kind, the LZW code
size, the strips' rows) through `native.formats`' parsers and decoders,
each into a buffer of exactly the size the header asks for.  A read or
write out of bounds or undefined behaviour stops the run with the
sanitizer's report and a non-zero exit; a Python exception other than
ValueError (the decoders' refusal) does too.  Otherwise it prints how many
calls decoded and how many the decoders refused.  Needs g++ with the
sanitizer runtimes; `tests/test_torch_image_formats.py`'s
`test_mutated_streams_decode_or_raise` is the quick form of the same
check, without the sanitizers.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "apla_tpu_torch", "native")
SOURCES = ("bmp_dec.cpp", "gif_dec.cpp", "tiff_dec.cpp")

CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, ROOT)
from apla_tpu_torch import native
from apla_tpu_torch.native import formats as nf

native.build_library = lambda source: BUILT[source]
decoded = refused = 0


def mutate(data, rng):
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 7))):
        if not d:
            break
        i = int(rng.integers(0, len(d)))
        k = int(rng.integers(0, 3))
        if k == 0:
            d[i] = int(rng.integers(0, 256))
        elif k == 1:
            d[i] ^= 1 << int(rng.integers(0, 8))
        else:
            del d[i + 1:]
    return bytes(d)


def shake(s, rng):
    # header fields changed after parsing: the decoders' own checks
    s = dict(s)
    s["width"] = int(rng.integers(1, 301))
    s["height"] = int(rng.integers(1, 301))
    if "layout" in s:
        lay = np.array(s["layout"], np.int32)
        lay[0] = rng.choice([1, 2, 4, 8, 16, 3])
        lay[1] = int(rng.integers(0, 6))
        lay[2] = int(rng.integers(0, 6))
        lay[3] = int(rng.integers(0, 1 << 16))
        lay[4] = int(rng.integers(0, 128))
        s["layout"] = lay
    if "kind" in s:
        s["kind"] = int(rng.integers(0, 4))
        s["stride"] = int(rng.integers(0, 1300))
    if "min_code" in s:
        s["min_code"] = int(rng.integers(0, 14))
        x0, y0 = int(rng.integers(0, 5)), int(rng.integers(0, 5))
        s["box"] = (x0, y0, s["width"] - x0 if s["width"] > x0 else 1,
                    s["height"] - y0 if s["height"] > y0 else 1)
        s["width"], s["height"] = s["width"] + 5, s["height"] + 5
    if "chunks" in s:
        s["chunks"] = [(x, y, cw, int(rng.integers(1, 40)), p,
                        int(rng.integers(1, 40)), d)
                       for x, y, cw, ch, p, rows, d in s["chunks"]]
    return s


def run(kind, data, rng, do_shake):
    global decoded, refused
    parse = {"bmp": nf.bmp_stream, "gif": nf.gif_stream,
             "tiff": nf.tiff_stream}[kind]
    decode = {"bmp": nf.bmp_decode, "gif": nf.gif_decode,
              "tiff": nf.tiff_decode}[kind]
    try:
        s = parse(data)
        if do_shake:
            s = shake(s, rng)
        decode(s)
        decoded += 1
    except ValueError:
        refused += 1


for i, path in enumerate(FILES):
    kind = {"bmp": "bmp", "gif": "gif", "tif": "tiff"}[path.rsplit(".", 1)[1]]
    data = open(path, "rb").read()
    rng = np.random.default_rng(i)
    run(kind, data, rng, False)
    for t in range(TRIALS):
        run(kind, mutate(data, rng), rng, t % 3 == 2)
print(f"calls decoded {decoded}, refused {refused}")
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--trials", type=int, default=300)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    files = args.files or sorted(
        f for kind in ("bmp", "gif", "tiff")
        for f in glob.glob(os.path.join(ROOT, "tests", "data", kind, "*"))
        if not f.endswith(".json"))
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        built = {}
        for src in SOURCES:
            lib = os.path.join(out, src.replace(".cpp", "_asan.so"))
            subprocess.run(["g++", "-O1", "-g", "-shared", "-fPIC",
                            "-fsanitize=address,undefined",
                            "-fno-sanitize-recover=all",
                            "-fno-omit-frame-pointer",
                            os.path.join(NATIVE, src), "-o", lib],
                           check=True)
            built[src] = lib
        asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
        ubsan = subprocess.run(["g++", "-print-file-name=libubsan.so"],
                               capture_output=True, text=True,
                               check=True).stdout.strip()
        script = (f"ROOT = {ROOT!r}\nBUILT = {built!r}\n"
                  f"FILES = {files!r}\nTRIALS = {args.trials}\n" + CHILD)
        env = dict(os.environ, LD_PRELOAD=f"{asan} {ubsan}",
                   ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
                   UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
        proc = subprocess.run([sys.executable, "-c", script], env=env)
        return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
