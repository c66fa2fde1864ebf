#!/usr/bin/env python3
"""Fuzz the port's PNG scanline decoder under AddressSanitizer and UBSan.

    python3 tools/fuzz_png_dec.py [--trials 400] [--out DIR] [FILE ...]

Reads each file (the committed fixtures under `tests/data/png/` by
default) with `native.png_stream` (the chunks and zlib, in Python), then
compiles `apla_tpu_torch/native/png_dec.cpp` with a small C++ harness,
`-fsanitize=address,undefined -fno-sanitize-recover=all`, into DIR (a
temporary directory by default), and feeds `png_decode` each image stream
as read and `--trials` seeded mutations of it: one to six bytes set or
bit-flipped, the stream cut short, and in half the trials the header
changed too (width and height within 1-300, any bit depth of 1-16 and
colour type of 0-7, interlace 0-2, 0-256 palette entries).  Each call
decodes both outputs (RGB and the raw samples) into a buffer of exactly
the size the header asks for, so a write past it stops the run.  A read
or write out of bounds or undefined behaviour stops the run with the
sanitizer's report and a non-zero exit; otherwise it prints how many
calls decoded and how many the decoder refused.  Needs g++ with the
sanitizer runtimes; `tests/test_torch_png.py`'s
`test_mutated_streams_decode_or_raise` is the quick form of the same
check, without the sanitizers.
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "apla_tpu_torch", "native")

HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>
extern "C" int png_decode(const uint8_t*, long, int, int, int, int, int,
                          const uint8_t*, int, int, uint8_t*, long);
static long decoded = 0, refused = 0;
static long need(int w, int h, int depth, int ctype, int raw) {
    int bands = ctype == 2 ? 3 : ctype == 4 ? (depth == 16 ? 4 : 2)
              : ctype == 6 ? 4 : 1;
    return (long)w * h * (raw ? bands * (ctype == 0 && depth == 16 ? 2 : 1)
                              : 3);
}
static void run(const std::vector<uint8_t>& d, int w, int h, int depth,
                int ctype, int il, const std::vector<uint8_t>& plte) {
    for (int raw = 0; raw < 2; ++raw) {
        std::vector<uint8_t> out(need(w, h, depth, ctype, raw));
        int rc = png_decode(d.data(), d.size(), w, h, depth, ctype, il,
                            plte.data(), (int)plte.size() / 3, raw,
                            out.data(), out.size());
        (rc ? refused : decoded)++;
    }
}
int main(int argc, char** argv) {
    int trials = atoi(argv[1]);
    for (int a = 2; a < argc; ++a) {
        FILE* f = fopen(argv[a], "rb");
        if (!f) return 2;
        int hdr[6];
        if (fread(hdr, sizeof(int), 6, f) != 6) return 2;
        std::vector<uint8_t> plte(hdr[5] * 3), d;
        if (fread(plte.data(), 1, plte.size(), f) != plte.size()) return 2;
        for (int ch; (ch = fgetc(f)) != EOF;) d.push_back((uint8_t)ch);
        fclose(f);
        int w = hdr[0], h = hdr[1];
        run(d, w, h, hdr[2], hdr[3], hdr[4], plte);
        std::mt19937 rng(a * 7919);
        for (int t = 0; t < trials; ++t) {
            std::vector<uint8_t> m = d, p = plte;
            int mw = w, mh = h, dep = hdr[2], ct = hdr[3], il = hdr[4];
            for (int i = 0; i < 1 + t % 6 && !m.empty(); ++i) {
                size_t pos = rng() % m.size();
                switch (rng() % 3) {
                case 0: m[pos] = (uint8_t)rng(); break;
                case 1: m[pos] ^= (uint8_t)(1u << (rng() % 8)); break;
                default: m.resize(pos + 1);
                }
            }
            if (t & 1) {
                mw = 1 + rng() % 300;
                mh = 1 + rng() % 300;
                dep = 1 + rng() % 16;
                ct = rng() % 8;
                il = rng() % 3;
                p.resize(3 * (rng() % 257));
            }
            run(m, mw, mh, dep, ct, il, p);
        }
    }
    printf("calls decoded %ld, refused %ld\n", decoded, refused);
    return 0;
}
"""


def _stream_file(path: str, out_dir: str) -> str:
    """The image stream of a PNG file as the harness reads it: six ints
    (width, height, depth, colour type, interlace, palette entries), the
    palette, then the inflated scanlines."""
    sys.path.insert(0, ROOT)
    from apla_tpu_torch import native
    with open(path, "rb") as f:
        s = native.png_stream(f.read())
    plte = b"" if s["palette"] is None else s["palette"].tobytes()
    dest = os.path.join(out_dir, os.path.basename(path) + ".stream")
    with open(dest, "wb") as f:
        f.write(struct.pack("6i", s["width"], s["height"], s["depth"],
                            s["ctype"], int(s["interlace"]), len(plte) // 3))
        f.write(plte + s["data"])
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--trials", type=int, default=400)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    files = args.files or sorted(
        f for f in glob.glob(os.path.join(ROOT, "tests", "data", "png", "*"))
        if f.endswith(".png"))
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        streams = [_stream_file(f, out) for f in files]
        harness = os.path.join(out, "fuzz_harness.cpp")
        with open(harness, "w") as f:
            f.write(HARNESS)
        exe = os.path.join(out, "fuzz_png_dec")
        subprocess.run(["g++", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        harness, os.path.join(NATIVE, "png_dec.cpp"), "-o",
                        exe], check=True)
        proc = subprocess.run([exe, str(args.trials), *streams])
        return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
