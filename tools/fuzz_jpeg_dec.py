#!/usr/bin/env python3
"""Fuzz the port's JPEG decoder under AddressSanitizer and UBSan.

    python3 tools/fuzz_jpeg_dec.py [--trials 300] [--out DIR] [FILE ...]

Compiles `apla_tpu_torch/native/jpeg_dec.cpp` with a small C++ driver,
`-fsanitize=address,undefined -fno-sanitize-recover=all`, into DIR (a
temporary directory by default), then feeds it each file (the committed
fixtures under `tests/data/jpeg/` by default) and `--trials` seeded
mutations of each: one to six bytes set or bit-flipped, anywhere in the
stream in half the trials and in its first 700 bytes (the markers and
tables) in the other half, or the stream cut short.  Every stream goes
through `jpeg_probe`, `jpeg_decode` at scales 8/8, 3/8 and 1/8 (frames
past 4 MP skipped) and `jpeg_decode_resize`.  A read or write out of
bounds, a use after free or undefined behaviour stops the run with the
sanitizer's report and a non-zero exit; otherwise it prints how many
calls decoded and how many the decoder refused.  Needs g++ with the
sanitizer runtimes; the CPU tests' `test_mutated_streams_decode_or_raise`
is the quick form of the same check, without the sanitizers.
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

DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>
extern "C" {
int jpeg_probe(const uint8_t*, long, int*, int*, int*, int*, int*);
int jpeg_decode(const uint8_t*, long, int, uint8_t*, long, int*, int*);
int jpeg_decode_resize(const uint8_t*, long, int, int, uint8_t*, long,
                       int*, int*);
}
static long decoded = 0, refused = 0, skipped = 0;
static void run(const std::vector<uint8_t>& d) {
    int h, w, c, k, p, gh, gw;
    if (jpeg_probe(d.data(), d.size(), &h, &w, &c, &k, &p)) {
        ++refused;
        return;
    }
    if ((long)h * w > 4000000) {
        ++skipped;
        return;
    }
    std::vector<uint8_t> out((size_t)h * w * 3);
    for (int num : {8, 3, 1})
        (jpeg_decode(d.data(), d.size(), num, out.data(), out.size(), &gh,
                     &gw) ? refused : decoded)++;
    std::vector<uint8_t> small(40 * 30 * 3);
    (jpeg_decode_resize(d.data(), d.size(), 40, 30, small.data(),
                        small.size(), &gh, &gw) ? refused : decoded)++;
}
int main(int argc, char** argv) {
    int trials = atoi(argv[1]);
    for (int a = 2; a < argc; ++a) {
        FILE* f = fopen(argv[a], "rb");
        if (!f) return 2;
        std::vector<uint8_t> d;
        for (int ch; (ch = fgetc(f)) != EOF;) d.push_back((uint8_t)ch);
        fclose(f);
        run(d);
        std::mt19937 rng(a * 7919);
        for (int t = 0; t < trials; ++t) {
            std::vector<uint8_t> m = d;
            size_t span = (t & 1) ? std::min<size_t>(700, m.size()) : m.size();
            for (int i = 0; i < 1 + t % 6 && !m.empty(); ++i) {
                size_t pos = rng() % span;
                switch (rng() % 3) {
                case 0: m[pos] = (uint8_t)rng(); break;
                case 1: m[pos] ^= (uint8_t)(1u << (rng() % 8)); break;
                default: m.resize(pos + 1); span = std::min(span, m.size());
                }
            }
            if (!m.empty()) run(m);
        }
    }
    printf("calls decoded %ld, refused %ld; streams past 4 MP skipped %ld\n",
           decoded, refused, skipped);
    return 0;
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--trials", type=int, default=300)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    files = args.files or sorted(
        f for f in glob.glob(os.path.join(ROOT, "tests", "data", "jpeg", "*"))
        if not f.endswith(".json"))
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        driver = os.path.join(out, "fuzz_driver.cpp")
        with open(driver, "w") as f:
            f.write(DRIVER)
        exe = os.path.join(out, "fuzz_jpeg_dec")
        subprocess.run(["g++", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
                        "-I", NATIVE, driver,
                        os.path.join(NATIVE, "jpeg_dec.cpp"), "-o", exe],
                       check=True)
        proc = subprocess.run([exe, str(args.trials), *files])
        return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
