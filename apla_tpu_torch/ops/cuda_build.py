"""Build the port's hand-written CUDA sources (`apla_tpu_torch/csrc/*.cu`)
into shared libraries with a plain C interface, and load them with ctypes.

A library is built at its first CUDA use, never at import: the CPU tests
import every module on hosts with no `nvcc`.  The output lands in
`apla_tpu_torch/_build/<hash>/` (listed in `.gitignore`), keyed by a hash
of the source and the compiler flags, so a changed source rebuilds and an
unchanged one is reused within a checkout.  `nvcc` is found on `PATH`, under
`$CUDA_HOME/bin`, or at `/usr/local/cuda/bin`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where the library for `csrc/<source>` lives once built."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / (src.stem + ".so")


def build_library(source: str) -> Path:
    """Compile `csrc/<source>` unless a build of this exact source exists."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent builder never sees half
    return out


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>`; one handle per process."""
    return ctypes.CDLL(str(build_library(source)))
