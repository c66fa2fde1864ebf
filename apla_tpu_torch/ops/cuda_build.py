"""Build the port's hand-written CUDA sources (`apla_tpu_torch/csrc/*.cu`)
into shared libraries with a plain C interface, and load them with ctypes.

A library is built at its first CUDA use, never at import: the CPU tests
import every module on hosts with no `nvcc`.  The output lands in
`apla_tpu_torch/_build/<hash>/` (listed in `.gitignore`), keyed by a hash
of the source, the shared headers (`csrc/*.cuh`) and the compiler flags, so
a changed source rebuilds and an unchanged one is reused within a checkout.
The compiler's resource report (`-Xptxas=-v`: registers, spills, shared
memory per kernel) is kept beside the library as `<stem>.ptxas.txt`.
`nvcc` is found on `PATH`, under `$CUDA_HOME/bin`, or at
`/usr/local/cuda/bin`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
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
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)      # atomic: a concurrent builder never sees half
    return out


def resource_report(source: str) -> str:
    """The compiler's per-kernel resource lines for a built `source`."""
    report = library_path(source).with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else ""


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>`; one handle per process."""
    return ctypes.CDLL(str(build_library(source)))


def device_index(t: torch.Tensor) -> int:
    """The CUDA device index of tensor `t` (the current device if unset)."""
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


@functools.cache
def device_smem(library, prepare: str, dev: int) -> int:
    """Runs `library()`'s function `prepare` (opts its kernels in to their
    dynamic shared memory) once per device; returns the device's limit."""
    with torch.cuda.device(dev):
        have = getattr(library(), prepare)(dev)
    if have < 0:
        raise RuntimeError(f"could not set the kernel's shared memory limit "
                           f"on cuda:{dev}")
    return have


class launch_context:
    """`with launch_context(t) as stream:` makes CUDA tensor t's device the
    current one (if it is not) and gives PyTorch's current stream there as
    a raw handle (a `cudaStream_t` as an int), which a kernel launches on.
    One device check and one stream lookup per call, however many launches
    it holds: the small shapes are bound by the host's time per launch."""

    __slots__ = ("dev", "guard")

    def __init__(self, t: torch.Tensor):
        self.dev = t.device.index
        self.guard = None if self.dev == torch.cuda.current_device() \
            else torch.cuda.device(self.dev)

    def __enter__(self) -> int:
        if self.guard is not None:
            self.guard.__enter__()
        return torch._C._cuda_getCurrentRawStream(self.dev)

    def __exit__(self, *exc):
        if self.guard is not None:
            self.guard.__exit__(*exc)


def check_smem(need: int, have: int, what: str) -> None:
    if need > have:
        raise ValueError(
            f"shared memory too small: {what} needs {need} bytes of dynamic "
            f"shared memory per block, the device allows {have}")
