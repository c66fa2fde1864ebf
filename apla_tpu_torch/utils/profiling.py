"""Step-time and device-memory observability.

Counterpart of `apla_tpu/utils/profiling.py`: a host-side step timer with
percentile summaries, which syncs with the device every `sync_every` steps
through a value fetch (the loss), so that asynchronous launches do not make
steps look shorter than they are; and the card's current and peak memory.
The JAX module's `compiled_memory_analysis` reads XLA's compile-time memory
model, which has no counterpart here.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class StepTimer:
    def __init__(self, sync_every: int = 50, skip_first: int = 3):
        self.sync_every = sync_every
        self.skip_first = skip_first
        self._t_last = None
        self._count = 0
        self.samples: list[float] = []

    def tick(self, sync_value=None):
        """Call once per step; pass a device scalar (e.g. the loss): it is
        fetched on sync steps to make a true barrier."""
        now = time.perf_counter()
        self._count += 1
        if sync_value is not None and self._count % self.sync_every == 0:
            float(sync_value)
            now = time.perf_counter()
        if self._t_last is not None and self._count > self.skip_first:
            self.samples.append(now - self._t_last)
        self._t_last = now

    def summary(self) -> dict:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "step_time_mean_ms": round(float(arr.mean()) * 1e3, 2),
            "step_time_p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 2),
            "step_time_p95_ms": round(float(np.percentile(arr, 95)) * 1e3, 2),
            "steps_per_sec": round(1.0 / max(float(arr.mean()), 1e-9), 2),
        }

    def reset(self):
        self.samples.clear()
        self._t_last = None
        self._count = 0


def device_memory_stats(device=None) -> dict:
    """Peak and current memory held by tensors on a CUDA device, in GiB
    (`torch.cuda.max_memory_allocated` / `memory_allocated`); {} on the
    CPU, as the JAX function returns there."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if device.type != "cuda":
        return {}
    return {
        "peak_hbm_gb": round(torch.cuda.max_memory_allocated(device) / 2**30,
                             3),
        "hbm_in_use_gb": round(torch.cuda.memory_allocated(device) / 2**30,
                               3),
    }
