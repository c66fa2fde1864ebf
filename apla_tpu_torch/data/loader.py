"""Batched data loading on `torch.utils.data`.

Counterpart of `apla_tpu/data/loader.py`, with the same batching contract:
`batch_size`, `shuffle` (deterministic in (seed, epoch), `set_epoch`),
`drop_last`, and one `np.random.Generator` per (seed, epoch, sample index),
so a record's augmentation does not depend on the worker count.  Worker
processes (`num_workers`, capped at the host's cores, started with `spawn`:
the trainer's process has threads, and a fork of it may deadlock) each load
and collate whole batches; a collate gets a generator keyed by (seed,
epoch, batch index) and `batch_key=(epoch, batch index)` (the iBOT mask
collate seeds its masks from the key; the others ignore it).  The workers start at the first pass and serve every
later one (the epoch travels in the batch keys), so each is spawned once.
Batches come out as dicts of CPU tensors: 'image' NHWC (uint8 when the
dataset is in raw mode, else float32; a list of them, one per crop, for a
multi-crop pipeline) and 'label' (int64, or float32 soft targets).

Data parallel (`shard(mesh, accum)`): the loader keeps the global batch's
indices and loads this rank's rows of it only (`parallel.mesh.rank_rows`
after padding to a multiple of W by repeating the last row, as JAX's
`pad_to_multiple` does), so every rank gets the 1-device run's samples
without decoding the others'.  A collate with a `collate_rows` method
(mixup's flip partners, the iBOT masks) is handed the rows' positions and
a loader of any other row of the batch; every other collate sees the
rank's samples.  Such batches carry 'valid' (bool [rows]: false on the
padding).
"""

from __future__ import annotations

import multiprocessing
import os
import weakref

import numpy as np
import torch


def _stack(arrays):
    stacked = np.stack(arrays)
    # uint8 passes through untouched (the on-device augmentation path)
    return stacked if stacked.dtype == np.uint8 else stacked.astype(
        np.float32)


def default_collate(samples, rng=None, batch_key=None):
    """Stack {'image', 'label'} records into numpy batch arrays; records
    whose 'image' is a list of crops (SSL multi-crop) give a list of
    per-crop batches."""
    del rng, batch_key
    first = samples[0]["image"]
    if isinstance(first, list):
        images = [_stack([s["image"][c] for s in samples])
                  for c in range(len(first))]
    else:
        images = _stack([s["image"] for s in samples])
    lab0 = np.asarray(samples[0]["label"])
    if lab0.ndim > 0:
        labels = np.stack([np.asarray(s["label"]) for s in samples]).astype(
            np.float32)
    else:
        labels = np.asarray([s["label"] for s in samples], dtype=np.int64)
    return {"image": images, "label": labels}


def _tensor(v):
    if isinstance(v, list):
        return [_tensor(x) for x in v]
    return torch.from_numpy(np.ascontiguousarray(v))


class _Batches(torch.utils.data.Dataset):
    """Map-style view whose items are whole batches, keyed by (epoch, batch
    index, sample indices)."""

    def __init__(self, dataset, collate_fn, seed, shard=None):
        self.dataset, self.collate_fn, self.seed = dataset, collate_fn, seed
        self.shard = shard

    def __getitem__(self, key):
        epoch, bi, idxs = key

        def load(pos):
            i = int(idxs[pos])
            return self.dataset.__getitem__(
                i, rng=np.random.default_rng((self.seed, epoch, i)))

        rng = np.random.default_rng((self.seed, epoch, bi, 1))
        if self.shard is None:
            batch = self.collate_fn([load(p) for p in range(len(idxs))],
                                    rng=rng, batch_key=(epoch, bi))
        else:
            from ..parallel.mesh import padded_rows, rank_rows
            mesh, accum = self.shard
            n = len(idxs)
            rows = rank_rows(padded_rows(n, mesh.world), mesh, accum)
            src = np.minimum(rows, n - 1)
            samples = [load(p) for p in src]
            rows_collate = getattr(self.collate_fn, "collate_rows", None)
            if rows_collate is None:
                batch = self.collate_fn(samples, rng=rng,
                                        batch_key=(epoch, bi))
            else:
                batch = rows_collate(samples, src, n, load, rng=rng,
                                     batch_key=(epoch, bi))
            batch["valid"] = rows < n
        return {k: _tensor(v) for k, v in batch.items() if v is not None}


class _BatchKeys:
    """The loader's batch keys for its current epoch, anew at each pass.

    It holds the loader weakly: the loader owns the torch loader that owns
    this sampler, and with that cycle a dropped loader was left to the
    cyclic collector, whose teardown of the workers waited out torch's 5 s
    join timeout for each of them.  Without it the workers stop as soon as
    the loader is dropped."""

    def __init__(self, loader):
        self.loader = weakref.proxy(loader)

    def __iter__(self):
        epoch = self.loader.epoch
        return iter([(epoch, bi, idxs) for bi, idxs in
                     enumerate(self.loader._index_batches())])

    def __len__(self):
        return len(self.loader)


class DataLoader:
    def __init__(self, dataset, batch_size=32, shuffle=False, drop_last=False,
                 num_workers=8, prefetch_factor=4, seed=0, collate_fn=None,
                 pin_memory=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.num_workers = max(0, min(int(num_workers or 0),
                                      os.cpu_count() or 1))
        self.prefetch = max(int(prefetch_factor or 2), 1)
        self.seed = seed
        self.epoch = 0
        self.collate_fn = collate_fn or default_collate
        self.pin_memory = bool(pin_memory)
        self._shard = None
        self._loader = None

    def shard(self, mesh, accum: int = 1):
        """Load this rank's rows of each global batch (`mesh` a
        `parallel.mesh.Mesh`; `accum` micro-batches a batch); a no-op with
        one rank.  Before the first pass."""
        if self._loader is not None:
            raise RuntimeError("shard() after the loader started")
        self._shard = (mesh, int(accum)) if mesh.world > 1 else None
        return self

    def set_epoch(self, epoch: int):
        """Reseeds the shuffle."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for start in range(0, end, self.batch_size):
            yield order[start:min(start + self.batch_size, n)]

    def __iter__(self):
        if self._loader is None:
            workers = min(self.num_workers, len(self))
            self._loader = torch.utils.data.DataLoader(
                _Batches(self.dataset, self.collate_fn, self.seed,
                         self._shard),
                batch_size=None, sampler=_BatchKeys(self),
                num_workers=workers,
                prefetch_factor=self.prefetch if workers else None,
                pin_memory=self.pin_memory, persistent_workers=workers > 0,
                multiprocessing_context=multiprocessing.get_context("spawn")
                if workers else None)
        yield from self._loader
