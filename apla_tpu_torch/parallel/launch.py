"""One process per rank.

Counterpart of the JAX `main.py:maybe_init_multihost` and the reference's
`src/utils/launch.py` (mp.spawn -> NCCL DDP).  `launch(fn, n_ranks, ...)`
runs `fn(*args, **kwargs)` on every rank of a fresh process group and
returns rank 0's result:

- Under `torchrun` (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` /
  `MASTER_PORT` set) the process is already one rank: the group comes from
  that environment and `fn` runs here.
- Otherwise `n_ranks` processes are spawned with `torch.multiprocessing`
  (start method "spawn"; `n_ranks` None: every visible card, one on the
  CPU) and join a file store in a fresh directory.  One rank runs here,
  with no spawn, when `n_ranks` is 1 (a one-rank group: the NCCL path
  on one card).

The backend defaults by device: NCCL on CUDA, gloo on the CPU.  NCCL
refuses two ranks on one card, so more ranks than cards under NCCL raises,
naming `backend="gloo"`, which runs them on the card's tensors with the
gather-type collectives staged through host memory (`collectives`).  A
rank's exception fails the launch with that rank's traceback and ends the
others; every group has a timeout on its collectives and the join has one
too, after which every rank is killed.  Only rank 0 prints; a spawned rank
takes the launching process's torch thread count.

`fn` must live in a module of this package: a spawned rank imports it
(and nothing of the caller's `__main__` but what spawn re-runs).
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def torchrun_env() -> bool:
    """True when `torchrun` (or an equivalent) started this process as a
    rank of a group of more than one."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def visible_ranks(device) -> int:
    """Ranks for `n_devices` unset: every visible card, as JAX's mesh
    takes every device; one on the CPU."""
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def rank_device(device, local_rank: int, backend: str,
                world: int) -> torch.device:
    """The rank's device: `cuda:{local_rank mod cards}` on CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("a CUDA launch, but torch sees no CUDA card")
    if backend == "nccl" and world > cards:
        raise ValueError(
            f"{world} ranks on {cards} card(s) under NCCL: NCCL refuses two "
            "ranks on one device; pass backend='gloo' to share a card")
    return torch.device("cuda", local_rank % cards)


def _init_group(backend, init_method, world, rank, device, timeout):
    kw = dict(backend=backend, init_method=init_method, world_size=world,
              rank=rank, timeout=datetime.timedelta(seconds=timeout))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device      # initialise now: a failure raises
    dist.init_process_group(**kw)


def _run_rank(local_rank, fn, args, kwargs, world, backend, device,
              init_method, result_dir, timeout, threads):
    """A spawned rank's body (torch.multiprocessing calls it with the
    rank first)."""
    if local_rank != 0:
        sys.stdout = open(os.devnull, "w")
    torch.set_num_threads(threads)
    dev = rank_device(device, local_rank, backend, world)
    _init_group(backend, init_method, world, local_rank, dev, timeout)
    try:
        result = fn(*args, **kwargs)
        if local_rank == 0:
            torch.save(result, os.path.join(result_dir, "result.pt"))
    except BaseException:
        # every rank's traceback reaches the launch: the first to fail may
        # not be the one torch reports (the others then fail in a
        # collective whose peer is gone)
        with open(os.path.join(result_dir, f"error_{local_rank}.txt"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int | None = None, args=(), kwargs=None, *,
           device="cuda", backend: str | None = None, store_dir=None,
           timeout: float = 900.0):
    """Run `fn(*args, **kwargs)` on every rank of a new group; rank 0's
    result.  `store_dir`: where the file store and the result go (a fresh
    temporary directory by default)."""
    kwargs = kwargs or {}
    backend = backend or default_backend(device)
    if torchrun_env():
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        if n_ranks not in (None, world):
            raise ValueError(f"n_devices={n_ranks} under torchrun with "
                             f"WORLD_SIZE={world}")
        dev = rank_device(device, local, backend, world)
        _init_group(backend, "env://", world, rank, dev, timeout)
        try:
            return fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
    n = visible_ranks(device) if n_ranks is None else int(n_ranks)
    own_dir = store_dir is None
    work = tempfile.mkdtemp(prefix="apla_launch_") if own_dir else \
        os.path.abspath(store_dir)
    os.makedirs(work, exist_ok=True)
    store = os.path.join(work, f"store_{os.getpid()}_{time.time_ns()}")
    init_method = f"file://{store}"
    try:
        if n == 1:
            dev = rank_device(device, 0, backend, 1)
            _init_group(backend, init_method, 1, 0, dev, timeout)
            try:
                return fn(*args, **kwargs)
            finally:
                dist.destroy_process_group()
        # reject NCCL over too few cards before anything starts
        rank_device(device, 0, backend, n)
        result = os.path.join(work, "result.pt")
        ctx = torch.multiprocessing.start_processes(
            _run_rank, args=(fn, args, kwargs, n, backend, device,
                             init_method, work, timeout,
                             torch.get_num_threads()),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout + 60.0
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        if p.is_alive():
                            p.kill()
                    for p in ctx.processes:
                        p.join(10)
                    raise TimeoutError(f"launch of {n} ranks did not end "
                                       f"within {timeout + 60.0:.0f} s")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            errors = [(r, os.path.join(work, f"error_{r}.txt"))
                      for r in range(n)]
            found = [f"rank {r}:\n{open(path).read()}"
                     for r, path in errors if os.path.exists(path)]
            raise RuntimeError(f"a rank of {n} failed:\n"
                               + "\n".join(found or [str(e)])) from e
        if not os.path.exists(result):
            return None
        return torch.load(result, map_location="cpu", weights_only=False)
    finally:
        if own_dir:
            shutil.rmtree(work, ignore_errors=True)
