"""Task-sharded J/K Fock build over ``torch.distributed`` ranks.

Port of ``joltqc_tpu/parallel/jk_sharded.py``, with a process group in
place of the device mesh:

 - tasks: every launch's shell-quartet tasks are split into contiguous
   slices, one per rank (the reference's split of the within-chunk batch;
   ERI tasks are independent);
 - the density is replicated (every rank passes the same one; it is
   O(nao^2), small next to the O(ntasks) ERI work);
 - each rank accumulates its slices into the engine's int64 fixed-point
   limbs (ops/accum.py), which are summed with ``all_reduce(SUM)``:
   integer addition is associative, so the result is bit-identical to one
   device for any rank count.

The engine's plan is the same for every rank count (no chunk is rounded
to a multiple of it, unlike the reference, whose XLA shapes were static
per device), so plan files serve any rank count.  Backends: ``nccl``
where every rank has its own card, ``gloo`` where ranks share one (NCCL
refuses two ranks on one device) or run on the CPU; under gloo the
engine copies its CUDA accumulators through host memory itself.
"""

from __future__ import annotations

import os
import time

import torch

from ..ops.cuda import resolve_device


def task_group(backend: str | None = None):
    """The default process group, initialised from the environment
    (``torchrun``'s MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE) when it
    is not yet initialised.  ``backend`` defaults to ``nccl`` when this
    host has a card for each of its ranks (``torch.cuda.device_count() >=
    LOCAL_WORLD_SIZE``, torchrun's count of ranks on this node, which is
    WORLD_SIZE when it is not set), else ``gloo``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "task_group: no process group and no WORLD_SIZE in the "
                "environment; launch with torchrun or call "
                "torch.distributed.init_process_group first")
        if backend is None:
            local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                       os.environ["WORLD_SIZE"]))
            backend = ("nccl" if torch.cuda.device_count() >= local
                       else "gloo")
        dist.init_process_group(backend, init_method="env://")
    return dist.group.WORLD


def rank_device(group=None, device=None) -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)``, made the
    process's current device (before any other CUDA call, so that kernel
    launches find their context), or the CPU when ``device`` asks for it.
    No fallback: without a card and without ``device='cpu'`` it raises."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    import torch.distributed as dist

    rank = dist.get_rank(group)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def sharded_jk_engine(layout, group=None, **kw):
    """``JKEngine(layout, group=group or task_group(), **kw)`` on this
    rank's device (``rank_device``, unless ``device`` is given): the same
    engine, plans and accumulation as on one device, each launch's tasks
    split over the group and the limbs summed exactly, so ``get_jk`` is
    bit-identical to one device on any rank count."""
    from ..scf.jk_contracted import JKEngine

    group = group if group is not None else task_group()
    if kw.get("device") is None:
        kw["device"] = rank_device(group)
    return JKEngine(layout, group=group, **kw)


def spawn_ranks(fn, world: int, args=(), timeout: float | None = None):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    wait for all of them; returns the seconds from spawn to the last exit.
    Raises when a rank fails (``torch.multiprocessing``'s error, with the
    rank's traceback) or when ranks still run after ``timeout`` seconds;
    every rank still alive then is killed, so none outlives the call."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    procs = mp.spawn(fn, args=(world, *args), nprocs=world, join=False)
    try:
        while not procs.join(timeout=1.0):  # raises if a rank failed
            if timeout is not None and time.perf_counter() - t0 > timeout:
                raise TimeoutError(
                    f"{world} ranks still running after {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return time.perf_counter() - t0


__all__ = ["rank_device", "sharded_jk_engine", "spawn_ranks", "task_group"]
