"""Multi-GPU Fock build: process groups and the sharded J/K entry.

Port of ``joltqc_tpu/parallel``.  The compute path lives in the engine
(scf/jk_contracted.py, ``JKEngine(group=...)``); this package provides the
group, device and rank-launch helpers and documents the decomposition
(jk_sharded.py).  Importing it touches no process group.
"""

from .jk_sharded import (
    rank_device, sharded_jk_engine, spawn_ranks, task_group,
)

__all__ = ["rank_device", "sharded_jk_engine", "spawn_ranks", "task_group"]
