"""State carried across from the JAX package: its screened task plans.

This system has no weights; its state is the shell tables, the screened
task plan and the density.  ``plan_from_numpy`` takes a plan as the JAX
``JKEngine._build_plan`` emits it (a list of dicts of numpy arrays with
keys ls, nprims, tier, cls_idx, tasks, bound, accum), keeps the real
tasks of every entry -- scatter, block or tile -- and regroups them into
this package's tile layout, so that the same task list runs through
both engines.
"""

from __future__ import annotations

import numpy as np

TIER_NAMES = {"df64": "fp64", "fp64": "fp64", "f32": "f32", "fp32": "f32"}


def plan_from_numpy(entries, classes, tile_w: int = 64):
    """JAX-format plan entries -> port plan entries.

    ``classes``: the shell classes both engines share
    (scf/tasks.py::build_shell_classes of the same layout and
    merge_nprim).  Pad tasks (weight 0, pointing at a class's pad shell)
    are dropped; every real task keeps its indices, weight and tier."""
    from .scf.jk_contracted import tile_entry

    out = []
    for e in entries:
        tasks = e["tasks"]
        idx = np.stack([np.asarray(t).reshape(-1) for t in tasks[:4]])
        w = np.asarray(tasks[4], np.float32).reshape(-1)
        real = w != 0.0
        if not real.any():
            continue
        ls = tuple(int(x) for x in e["ls"])
        nprims = tuple(int(x) for x in e["nprims"])
        cls_idx = tuple(int(x) for x in e["cls_idx"])
        for k, ci in enumerate(cls_idx):
            if classes[ci].l != ls[k] or classes[ci].nprim != nprims[k]:
                raise ValueError(f"entry {ls}: class {ci} does not match")
        out.append(tile_entry(
            classes, tile_w, ls, nprims, TIER_NAMES[e["tier"]], cls_idx,
            idx[:, real].astype(np.int32), w[real], float(e["bound"]),
        ))
    return out


__all__ = ["plan_from_numpy"]
