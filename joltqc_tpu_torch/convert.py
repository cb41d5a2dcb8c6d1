"""State carried across from the JAX package: its screened task plans
and its parsed effective core potentials.

This system has no weights; its state is the shell tables, the screened
task plan, the ECP data and the density.  ``ecp_from_numpy`` takes the
JAX package's ``{symbol: ECPData}`` (numpy fields) and returns this
package's, so that one parsed ECP drives both engines.  ``plan_from_numpy`` takes a plan as the JAX
``JKEngine._build_plan`` emits it (a list of dicts of numpy arrays with
keys ls, nprims, tier, cls_idx, tasks, bound, accum, nrows).  With
``layout='tile'`` it keeps the real tasks of every entry -- scatter,
block or tile -- and regroups them into this package's tile layout, so
that the same task list runs through both engines.  With
``layout='as_is'`` a scatter or block entry comes across as it is, pad
tasks, chunking, group slots and tile bases included, so that the very
same chunks and block row keys run through both engines.
"""

from __future__ import annotations

import numpy as np

TIER_NAMES = {"df64": "fp64", "fp64": "fp64", "f32": "f32", "fp32": "f32"}


def plan_from_numpy(entries, classes, tile_w: int = 64, layout: str = "tile"):
    """JAX-format plan entries -> port plan entries.

    ``classes``: the shell classes both engines share
    (scf/tasks.py::build_shell_classes of the same layout and
    merge_nprim).  ``layout='tile'``: pad tasks (weight 0, pointing at a
    class's pad shell) are dropped; every real task keeps its indices,
    weight and tier.  ``layout='as_is'``: the (nchunk, B) task arrays are
    flattened with their pads (the pad shell is a valid row with zero
    coefficients) and run in chunks of B; a block entry keeps ``gslot``,
    ``tb4`` and ``nrows``; a tile entry is refused (its chunks each live
    in one supertile, which this package's tile layout does not need)."""
    from .scf.jk_contracted import flat_entry, tile_entry

    if layout not in ("tile", "as_is"):
        raise ValueError(f"plan_from_numpy: layout {layout!r}")
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
        tier = TIER_NAMES[e["tier"]]
        for k, ci in enumerate(cls_idx):
            if classes[ci].l != ls[k] or classes[ci].nprim != nprims[k]:
                raise ValueError(f"entry {ls}: class {ci} does not match")
        if layout == "tile":
            out.append(tile_entry(
                classes, tile_w, ls, nprims, tier, cls_idx,
                idx[:, real].astype(np.int32), w[real], float(e["bound"]),
            ))
            continue
        accum = e.get("accum", "scatter")
        if accum not in ("scatter", "block"):
            raise ValueError(f"entry {ls}: layout 'as_is' carries scatter "
                             f"and block entries, not {accum!r}")
        entry = flat_entry(ls, nprims, tier, cls_idx, idx, w,
                           float(e["bound"]), accum=accum)
        entry["ntasks"] = int(real.sum())
        entry["chunk"] = int(np.asarray(tasks[0]).shape[1])
        if accum == "block":
            entry.update(
                gslot=np.asarray(tasks[5], np.int32).reshape(-1),
                tb4=np.asarray(tasks[6], np.int32), nrows=int(e["nrows"]))
        out.append(entry)
    return out


def ecp_from_numpy(ecp):
    """JAX-package ``{symbol: ECPData}`` -> this package's ``{symbol:
    ECPData}`` (mol/ecp.py), every array copied.  Reads the fields by
    name (ncore; channels with l, powers, exps, coefs), so it takes any
    object with that layout."""
    from .mol.ecp import ECPChannel, ECPData

    return {
        sym: ECPData(
            ncore=int(data.ncore),
            channels=[
                ECPChannel(int(ch.l), np.array(ch.powers, int),
                           np.array(ch.exps, np.float64),
                           np.array(ch.coefs, np.float64))
                for ch in data.channels
            ],
        )
        for sym, data in ecp.items()
    }


__all__ = ["plan_from_numpy", "ecp_from_numpy"]
