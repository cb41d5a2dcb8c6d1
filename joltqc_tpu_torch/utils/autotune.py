"""Per-class chunk size and accumulation mode of the J/K engine, measured
on the device.

Port of ``joltqc_tpu/utils/autotune.py``.  A table maps a class key
``"(la, lb, lc, ld)|(npa, npb, npc, npd)|tier"`` to ``{"chunk", "accum"}``
(plus measurement metadata such as ``mtasks_per_s``, which routes
nothing).  An engine with ``accum='auto'`` takes each class's mode and
chunk from it (scf/jk_contracted.py); the fixed modes keep the port's
own chunks.

Resolution: the table committed for the device
(``joltqc_tpu_torch/data/autotune_<device>.json``) is the base, and the
user table (``autotune_<device>.json`` in the port's cache directory,
utils/plancache.py::cache_root, never the JAX package's) overrides it per
class.  ``tune_workload`` measures a table on the engine's current plan:

    from joltqc_tpu_torch.utils.autotune import tune_workload
    eng.get_jk(dm)                       # the plan to tune on
    tune_workload(eng, block_engine=blk, tile_engine=til)
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..ops.accum import bound_exponent
from ..ops.eri import tier_dtype
from .plancache import cache_root

_TABLE = None
_TABLE_DEV = None
_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def _device_name(device=None) -> str:
    """``gpu_<card name>`` on a CUDA device (the card's own name, spaces
    as underscores), ``cpu_cpu`` on the CPU; the default device is the
    card when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        name = f"gpu_{torch.cuda.get_device_name(dev)}"
    else:
        name = f"{dev.type}_{dev.type}"
    return name.replace(" ", "_")


def _table_path(device=None) -> str:
    """The user table of the device."""
    return os.path.join(cache_root(),
                        f"autotune_{_device_name(device)}.json")


def load_table(device=None) -> dict:
    """The device's table: the committed one, overridden per class by the
    user's ({} if neither exists).  Cached per device name until
    ``_TABLE`` is reset to None."""
    global _TABLE, _TABLE_DEV
    dev = _device_name(device)
    if _TABLE is not None and _TABLE_DEV == dev:
        return _TABLE
    table = {}
    for path in (os.path.join(_DATA, f"autotune_{dev}.json"),
                 _table_path(device)):
        try:
            with open(path) as f:
                table.update(json.load(f))
        except (OSError, ValueError):
            pass
    _TABLE, _TABLE_DEV = table, dev
    return _TABLE


def _key(ls, nprims, tier) -> str:
    return f"{tuple(ls)}|{tuple(nprims)}|{tier}"


def tuned_chunk(ls, nprims, tier, device=None) -> int | None:
    """The table's chunk of a class, or None."""
    v = load_table(device).get(_key(ls, nprims, tier))
    if isinstance(v, dict):
        return v.get("chunk")
    return v


def tuned_accum(ls, nprims, tier, device=None) -> str | None:
    """The table's accumulation mode of a class ('tile', 'scatter',
    'block'), or None."""
    v = load_table(device).get(_key(ls, nprims, tier))
    if isinstance(v, dict):
        return v.get("accum")
    return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_class(engine, entry, B: int | None, repeats: int = 3,
                outer: int = 2, max_chunks: int | None = None) -> float:
    """Seconds per task of one plan entry in its own mode at chunk B (the
    entry's own chunk when None; a block entry's chunk is part of its
    plan), median of ``repeats`` timings of ``outer`` passes, after one
    untimed pass.  Each pass runs the engine's chunk loop
    (``_run_entry``: ``_chunk_eri`` and the entry's accumulation) on
    the first ``max_chunks`` chunks with a density of 0.5 everywhere;
    the card is synchronised around the host clock, and the time is
    divided by the real (nonzero-weight) tasks run."""
    mode = entry["accum"]
    if B is not None and mode == "block":
        raise ValueError("a block entry runs at its plan's chunk")
    chunk = B or engine._entry_chunk(entry)
    stop = entry["ntasks"]
    if max_chunks is not None:
        stop = min(stop, max_chunks * chunk)
    n = int(np.count_nonzero(np.asarray(entry["w"][:stop])))
    dev = engine.device
    nao = engine.nao
    dm = torch.full((1, nao, nao), 0.5, dtype=tier_dtype(entry["tier"]),
                    device=dev)
    acc = engine._accumulators(1, True, True, mode == "tile",
                               mode != "tile")
    e = bound_exponent(entry["bound"])

    def run():
        for a in acc:
            if a is not None:
                a.zero_()
        for _ in range(outer):
            engine._run_entry(entry, mode, dm, acc, e, chunk=chunk,
                              stop=stop)

    run()
    _sync(dev)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / max(n, 1) / outer


def _sizes(engine, entry, sizes):
    """Chunk sizes to try for an entry: powers of two around the port's
    ``JKEngine._chunk(ls)`` (a quarter, a half, the largest power of two
    below it, and the heuristic itself) or the given ``sizes``, all capped
    as ``_chunk`` caps them; sizes above 4x the entry's tasks are dropped
    (the entry's own chunk when that leaves none)."""
    cap = engine._chunk(entry["ls"])
    if sizes is None:
        p = 1 << int(np.floor(np.log2(cap)))
        sizes = (p >> 2, p >> 1, p, cap)
    out = sorted({min(int(b), cap) for b in sizes if b >= 1})
    out = [b for b in out if b <= 4 * entry["ntasks"]]
    return out or [engine._entry_chunk(entry)]


def tune_workload(engine, sizes=None, min_tasks: int = 256,
                  verbose: bool = True, block_engine=None, tile_engine=None,
                  accum_only: bool = False, max_chunks: int | None = 4,
                  budget_s: float | None = None) -> dict:
    """Time every class of the engine's current plan and write the
    winners to the device's user table, which is returned.

    ``engine`` must have a plan (``get_jk`` or ``build_plan`` first); its
    entries are timed in their own mode at each chunk of ``sizes``
    (``_sizes``).  ``block_engine`` / ``tile_engine``: engines with
    ``accum='block'`` / ``'tile'`` and a plan on the same workload; their
    entries of the same class are timed too, the tile ones at each chunk
    (a tile entry's chunk is free in the port, unlike the reference's
    padded tile plans), the block ones at their plan's chunk, and the
    fastest mode and chunk are recorded.  ``accum_only`` times each entry
    at its own chunk only.  Classes run in descending task volume;
    with ``budget_s`` the tuning stops when that many seconds are spent
    and writes what it has."""
    global _TABLE
    if engine._plan is None:
        raise ValueError("engine has no plan yet -- run get_jk once first")

    def by_key(eng, mode):
        if eng is None or eng._plan is None:
            return {}
        return {_key(e["ls"], e["nprims"], e["tier"]): e for e in eng._plan
                if e["accum"] == mode}

    block_by_key = by_key(block_engine, "block")
    tile_by_key = by_key(tile_engine, "tile")
    dev = engine.device
    table = dict(load_table(dev))
    t_start = time.perf_counter()
    entries = sorted(
        engine._plan,
        key=lambda e: -e["ntasks"] * int(
            np.prod([(l + 1) * (l + 2) // 2 for l in e["ls"]])))
    for entry in entries:
        if entry["ntasks"] < min_tasks:
            continue
        if budget_s is not None and time.perf_counter() - t_start > budget_s:
            if verbose:
                print("tune budget spent -- writing partial table",
                      flush=True)
            break
        key = _key(entry["ls"], entry["nprims"], entry["tier"])
        rec, best_t = None, np.inf
        for eng, e in ((engine, entry), (block_engine, block_by_key.get(key)),
                       (tile_engine, tile_by_key.get(key))):
            if e is None or (eng is not engine
                             and e["accum"] == entry["accum"]):
                continue
            if accum_only or e["accum"] == "block":
                runs = [(eng._entry_chunk(e), None)]
            else:
                runs = [(B, B) for B in _sizes(eng, e, sizes)]
            for B, arg in runs:
                t = _time_class(eng, e, arg, max_chunks=max_chunks)
                if verbose:
                    print(f"{key:36s} {e['accum']:7s} B={B:8d} "
                          f"{t * 1e9:9.2f} ns/task", flush=True)
                if t < best_t:
                    rec, best_t = {"chunk": int(B), "accum": e["accum"]}, t
        rec["mtasks_per_s"] = float(f"{1e-6 / max(best_t, 1e-15):.4g}")
        table[key] = rec
    path = _table_path(dev)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    _TABLE = None
    if verbose:
        print(f"wrote {path} ({len(table)} entries)", flush=True)
    return table


__all__ = ["tune_workload", "tuned_chunk", "tuned_accum", "load_table"]
