"""Persistent task-plan and Schwarz-q cache of the J/K engine.

Port of ``joltqc_tpu/utils/plancache.py``.  A screened task plan depends
only on the layout, the engine's settings and the density-bound key
(logdm, the shell-block bounds, omega), not on the density itself, and
building one is most of a full-width SCF (the host screen, the sorts and
the Schwarz q through kernel A).  The J/K build is bit-deterministic, so a
re-run of the same workload visits the same keys in the same order and
can load every plan it built before.

Storage: one directory per plan, ``plan_<key>/``, holding each entry's
arrays as raw ``.npy`` files (narrowed exactly by ``_narrow``) and a
``meta.json`` with the entries' metadata and the plan statistics; it is
written under a temporary name and moved into place with ``os.replace``,
and loaded with ``mmap_mode="r"``, so a plan "loads" in milliseconds and
pages in during the upload to the device.  Schwarz q files are
``q_<hash>.npz`` beside them.

Environment, read at every call (as in the JAX package):
  JQC_CACHE_DIR            base directory; the port keeps its files in
                           ``<JQC_CACHE_DIR>/joltqc_tpu_torch/`` (default
                           ``~/.cache/joltqc_tpu_torch``); ``0``/``off``/
                           ``none`` disables the plan and q caches
  JQC_PLAN_CACHE           ``0``/``off``/``none`` disables them
  JQC_PLAN_CACHE_MIN_SECS  a built plan is saved only if its build took at
                           least this many seconds (default 5)

The JAX package writes ``<JQC_CACHE_DIR>/plans``,
``<JQC_CACHE_DIR>/autotune_*.json`` and ``<JQC_CACHE_DIR>/xla``; none of
them lies under the port's directory, and every key also hashes the
port's own tag, so a file one package writes is never read by the other
(the two compute q with different code, and a foreign q could change the
task lists).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

PLAN_VERSION = 1  # bump on any change to the plan entry format
TAG = "joltqc_tpu_torch"
_OFF = ("0", "off", "none")
# the fields of a port plan entry that are saved (``_dev``, the device
# copies, never is): scalars into meta.json, arrays into .npy files
_META = ("ls", "nprims", "tier", "ntasks", "cls_idx", "bound", "accum")
_BLOCK_META = ("chunk", "nrows")
_ARRAYS = ("idx", "w")
_BLOCK_ARRAYS = ("gslot", "tb4")


def cache_root() -> str:
    """The port's cache directory (module docstring)."""
    base = os.environ.get("JQC_CACHE_DIR")
    if base is None or base in _OFF:
        return os.path.expanduser(os.path.join("~", ".cache", TAG))
    base = base.rstrip("/")
    if base.endswith("/xla"):
        base = base[:-4]
    return os.path.join(base, TAG)


def _cache_dir() -> str | None:
    """Directory of the plan and q files, or None when caching is off."""
    if os.environ.get("JQC_PLAN_CACHE", "1") in _OFF:
        return None
    if os.environ.get("JQC_CACHE_DIR") in _OFF:
        return None
    return os.path.join(cache_root(), "plans")


def min_secs() -> float:
    return float(os.environ.get("JQC_PLAN_CACHE_MIN_SECS", "5"))


def _hash_classes(h, classes, fields=("coords", "exps", "coefs", "ao",
                                      "shell_ids")):
    for c in classes:
        h.update(np.int64([c.l, c.nprim, c.nshell]).tobytes())
        for f in fields:
            h.update(np.ascontiguousarray(getattr(c, f)).tobytes())


def plan_key(engine, logdm: float, dm_cond_log, omega: float) -> str | None:
    """Content hash of every plan input, or None when caching is off.

    The JAX package's key with the port's tag and the engine's device type
    in place of the JAX backend, and a device count of 1.  An ``'auto'``
    engine off the card whose table routes no class to block or tile builds
    exactly the scatter plan, so its tag is ``'scatter'`` and the two share
    one file (the JAX package's rule, with the card in place of the TPU)."""
    if _cache_dir() is None:
        return None
    from .autotune import load_table

    table = load_table(engine.device)
    h = hashlib.sha256()
    h.update(f"{TAG} v{PLAN_VERSION}".encode())
    h.update(engine.device.type.encode())
    _hash_classes(h, engine.classes)
    accum_tag = engine.accum
    if (accum_tag == "auto" and engine.device.type != "cuda"
            and not any(isinstance(v, dict)
                        and v.get("accum") in ("block", "tile")
                        for v in table.values())):
        accum_tag = "scatter"
    h.update(json.dumps([
        engine.cutoff_fp32, engine.cutoff_fp64, engine.merge_nprim,
        accum_tag, engine.tile, engine.tile_w, 1,
        round(float(logdm), 9), float(omega or 0.0),
    ]).encode())
    if dm_cond_log is not None:
        h.update(np.ascontiguousarray(dm_cond_log, np.float32).tobytes())
    else:
        h.update(b"nocond")
    # only the routing subset of the table: its measurement metadata
    # (mtasks_per_s) must not invalidate a plan
    routing = {
        k: ({"chunk": v.get("chunk"), "accum": v.get("accum")}
            if isinstance(v, dict) else v)
        for k, v in table.items()
    }
    h.update(json.dumps(routing, sort_keys=True).encode())
    return h.hexdigest()[:32]


def _narrow(a: np.ndarray) -> np.ndarray:
    """Exact narrowing for disk: int32 -> int16 when in range, float32 ->
    float16 when bit-exact (symmetry weights are powers of two in
    [0.125, 1]).  ``JKEngine._entry_dev`` widens back on upload."""
    a = np.asarray(a)
    if a.dtype == np.int32 and a.size:
        if -32768 <= int(a.min()) and int(a.max()) < 32768:
            return a.astype(np.int16)
    elif a.dtype == np.float32 and a.size:
        h = a.astype(np.float16)
        if np.array_equal(h.astype(np.float32), a):
            return h
    return a


def _fields(entry):
    block = entry["accum"] == "block"
    return (_META + (_BLOCK_META if block else ()),
            _ARRAYS + (_BLOCK_ARRAYS if block else ()))


def save_plan(key: str, plan: list[dict], stats: dict) -> int:
    """Persist one plan (module docstring); the bytes written, 0 when
    caching is off, the plan is already on disk or the write failed."""
    d = _cache_dir()
    if d is None or key is None:
        return 0
    pdir = os.path.join(d, f"plan_{key}")
    if os.path.exists(os.path.join(pdir, "meta.json")):
        return 0
    tmp = pdir + f".tmp{os.getpid()}"
    meta = {"stats": stats, "entries": []}
    nbytes = 0
    try:
        os.makedirs(tmp, exist_ok=True)
        for i, e in enumerate(plan):
            scalars, arrays = _fields(e)
            meta["entries"].append({f: e[f] for f in scalars})
            for f in arrays:
                path = os.path.join(tmp, f"e{i}_{f}.npy")
                np.save(path, _narrow(e[f]))
                nbytes += os.path.getsize(path)
        path = os.path.join(tmp, "meta.json")
        with open(path, "w") as f:
            json.dump(meta, f, default=lambda o: o.item())
        nbytes += os.path.getsize(path)
        os.replace(tmp, pdir)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        return 0
    return nbytes


def load_plan(key: str):
    """(plan, stats) with memory-mapped, narrowed arrays, or None (also on
    any error: a caller then builds the plan)."""
    d = _cache_dir()
    if d is None or key is None:
        return None
    pdir = os.path.join(d, f"plan_{key}")
    meta_path = os.path.join(pdir, "meta.json")
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        plan = []
        for i, ent in enumerate(meta["entries"]):
            e = dict(ent, ls=tuple(ent["ls"]), nprims=tuple(ent["nprims"]),
                     cls_idx=tuple(ent["cls_idx"]))
            for f in _fields(e)[1]:
                e[f] = np.load(os.path.join(pdir, f"e{i}_{f}.npy"),
                               mmap_mode="r")
            plan.append(e)
        return plan, meta["stats"]
    except Exception:
        return None


def q_path(engine, pc, omega: float) -> str | None:
    """Disk path of one pair class's Schwarz bounds (keyed by the two
    classes' geometry and basis, omega and the device type, whose kernel
    A computed them), or None when caching is off."""
    d = _cache_dir()
    if d is None:
        return None
    h = hashlib.sha256()
    h.update(f"{TAG} q v{PLAN_VERSION}".encode())
    h.update(engine.device.type.encode())
    _hash_classes(h, [engine.classes[k] for k in (pc.ci, pc.cj)],
                  ("coords", "exps", "coefs"))
    h.update(np.float64([omega]).tobytes())
    return os.path.join(d, f"q_{h.hexdigest()[:24]}.npz")


def save_arrays(path: str | None, **arrs) -> None:
    """np.savez to a temporary name, then ``os.replace``."""
    if path is None:
        return
    tmp = path + f".tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_arrays(path: str | None, names, n: int):
    """The named arrays of an .npz, each of length n, or None."""
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            out = tuple(z[k] for k in names)
    except Exception:
        return None
    return out if all(a.shape == (n,) for a in out) else None


__all__ = ["PLAN_VERSION", "cache_root", "plan_key", "save_plan",
           "load_plan", "q_path", "save_arrays", "load_arrays"]
