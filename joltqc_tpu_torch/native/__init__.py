"""Native (C++) host screen: copy of ``joltqc_tpu/native``.

The task plan (scf/jk_contracted.py::_build_plan) is built on the host,
the analogue of the reference's GPU screening kernel
(JoltQC jqc/backend/jk/screen_jk_tasks.cu).  ``screen.cpp`` fuses
candidate generation, the six-block density refinement and tier routing
into one streaming pass.  It is compiled with g++ at first use into
``joltqc_tpu_torch/_build/native/`` (listed in ``.gitignore``); there is
no pybind11, so the binding is ctypes.  If the build fails the plan falls
back to the numpy screen in scf/tasks.py, with identical results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_build", "native",
)


def _build():
    src = os.path.join(os.path.dirname(__file__), "screen.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"jqc_screen_{tag}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", src, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib():
    """The compiled library, or None when g++ is missing or fails."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"joltqc_tpu_torch.native: build failed ({e}); "
                  "falling back to numpy screening", file=sys.stderr)
            return None
        c = ctypes
        f32p, i32p, u8p = (
            c.POINTER(c.c_float), c.POINTER(c.c_int32), c.POINTER(c.c_uint8)
        )
        lib.jqc_screen_run.restype = c.c_void_p
        lib.jqc_screen_run.argtypes = [
            f32p, c.c_int64, f32p, c.c_int64, f32p, f32p,
            i32p, i32p, i32p, i32p, u8p, u8p,
            f32p, c.c_int64, c.c_int, c.c_float, c.c_float,
            c.c_float, c.c_float, c.c_int,
        ]
        lib.jqc_screen_count.restype = c.c_int64
        lib.jqc_screen_count.argtypes = [c.c_void_p, c.c_int]
        lib.jqc_screen_dqmax.restype = c.c_float
        lib.jqc_screen_dqmax.argtypes = [c.c_void_p, c.c_int]
        lib.jqc_screen_cand.restype = c.c_int64
        lib.jqc_screen_cand.argtypes = [c.c_void_p]
        lib.jqc_screen_cand64.restype = c.c_int64
        lib.jqc_screen_cand64.argtypes = [c.c_void_p]
        lib.jqc_screen_copy.restype = None
        lib.jqc_screen_copy.argtypes = [c.c_void_p, c.c_int, i32p, i32p, f32p]
        lib.jqc_screen_free.restype = None
        lib.jqc_screen_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def _ptr(a, ty):
    return a.ctypes.data_as(ty)


def screen_tasks_native(q1, q2, qv1, qv2, si1, sj1, si2, sj2, diag1, diag2,
                        dcond, same, log32_gen, log64_gen, log32, log64):
    """Fused screened-task build; returns per-tier (t1, t2, w, dqmax)
    plus candidate stats, or None if the native library is unavailable.

    Semantics identical to scf/tasks.py::build_quartet_tasks followed by
    the six-block density refinement of _build_plan (tier order:
    index 0 = fp32, 1 = fp64)."""
    lib = get_lib()
    if lib is None:
        return None
    c = ctypes
    f32p, i32p, u8p = (
        c.POINTER(c.c_float), c.POINTER(c.c_int32), c.POINTER(c.c_uint8)
    )
    q1 = np.ascontiguousarray(q1, np.float32)
    q2 = np.ascontiguousarray(q2, np.float32)
    qv1 = np.ascontiguousarray(qv1, np.float32)
    qv2 = np.ascontiguousarray(qv2, np.float32)
    si1 = np.ascontiguousarray(si1, np.int32)
    sj1 = np.ascontiguousarray(sj1, np.int32)
    si2 = np.ascontiguousarray(si2, np.int32)
    sj2 = np.ascontiguousarray(sj2, np.int32)
    d1 = np.ascontiguousarray(diag1, np.uint8)
    d2 = np.ascontiguousarray(diag2, np.uint8)
    dcond = np.ascontiguousarray(dcond, np.float32)
    nbas = dcond.shape[0]
    h = lib.jqc_screen_run(
        _ptr(q1, f32p), len(q1), _ptr(q2, f32p), len(q2),
        _ptr(qv1, f32p), _ptr(qv2, f32p),
        _ptr(si1, i32p), _ptr(sj1, i32p), _ptr(si2, i32p), _ptr(sj2, i32p),
        _ptr(d1, u8p), _ptr(d2, u8p),
        _ptr(dcond, f32p), nbas, int(same),
        np.float32(log32_gen), np.float32(log64_gen),
        np.float32(log32), np.float32(log64), 1,
    )
    try:
        out = []
        for tier in (0, 1):
            n = lib.jqc_screen_count(h, tier)
            t1 = np.empty(n, np.int32)
            t2 = np.empty(n, np.int32)
            w = np.empty(n, np.float32)
            if n:
                lib.jqc_screen_copy(
                    h, tier, _ptr(t1, i32p), _ptr(t2, i32p), _ptr(w, f32p)
                )
            out.append((t1, t2, w, float(lib.jqc_screen_dqmax(h, tier))))
        cand = int(lib.jqc_screen_cand(h))
        cand64 = int(lib.jqc_screen_cand64(h))
    finally:
        lib.jqc_screen_free(h)
    return out[0], out[1], cand, cand64


__all__ = ["get_lib", "screen_tasks_native"]
