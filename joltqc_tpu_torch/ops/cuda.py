"""Device selection and the build of the hand-written CUDA kernels.

Every kernel source under ``joltqc_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(no PyTorch headers), loaded with ctypes: one library per source, and
``csrc/eri_class.cu`` once per class group of kernel A, with the -D flags
of ``ops/eri.py::class_libraries``.  The libraries go into
``joltqc_tpu_torch/_build/kernels/`` (listed in ``.gitignore``), named by
a hash of the source, its flags and the shared headers (``csrc/*.cuh``),
so a checkout builds everything it runs from its own sources.
``build_all`` starts one nvcc per missing library at once and keeps each
one's wall seconds in ``build_seconds``; the first ``load`` of a missing
library builds every missing one that way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "kernels")
SOURCES = tuple(sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu")))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}
build_seconds: dict = {}  # library -> wall seconds of its last nvcc


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for something else; no fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "joltqc_tpu_torch: no CUDA device; pass device='cpu' to run "
            "the plain PyTorch versions"
        )
    return dev


def _nvcc():
    cand = shutil.which("nvcc")
    if cand is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        cand = "/usr/local/cuda/bin/nvcc"
    if cand is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def libraries():
    """{library: (source, extra nvcc flags)}: csrc/<name>.cu as library
    <name>, and csrc/eri_class.cu as each library of
    ``ops/eri.py::class_libraries``."""
    from .eri import class_libraries  # ops/eri.py imports this module

    libs = {name: (name, ()) for name in SOURCES if name != "eri_class"}
    libs.update((name, ("eri_class", flags))
                for name, flags in class_libraries().items())
    return libs


def _so_path(name):
    source, flags = libraries()[name]
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{source}.cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return (os.path.join(CSRC, f"{source}.cu"), flags,
            os.path.join(BUILD_DIR, f"libjqc_{name}_{h.hexdigest()[:16]}.so"))


def build_all(names=None, verbose=False):
    """Compile every missing library of ``names`` (default: all), one nvcc
    process per library, all started together.  Returns {name: ptxas
    log}; raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in libraries() if names is None else names:
        src, flags, so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = so + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, *flags]
        if verbose:
            cmd.append("-Xptxas=-v")
        cmd += [src, "-o", tmp]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = {}

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out = logs[name]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library ``name`` of ``libraries()``; where it is not
    built yet, every missing library is built at once first.
    ``declare(lib)`` sets argtypes/restype once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, _, so = _so_path(name)
            if not os.path.exists(so):
                build_all()
            lib = ctypes.CDLL(so)
            declare(lib)
            _libs[name] = lib
    return lib


def check(rc: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["resolve_device", "build_all", "build_seconds", "libraries",
           "load", "check", "BUILD_DIR"]
