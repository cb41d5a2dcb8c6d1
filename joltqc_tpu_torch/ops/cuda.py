"""Device selection and the build of the hand-written CUDA kernels.

Every kernel source under ``joltqc_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface (no PyTorch headers), loaded with ctypes at first use.  The
libraries go into ``joltqc_tpu_torch/_build/kernels/`` (listed in
``.gitignore``), named by a hash of the source and of the shared headers
(``csrc/*.cuh``), so a checkout builds everything it runs from its own
sources.  ``build_all`` starts one nvcc
per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "kernels")
SOURCES = ("eri", "accum_tile", "accum_block")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


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


def _so_path(name):
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR,
                             f"libjqc_{name}_{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES, verbose=False):
    """Compile every missing library, one nvcc process per source, all
    started together.  Returns {name: ptxas log}; raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = so + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd.append("-Xptxas=-v")
        cmd += [src, "-o", tmp]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built on first use);
    ``declare(lib)`` sets argtypes/restype once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, so = _so_path(name)
            if not os.path.exists(so):
                build_all((name,))
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


__all__ = ["resolve_device", "build_all", "load", "check", "BUILD_DIR"]
