"""Contracted ERI class batches: the dispatch between the plain PyTorch
version (ops/md.py) and the CUDA kernels of kernel A (csrc/eri.cuh).

Port of ``joltqc_tpu/ops/eri.py::contracted_eri_batch`` and of the
Pallas kernel it reaches on a TPU, ``joltqc_tpu/ops/eri_pallas.py``.
The unit of work is a task = one shell quartet of a fixed class
(la, lb, lc, ld, npa..npd); a batch of T tasks gives the Cartesian ERI
blocks (T, nfab, nfcd).

``quartet`` holds, per center X in a, b, c, d, ``coord_X`` (rows, 3),
``exps_X`` / ``coefs_X`` (rows, npX) in the tier's dtype.  Without
``idx`` the rows are the tasks (rows == T).  With ``idx`` (4, T) int32,
the tensors are per-class shell tables and task t of center X reads row
``idx[X, t]`` -- the J/K engine's form, which gathers inside the kernel.
The caller keeps every index in range (the engine checks its plan on the
host); the pad shell of a class is a valid row with zero coefficients.

On the card a class takes one of two routes, decided before launch:
the l-tuples of ``ERI_CLASSES`` launch ``eri_class_kernel``, compiled
for that tuple and tier (csrc/eri_class.cu, ``class_library``); every
other tuple launches the generic kernel (csrc/eri.cu).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from .harmonics import cart_components
from .md import eri_plain

TIER_DTYPE = {"f32": torch.float32, "fp64": torch.float64,
              "df64": torch.float64}
LMAX_KERNEL = 4

# The l-tuples with a specialised kernel (csrc/eri.cuh, eri_class_kernel),
# in both tiers: the quartet classes the J/K engine forms with l <= 2.
# Shell classes sorted by l, pairs with ci >= cj and quartets of pair
# classes p1 >= p2 give la >= lb, lc >= ld and la >= lc.  By library
# group (``class_libraries``).
ERI_CLASS_GROUPS = {
    "l01": ((0, 0, 0, 0), (1, 0, 0, 0), (1, 0, 1, 0), (1, 0, 1, 1),
            (1, 1, 0, 0), (1, 1, 1, 0), (1, 1, 1, 1)),
    "l20": ((2, 0, 0, 0), (2, 0, 1, 0), (2, 0, 1, 1), (2, 0, 2, 0),
            (2, 0, 2, 1), (2, 0, 2, 2)),
    "l21": ((2, 1, 0, 0), (2, 1, 1, 0), (2, 1, 1, 1), (2, 1, 2, 0),
            (2, 1, 2, 1), (2, 1, 2, 2)),
    "l22": ((2, 2, 0, 0), (2, 2, 1, 0), (2, 2, 1, 1), (2, 2, 2, 0),
            (2, 2, 2, 1), (2, 2, 2, 2)),
}
ERI_CLASSES = tuple(ls for g in ERI_CLASS_GROUPS.values() for ls in g)
_GROUP = {ls: g for g, group in ERI_CLASS_GROUPS.items() for ls in group}
TIERS = ("f32", "fp64")


def class_library(tier: str, ls):
    """The library of csrc/eri_class.cu that holds the class kernel of
    (tier, ls), or None where the tuple takes the generic kernel.  Group
    l01 holds both tiers; the la = 2 groups, whose unrolled kernels take
    nvcc longest, one library per tier, so that the libraries build in
    parallel."""
    g = _GROUP.get(tuple(ls))
    if g is None:
        return None
    return "eri_class_l01" if g == "l01" else f"eri_class_{g}_{tier}"


def class_libraries():
    """{library: its nvcc -D flags}: csrc/eri_class.cu built once per
    ``class_library`` name, with the codes la*1000 + lb*100 + lc*10 + ld
    of its classes joined by '_' and its tiers as a mask (1 f32, 2 fp64)."""
    libs = {}
    for bit, tier in enumerate(TIERS):
        for ls in ERI_CLASSES:
            codes, tiers = libs.setdefault(class_library(tier, ls), ({}, set()))
            codes[_class_code(ls)] = None  # an ordered set
            tiers.add(1 << bit)
    return {name: (f"-DJQC_ERI_CLASS_CODES={'_'.join(map(str, codes))}",
                   f"-DJQC_ERI_TIERS={sum(tiers)}")
            for name, (codes, tiers) in libs.items()}


def _class_code(ls):
    return ls[0] * 1000 + ls[1] * 100 + ls[2] * 10 + ls[3]


def tier_dtype(tier: str) -> torch.dtype:
    try:
        return TIER_DTYPE[tier]
    except KeyError:
        raise ValueError(f"unknown tier {tier!r}") from None


def _nf(l):
    return len(cart_components(l))


def _gather(quartet, idx):
    out = {}
    for k, x in enumerate("abcd"):
        rows = idx[k].long()
        for name in ("coord", "exps", "coefs"):
            out[f"{name}_{x}"] = quartet[f"{name}_{x}"][rows]
    return out


_LAUNCH_ARGS = [ctypes.c_int, ctypes.c_void_p * 16, ctypes.c_int * 4,
                ctypes.c_int * 4, ctypes.c_int, ctypes.c_double,
                ctypes.c_void_p, ctypes.c_void_p]


def _declare(lib):
    lib.jqc_eri_launch.restype = ctypes.c_int
    lib.jqc_eri_launch.argtypes = _LAUNCH_ARGS


def _declare_class(lib):
    lib.jqc_eri_class_launch.restype = ctypes.c_int
    lib.jqc_eri_class_launch.argtypes = _LAUNCH_ARGS


def eri_chunk(tier, ls, nprims, quartet, omega: float = 0.0, idx=None):
    """CUDA kernel: contracted ERI blocks (T, nfab, nfcd) of one class
    chunk, same contract as ``contracted_eri_batch``.

    The result is a (T, nfab, nfcd) view of a component-major
    (nfab, nfcd, T) buffer, so that each thread's stores and the J/K
    kernel's loads are coalesced across tasks.  ``launches`` counts every
    launch, ``generic_launches`` those of the generic route."""
    dt = tier_dtype(tier)
    if any(l > LMAX_KERNEL for l in ls):
        raise ValueError(f"eri_chunk: l > {LMAX_KERNEL} in {ls}")
    dev = quartet["exps_a"].device
    if dev.type != "cuda":
        raise ValueError("eri_chunk needs CUDA tensors")
    ptrs = []
    T = None
    for k, (x, npx) in enumerate(zip("abcd", nprims)):
        coord = quartet[f"coord_{x}"]
        exps = quartet[f"exps_{x}"]
        coefs = quartet[f"coefs_{x}"]
        rows = exps.shape[0]
        for t, shape in ((coord, (rows, 3)), (exps, (rows, npx)),
                         (coefs, (rows, npx))):
            if t.dtype != dt or t.device != dev or not t.is_contiguous():
                raise ValueError(f"eri_chunk: center {x} needs contiguous "
                                 f"{dt} on {dev}")
            if tuple(t.shape) != shape:
                raise ValueError(f"eri_chunk: center {x} shape {t.shape}, "
                                 f"want {shape}")
        ptrs += [coord.data_ptr(), exps.data_ptr(), coefs.data_ptr()]
        if idx is None:
            ptrs.append(None)
            n = rows
        else:
            ik = idx[k]
            if ik.dtype != torch.int32 or ik.device != dev or not ik.is_contiguous():
                raise ValueError("eri_chunk: idx must be contiguous int32")
            ptrs.append(ik.data_ptr())
            n = ik.shape[0]
        if T is None:
            T = n
        elif n != T:
            raise ValueError("eri_chunk: centers disagree on T")
    nfab = _nf(ls[0]) * _nf(ls[1])
    nfcd = _nf(ls[2]) * _nf(ls[3])
    lib = class_library("f32" if dt == torch.float32 else "fp64", ls)
    # a class kernel stores every element once; the generic one adds
    # each primitive quartet's block into a zeroed buffer
    alloc = torch.empty if lib else torch.zeros
    out = alloc((nfab * nfcd, T), dtype=dt, device=dev)
    if T:
        if lib:
            fn = cuda.load(lib, _declare_class).jqc_eri_class_launch
        else:
            fn = cuda.load("eri", _declare).jqc_eri_launch
        rc = fn(
            0 if dt == torch.float32 else 1,
            (ctypes.c_void_p * 16)(*ptrs),
            (ctypes.c_int * 4)(*ls), (ctypes.c_int * 4)(*nprims),
            T, float(omega or 0.0), out.data_ptr(), cuda.stream_handle(dev),
        )
        cuda.check(rc, "eri_chunk")
        eri_chunk.launches += 1
        if not lib:
            eri_chunk.generic_launches += 1
    return out.view(nfab, nfcd, T).permute(2, 0, 1)


eri_chunk.launches = 0
eri_chunk.generic_launches = 0


def contracted_eri_batch(tier, ls, nprims, quartet, omega: float = 0.0,
                         idx=None):
    """Cartesian ERI blocks (T, nfab, nfcd) for a batch of shell quartets.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    omega > 0: long-range erf(omega*r12)/r12 kernel."""
    dev = quartet["exps_a"].device
    if dev.type == "cuda":
        return eri_chunk(tier, ls, nprims, quartet, omega, idx)
    if dev.type != "cpu":
        raise ValueError(f"contracted_eri_batch: unsupported device {dev}")
    dt = tier_dtype(tier)
    if idx is not None:
        quartet = _gather(quartet, idx)
    if quartet["exps_a"].dtype != dt:
        raise ValueError(f"contracted_eri_batch: tier {tier} needs {dt}")
    return eri_plain(ls, nprims, quartet, omega)


__all__ = ["contracted_eri_batch", "class_libraries", "class_library",
           "eri_chunk", "eri_plain", "tier_dtype", "ERI_CLASSES",
           "ERI_CLASS_GROUPS"]
