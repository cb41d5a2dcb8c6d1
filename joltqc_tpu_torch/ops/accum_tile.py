"""Fused density contraction + exact tile accumulation of one output
stream (the J/K engine's Fock accumulation), and the tile accumulation of
values that are already contracted.

Port of ``joltqc_tpu/ops/accum_tile.py``: ``fused_contract_tile`` and
``tile_accumulate``.  For one output stream xy of a chunk of tasks,
``fused_contract_tile``:

  1. contract V[t, f] = sum_o G[t, gidx[f, o]] * d[t, o] in the tier's
     dtype, where d[t, o] = dsrc[dmapu[iu[t]] * dstride + dmapv[iv[t]]
     + doff[o]] are the density rows of the complement centers;
  2. scale by the stream factor (2 for J) and the task's symmetry weight
     (both powers of two, exact) and convert to fixed point with a
     STATIC bound 2^e >= |V| (a host bound, never a data-dependent max):
     |V| * 2^(120 - e) is split into three 40-bit limbs of V's sign;
  3. add the limbs into the int64 accumulator element
     (rmap[ix[t]] + roff[f], cmap[iy[t]] + coff[f]); the kernel sums the
     tasks of one 64 x 64 block of shells (a supertile of the plan's
     task order) in shared memory first.

Integer addition is associative, so the accumulator is bit-identical for
any task order and any launch split; ``limbs_to_f64`` decodes it once.
CPU tensors run ``accum_tile_plain``; CUDA tensors launch the kernel
(csrc/accum_tile.cu: a contraction pass for step 1, then steps 2 and 3)
through ``accum_tile_chunk``.

``tile_accumulate`` is steps 2 and 3 alone: values (T, nf) go to
``out[ix[t], iy[t], f]`` of a dense (Wx, Wy, nf) tile of limb sums (the
last kernel of csrc/accum_tile.cu through ``tile_accumulate_chunk``,
``tile_accumulate_plain`` on the CPU).  No path of the J/K engine calls
it, in this package as in the reference; it is a public function.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import cuda
from .accum import (  # noqa: F401  (re-exported for this module's callers)
    FRAC_BITS, LIMB_BITS, NLIMB, bound_exponent, check_values, limbs_to_f64,
    split_limbs, value_limbs,
)


@dataclass
class StreamTables:
    """Small per-(class, stream) index tables, int32 on the device."""

    gidx: torch.Tensor  # (nfxy, nfo) flat ERI component of (f, o)
    doff: torch.Tensor  # (nfo,) density offsets of the contracted block
    roff: torch.Tensor  # (nfxy,) output row offset of component f
    coff: torch.Tensor  # (nfxy,) output column offset of component f
    fac: float = 1.0

    @property
    def nfxy(self):
        return self.gidx.shape[0]

    @property
    def nfo(self):
        return self.gidx.shape[1]


def _g_strides(G):
    """(task stride, component stride) of a (T, n1, n2) G whose last two
    axes flatten to the ERI component index."""
    st, s1, s2 = G.stride()
    if s1 != G.shape[2] * s2 and G.shape[1] > 1:
        raise ValueError("G: last two axes must flatten")
    return st, s2


def accum_tile_plain(G, tabs: StreamTables, dsrc, dstride, du, dv, rx, ry,
                     w, acc, e: int):
    """Plain PyTorch version of the kernel (same arguments)."""
    T = G.shape[0]
    if T == 0:
        return acc
    g = G.reshape(T, -1)[:, tabs.gidx.long()]  # (T, nfxy, nfo)
    base = du[1][du[0].long()].long() * dstride + dv[1][dv[0].long()].long()
    d = dsrc.reshape(-1)[base[:, None] + tabs.doff.long()[None, :]]
    v = (g * d[:, None, :]).sum(-1)
    scale = torch.full((T,), tabs.fac, dtype=torch.float64, device=G.device)
    if w is not None:
        scale = scale * w.double()
    x = v.double() * scale[:, None] * 2.0 ** (FRAC_BITS - e)
    limbs = split_limbs(x)
    rows = rx[1][rx[0].long()].long()[:, None] + tabs.roff.long()[None, :]
    cols = ry[1][ry[0].long()].long()[:, None] + tabs.coff.long()[None, :]
    ncols = acc.shape[1]
    flat = (rows * ncols + cols).reshape(-1)
    acc.view(-1, NLIMB).index_add_(0, flat, limbs.reshape(-1, NLIMB))
    return acc


def _declare(lib):
    lib.jqc_accum_tile_launch.restype = ctypes.c_int
    lib.jqc_accum_tile_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p * 17, ctypes.c_int * 4,
        ctypes.c_longlong * 4, ctypes.c_double, ctypes.c_void_p,
    ]
    lib.jqc_tile_accumulate_launch.restype = ctypes.c_int
    lib.jqc_tile_accumulate_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


def _check_i32(name, t, dev):
    if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
        raise ValueError(f"accum_tile_chunk: {name} must be contiguous int32 "
                         f"on {dev}")


def accum_tile_chunk(G, tabs: StreamTables, dsrc, dstride, du, dv, rx, ry,
                     w, acc, e: int):
    """CUDA kernel launch for one stream of one chunk.

    G: (T, n1, n2) tier dtype, task-major or component-major (the view
    ``eri_chunk`` returns); dsrc: density in G's dtype; du/dv/rx/ry:
    (per-task index int32 (T,), map int32) pairs; w: (T,) float32 or
    None; acc: (rows, ncols, 3) int64, updated in place.  Scratch: the
    contracted values, (nfxy, T) in G's dtype."""
    dev = G.device
    if dev.type != "cuda":
        raise ValueError("accum_tile_chunk needs CUDA tensors")
    if G.dtype not in (torch.float32, torch.float64) or dsrc.dtype != G.dtype:
        raise ValueError("accum_tile_chunk: G and dsrc need one float dtype")
    if G.dim() != 3 or tabs.gidx.numel() != G.shape[1] * G.shape[2]:
        raise ValueError("accum_tile_chunk: G must be (T, n1, n2) with "
                         "n1 * n2 = the stream's nfxy * nfo")
    if dsrc.device != dev or not dsrc.is_contiguous():
        raise ValueError("accum_tile_chunk: dsrc must be contiguous on G's device")
    if (acc.dtype != torch.int64 or acc.device != dev or acc.dim() != 3
            or acc.shape[2] != NLIMB or not acc.is_contiguous()):
        raise ValueError("accum_tile_chunk: acc must be contiguous (rows, "
                         "ncols, 3) int64")
    T = G.shape[0]
    for name, t in (("gidx", tabs.gidx), ("doff", tabs.doff),
                    ("roff", tabs.roff), ("coff", tabs.coff),
                    ("iu", du[0]), ("dmapu", du[1]), ("iv", dv[0]),
                    ("dmapv", dv[1]), ("ix", rx[0]), ("rmap", rx[1]),
                    ("iy", ry[0]), ("cmap", ry[1])):
        _check_i32(name, t, dev)
    for name, t in (("iu", du[0]), ("iv", dv[0]), ("ix", rx[0]),
                    ("iy", ry[0])):
        if t.shape[0] != T:
            raise ValueError(f"accum_tile_chunk: {name} has {t.shape[0]} "
                             f"rows, G has {T}")
    if w is not None and (w.dtype != torch.float32 or w.shape[0] != T
                          or w.device != dev or not w.is_contiguous()):
        raise ValueError("accum_tile_chunk: w must be (T,) float32")
    g_st, g_sf = _g_strides(G)
    if T == 0:
        return acc
    V = torch.empty((tabs.nfxy, T), dtype=G.dtype, device=dev)
    lib = cuda.load("accum_tile", _declare)
    ptrs = [G.data_ptr(), tabs.gidx.data_ptr(), dsrc.data_ptr(),
            du[0].data_ptr(), du[1].data_ptr(), dv[0].data_ptr(),
            dv[1].data_ptr(), tabs.doff.data_ptr(),
            None if w is None else w.data_ptr(),
            rx[0].data_ptr(), rx[1].data_ptr(), tabs.roff.data_ptr(),
            ry[0].data_ptr(), ry[1].data_ptr(), tabs.coff.data_ptr(),
            acc.data_ptr(), V.data_ptr()]
    rc = lib.jqc_accum_tile_launch(
        0 if G.dtype == torch.float32 else 1,
        (ctypes.c_void_p * 17)(*ptrs),
        (ctypes.c_int * 4)(tabs.nfxy, tabs.nfo, FRAC_BITS - e, T),
        (ctypes.c_longlong * 4)(g_st, g_sf, dstride, acc.shape[1]),
        float(tabs.fac), cuda.stream_handle(dev),
    )
    cuda.check(rc, "accum_tile_chunk")
    accum_tile_chunk.launches += 1
    return acc


accum_tile_chunk.launches = 0


def contract_tile(G, tabs, dsrc, dstride, du, dv, rx, ry, w, acc, e):
    """Dispatch: the kernel for CUDA tensors, the plain version on CPU."""
    if G.device.type == "cuda":
        return accum_tile_chunk(G, tabs, dsrc, dstride, du, dv, rx, ry, w,
                                acc, e)
    return accum_tile_plain(G, tabs, dsrc, dstride, du, dv, rx, ry, w, acc, e)


def fused_contract_tile(G, d, lx, ly, Wx: int, Wy: int, bound: float):
    """One stream's chunk, in the JAX function's terms: contract G
    (T, nfxy, nfo) with per-task density rows d (T, nfo) and accumulate
    into the dense (Wx, Wy, nfxy) supertile at within-tile shell indices
    lx, ly (T,) int32.  Returns ((Wx, Wy, nfxy, 3) int64 limb sums, e);
    ``tile_limbs_to_f64`` decodes them."""
    return _supertile(contract_tile, G, d, lx, ly, Wx, Wy, bound)


def _supertile(fn, G, d, lx, ly, Wx, Wy, bound, w=None):
    """``fused_contract_tile`` through ``fn`` (``contract_tile``, or
    ``accum_tile_plain`` or ``accum_tile_chunk`` to hold the kernel
    against on the card), with task weights ``w`` (T,) float32 or None."""
    T, nfxy, nfo = G.shape
    dev = G.device

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev).contiguous()

    ar_f = torch.arange(nfxy, device=dev)
    tabs = StreamTables(
        gidx=i32(torch.arange(nfxy * nfo, device=dev).view(nfxy, nfo)),
        doff=i32(torch.arange(nfo, device=dev)),
        roff=i32(torch.zeros(nfxy, device=dev)),
        coff=i32(ar_f),
    )
    tid = i32(torch.arange(T, device=dev))
    zero = i32(torch.zeros(T, device=dev))
    e = bound_exponent(bound)
    acc = torch.zeros((Wx, Wy * nfxy, NLIMB), dtype=torch.int64, device=dev)
    fn(
        G.contiguous(), tabs, d.contiguous(), nfo, (tid, tid),
        (zero, zero[:1].contiguous()),
        (i32(lx), i32(torch.arange(Wx, device=dev))),
        (i32(ly), i32(torch.arange(Wy, device=dev) * nfxy)),
        w, acc, e,
    )
    return acc.view(Wx, Wy, nfxy, NLIMB), e


def tile_limbs_to_f64(limbs, e: int):
    """Decoded float64 tile of ``fused_contract_tile`` or
    ``tile_accumulate``."""
    return limbs_to_f64(limbs, e)


# ------------------------------------------- accumulation alone (kernel C)
def tile_accumulate_plain(values, ix, iy, acc, e: int):
    """Plain PyTorch version of the kernel (same arguments)."""
    Wx, Wy, nf, _ = acc.shape
    x, y = ix.long(), iy.long()
    keep = (x >= 0) & (x < Wx) & (y >= 0) & (y < Wy)
    acc.view(Wx * Wy, nf, NLIMB).index_add_(
        0, (x * Wy + y)[keep], value_limbs(values[keep], e))
    return acc


def tile_accumulate_chunk(values, ix, iy, acc, e: int):
    """CUDA kernel launch: acc[ix[t], iy[t], f] += limbs(values[t, f]).
    values (T, nf) float32 or float64, ix/iy (T,) int32 (tasks outside
    the tile are dropped), acc (Wx, Wy, nf, 3) int64, updated in place."""
    check_values("tile_accumulate_chunk", values, (ix, iy), acc,
                 tuple(acc.shape[:2]), e)
    T, nf = values.shape
    if T == 0 or nf == 0:
        return acc
    lib = cuda.load("accum_tile", _declare)
    rc = lib.jqc_tile_accumulate_launch(
        0 if values.dtype == torch.float32 else 1, values.data_ptr(),
        ix.data_ptr(), iy.data_ptr(), acc.data_ptr(), T, nf, acc.shape[0],
        acc.shape[1], FRAC_BITS - e, cuda.stream_handle(values.device),
    )
    cuda.check(rc, "tile_accumulate_chunk")
    tile_accumulate_chunk.launches += 1
    return acc


tile_accumulate_chunk.launches = 0


def tile_accumulate(values, ix, iy, Wx: int, Wy: int, bound: float):
    """One stream's chunk contributions -> dense (Wx, Wy, nf) limb tile.

    values (T, nf) float32 or float64; ix/iy (T,) int32 within-supertile
    shell indices in [0, Wx) / [0, Wy); ``bound``: static bound on
    |values|.  Returns ((Wx, Wy, nf, 3) int64 limb sums, e);
    ``tile_limbs_to_f64`` decodes them, and tiles made at one bound add as
    integers.  Dispatch: the kernel for CUDA tensors, the plain version
    on the CPU."""
    e = bound_exponent(bound)
    acc = torch.zeros((Wx, Wy, values.shape[1], NLIMB), dtype=torch.int64,
                      device=values.device)
    if values.device.type == "cuda":
        tile_accumulate_chunk(values.contiguous(), ix.contiguous(),
                              iy.contiguous(), acc, e)
    else:
        tile_accumulate_plain(values, ix, iy, acc, e)
    return acc, e


__all__ = ["fused_contract_tile", "tile_limbs_to_f64", "contract_tile",
           "accum_tile_chunk", "accum_tile_plain", "tile_accumulate",
           "tile_accumulate_chunk", "tile_accumulate_plain", "limbs_to_f64",
           "StreamTables", "bound_exponent"]
