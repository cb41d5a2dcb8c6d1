"""Exact, order-independent scatter and block accumulation.

Port of ``joltqc_tpu/ops/accum.py`` (``scatter_limbs``, ``limbs_to_df64``,
``scatter_add_det``, ``scatter_add_det_2d``, ``block_accumulate``) and of
the Pallas kernel ``joltqc_tpu/ops/accum_pallas.py::
block_accumulate_pallas``.

The contract is the reference's: contributions are converted to fixed
point against a STATIC bound (a host bound 2^e >= |value|; for
``scatter_limbs`` alone a data-dependent max when no bound is given) and
summed as integers, so the result is exact and bit-identical for any
order of the contributions, any split into calls and any device
partition; indices at or beyond the size are dropped.  The means are this
package's own: a value scaled by 2^(120 - e) is split into three 40-bit
int64 limbs of its sign (each step exact in float64) and the limbs are
added as 64-bit integers; ``limbs_to_f64`` decodes once.  Limb sums made
at one exponent add as integers, so stages can be chained without
decoding in between.

 - ``scatter_limbs`` is XLA in the reference and plain PyTorch here (an
   int64 ``index_add_``, which is an integer atomic on the card and hence
   order-independent too);
 - ``block_accumulate`` is the segment sum of the J/K engine's
   ``accum='block'`` mode: CUDA tensors launch the hand-written kernel
   (csrc/accum_block.cu) through ``accum_block_chunk``, CPU tensors run
   ``block_accumulate_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda

NLIMB = 3
LIMB_BITS = 40
FRAC_BITS = NLIMB * LIMB_BITS


def bound_exponent(bound: float) -> int:
    """e with bound < 2^e (frexp exponent; zero guarded as in JAX)."""
    return math.frexp(max(float(bound), 1e-30))[1]


def split_limbs(x: torch.Tensor) -> torch.Tensor:
    """float64 x (already scaled by 2^(120-e)) -> (..., 3) int64 limbs
    of x's sign with |x| = l0 2^80 + l1 2^40 + l2 (each step exact)."""
    ax = x.abs()
    l0 = torch.trunc(ax * 2.0 ** -80)
    r1 = ax - l0 * 2.0 ** 80
    l1 = torch.trunc(r1 * 2.0 ** -40)
    l2 = torch.round(r1 - l1 * 2.0 ** 40)
    sg = torch.where(x < 0, -1, 1).to(torch.int64)
    return torch.stack([l0, l1, l2], -1).to(torch.int64) * sg[..., None]


def value_limbs(values: torch.Tensor, e: int) -> torch.Tensor:
    """(..., 3) int64 limbs of float values at exponent e."""
    return split_limbs(values.double() * 2.0 ** (FRAC_BITS - e))


def limbs_to_f64(acc: torch.Tensor, e: int) -> torch.Tensor:
    """Decode (..., 3) int64 limb sums at exponent e to float64: exact
    carry normalisation, then one rounding per term."""
    s0, s1, s2 = acc.unbind(-1)
    c = s2 >> LIMB_BITS
    s2 = s2 - (c << LIMB_BITS)
    s1 = s1 + c
    c = s1 >> LIMB_BITS
    s1 = s1 - (c << LIMB_BITS)
    s0 = s0 + c
    v = s0.double() * 2.0 ** 80 + s1.double() * 2.0 ** 40
    return (v + s2.double()) * 2.0 ** (e - FRAC_BITS)


# ---------------------------------------------------------------- scatter
def add_limbs_(acc: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
               e: int) -> torch.Tensor:
    """acc[idx[n]] += limbs(values[n]) in place.  acc: (size + 1, 3) int64
    whose last row is the spill row; idx: integer tensor with entries in
    [0, size], where size itself means "drop"."""
    acc.index_add_(0, idx.reshape(-1).long(),
                   value_limbs(values.reshape(-1), e))
    return acc


def scatter_limbs(values, idx, size: int, bound=None):
    """Scatter contributions into fixed-point limb sums.

    values (N,) float32 or float64, idx (N,) integers; rows with
    ``idx == size`` are dropped.  ``bound``: static bound on |values|;
    None takes the data's max (then the scale depends on the data, as the
    reference's ``x_abs_max=None``).  Returns ((size, 3) int64 limb sums,
    e)."""
    if bound is None:
        bound = float(values.abs().max()) if values.numel() else 0.0
    e = bound_exponent(bound)
    acc = torch.zeros((size + 1, NLIMB), dtype=torch.int64,
                      device=values.device)
    return add_limbs_(acc, values, idx, e)[:size], e


def scatter_add_det(values, idx, size: int) -> torch.Tensor:
    """Deterministic scatter-add out[idx[n]] += values[n] -> (size,)
    float64; contributions with idx == size are dropped."""
    limbs, e = scatter_limbs(values, idx, size)
    return limbs_to_f64(limbs, e)


def scatter_add_det_2d(values, idx, shape) -> torch.Tensor:
    """Scatter into a 2D (n, m) float64 output with flat indices."""
    n, m = shape
    return scatter_add_det(values, idx, n * m).view(n, m)


# ------------------------------------------------------------------ block
def block_accumulate_plain(values, rowkey, acc, e: int):
    """Plain PyTorch version of the kernel (same arguments)."""
    nrows = acc.shape[0]
    key = rowkey.long()
    keep = (key >= 0) & (key < nrows)
    acc.index_add_(0, key[keep], value_limbs(values[keep], e))
    return acc


def _declare(lib):
    lib.jqc_accum_block_launch.restype = ctypes.c_int
    lib.jqc_accum_block_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]


def check_values(what, values, keys, acc, tail, e):
    """Argument checks shared by the accumulation launchers: values
    (T, nf) float32/float64, keys (T,) int32 each, acc (*tail, nf, 3)
    int64, all contiguous on one CUDA device; e the limb exponent."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors")
    if (values.dim() != 2 or not values.is_contiguous()
            or values.dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"{what}: values must be contiguous (T, nf) "
                         "float32 or float64")
    T, nf = values.shape
    for k in keys:
        if (k.dtype != torch.int32 or k.device != dev or k.shape != (T,)
                or not k.is_contiguous()):
            raise ValueError(f"{what}: keys must be contiguous (T,) int32 "
                             f"on {dev}")
    if (acc.dtype != torch.int64 or acc.device != dev
            or not acc.is_contiguous()
            or tuple(acc.shape) != (*tail, nf, NLIMB)):
        raise ValueError(f"{what}: acc must be contiguous "
                         f"{(*tail, nf, NLIMB)} int64 on {dev}")
    if not -900 < FRAC_BITS - e < 900:
        raise ValueError(f"{what}: exponent {e} out of range")


def accum_block_chunk(values, rowkey, acc, e: int):
    """CUDA kernel launch: acc[rowkey[t], f] += limbs(values[t, f]) for
    0 <= rowkey[t] < nrows.  values (T, nf) float32 or float64, rowkey
    (T,) int32, acc (nrows, nf, 3) int64, updated in place."""
    check_values("accum_block_chunk", values, (rowkey,), acc,
                 (acc.shape[0],), e)
    T, nf = values.shape
    if T == 0 or nf == 0 or acc.shape[0] == 0:
        return acc
    lib = cuda.load("accum_block", _declare)
    rc = lib.jqc_accum_block_launch(
        0 if values.dtype == torch.float32 else 1, values.data_ptr(),
        rowkey.data_ptr(), acc.data_ptr(), T, nf, acc.shape[0],
        FRAC_BITS - e, cuda.stream_handle(values.device),
    )
    cuda.check(rc, "accum_block_chunk")
    accum_block_chunk.launches += 1
    return acc


accum_block_chunk.launches = 0


def block_accumulate(values, rowkey, nrows: int, bound, e: int | None = None):
    """Exact segment accumulation out[r] = sum_{t: rowkey[t] == r}
    values[t]: values (T, nf) float32 or float64, rowkey (T,) int32 in
    [0, nrows) (anything else is dropped).  ``bound``: static bound on
    |values|; ``e`` overrides its exponent so that several calls share
    one scale and their limbs add as integers.  Returns ((nrows, nf, 3)
    int64 limb sums, e).  Dispatch: the kernel for CUDA tensors, the
    plain version on the CPU."""
    if e is None:
        e = bound_exponent(bound)
    acc = torch.zeros((nrows, values.shape[1], NLIMB), dtype=torch.int64,
                      device=values.device)
    if values.device.type == "cuda":
        accum_block_chunk(values.contiguous(), rowkey.contiguous(), acc, e)
    else:
        block_accumulate_plain(values, rowkey, acc, e)
    return acc, e


__all__ = [
    "scatter_add_det", "scatter_add_det_2d", "scatter_limbs", "limbs_to_f64",
    "block_accumulate", "block_accumulate_plain", "accum_block_chunk",
    "add_limbs_", "split_limbs", "value_limbs", "bound_exponent",
]
