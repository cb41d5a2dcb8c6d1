"""Boys function F_m(x) = int_0^1 t^{2m} exp(-x t^2) dt on torch tensors.

Port of ``joltqc_tpu/ops/boys.py``.  The fp64 tier runs the algorithm of
``boys_df64`` in native float64 and the f32 tier the algorithm of
``boys_f32`` in float32; the CUDA ERI kernel (csrc/eri.cu) evaluates the
same two algorithms per thread.

 - x <= switch: Kummer series at m_max,
      F_m(x) = e^{-x} * sum_{i>=0} (2x)^i / ((2m+1)(2m+3)...(2m+2i+1)),
   then stable downward recursion F_{m-1} = (2x F_m + e^{-x}) / (2m-1).
 - x > switch: F_0(x) = sqrt(pi/(4x)) erf(sqrt x) and upward recursion
   F_{m+1} = ((2m+1) F_m - e^{-x}) / (2x), keeping the e^{-x} term.
   fp64: switch max(12, 2 mmax + 5), erf exact (the JAX DF64 tier's
   erfc continued fraction is what native erf replaces);
   f32: switch max(10, 2 mmax + 3), erfc by its 4-term asymptotic series.
"""

from __future__ import annotations

import math

import torch

_SQRT_PI_OVER_2 = math.sqrt(math.pi) / 2.0


def switch_point(mmax: int, dtype: torch.dtype) -> float:
    if dtype == torch.float64:
        return max(12.0, 2.0 * mmax + 5.0)
    return max(10.0, 2.0 * mmax + 3.0)


def nseries(mmax: int, dtype: torch.dtype) -> int:
    """Series length: truncation below the tier's precision at the switch."""
    return int(2 * switch_point(mmax, dtype)) + 30


def boys(mmax: int, x: torch.Tensor) -> torch.Tensor:
    """Stacked F[m, ...] for m = 0..mmax in x's dtype (float32 or float64).

    ``x`` may have any shape and must be >= 0."""
    dt = x.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"boys: unsupported dtype {dt}")
    switch = switch_point(mmax, dt)

    # --- series branch at m = mmax, then downward ---
    xs = torch.clamp(x, max=switch)
    emx = torch.exp(-xs)
    two_x = 2.0 * xs
    t = torch.full_like(x, 1.0 / (2 * mmax + 1))
    s = t.clone()
    for i in range(nseries(mmax, dt)):
        t = t * two_x / float(2 * mmax + 3 + 2 * i)
        s = s + t
    fs_small = [None] * (mmax + 1)
    fs_small[mmax] = emx * s
    for m in range(mmax, 0, -1):
        fs_small[m - 1] = (two_x * fs_small[m] + emx) / float(2 * m - 1)

    # --- large branch: F_0 from erf, upward with e^{-x} ---
    xl = torch.clamp(x, min=switch)
    emx_l = torch.exp(-xl)
    inv_sqrt_xl = torch.rsqrt(xl)
    if dt == torch.float64:
        erf_l = torch.erf(torch.sqrt(xl))
    else:
        u = 0.5 / xl
        poly = 1.0 + u * (-1.0 + u * (3.0 - 15.0 * u))
        erf_l = 1.0 - emx_l * inv_sqrt_xl * (1.0 / math.sqrt(math.pi)) * poly
    f = _SQRT_PI_OVER_2 * inv_sqrt_xl * erf_l
    inv_2x = 0.5 / xl
    fs_large = [f]
    for m in range(mmax):
        f = ((2 * m + 1) * f - emx_l) * inv_2x
        fs_large.append(f)

    use_small = x <= switch
    return torch.stack(
        [torch.where(use_small, a, b) for a, b in zip(fs_small, fs_large)]
    )


__all__ = ["boys", "switch_point", "nseries"]
