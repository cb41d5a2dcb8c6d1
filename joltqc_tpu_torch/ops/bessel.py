"""Scaled modified spherical Bessel functions for ECP integrals.

Port of ``joltqc_tpu/ops/bessel.py`` (``ine_df64``) to float64 tensors.
i~_l(x) = exp(-x) * i_l(x), the exponentially-scaled modified spherical
Bessel function of the first kind -- the radial kernel of ECP integrals
(reference counterpart: ``_ine`` in JoltQC jqc/backend/ecp/bessel.cu).

The JAX package's two regimes, evaluated for all orders at once as an
(lmax+1, ...) tensor:
 - x <= 40: the term recurrence t_0 = 1, t_k = t_{k-1} x^2 / (2k (2l+2k+1))
   summed over k = 0..130, i_l = x^l / (2l+1)!! * sum_k t_k, times e^-x.
   The recurrence is a cumulative product along the term axis, taken in
   blocks of ``_KBLOCK`` terms so that its memory stays bounded;
 - x > 40: the exact closed form
       i~_l(x) = 1/(2x) [ sum_k (-)^k c_k (2x)^-k
                          + (-)^{l+1} e^{-2x} sum_k c_k (2x)^-k ],
   c_k = (l+k)!/(k! (l-k)!), as Horner sums in 1/(2x).
Each branch sees a clamped argument (x <= 40 for the series, x >= 40 for
the closed form), so the branch that ``torch.where`` drops stays finite.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial

import numpy as np
import torch

_X_SWITCH = 40.0
_NSERIES = 130  # series terms: peak index ~ x, converged at x=40 by k~120
_KBLOCK = 26  # terms per cumulative-product block (130 = 5 blocks)


def _dfact(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


@lru_cache(maxsize=None)
def _series_denoms(lmax: int) -> np.ndarray:
    """(NSERIES, lmax+1) recurrence denominators 2k (2l+2k+1), k = 1.."""
    k = np.arange(1, _NSERIES + 1, dtype=np.float64)[:, None]
    l = np.arange(lmax + 1, dtype=np.float64)[None, :]
    return 2.0 * k * (2.0 * l + 2.0 * k + 1.0)


@lru_cache(maxsize=None)
def _asym_table(lmax: int) -> tuple:
    """Horner coefficients, highest k first: (p rows, q rows), each
    (lmax+1, lmax+1) with row k' = lmax - k holding (-1)^k c_k and c_k
    per order (zero where k > l), and the signs (-1)^(l+1)."""
    p = np.zeros((lmax + 1, lmax + 1))
    q = np.zeros((lmax + 1, lmax + 1))
    for l in range(lmax + 1):
        for k in range(l + 1):
            c = factorial(l + k) / (factorial(k) * factorial(l - k))
            p[lmax - k, l] = c * (-1) ** k
            q[lmax - k, l] = c
    sign = np.array([-1.0 if l % 2 == 0 else 1.0 for l in range(lmax + 1)])
    return p, q, sign


def _col(vals: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(n,) host values -> (n, 1, ..., 1) tensor broadcasting against x."""
    t = torch.as_tensor(vals, dtype=x.dtype, device=x.device)
    return t.reshape((-1,) + (1,) * x.dim())


def ine(lmax: int, x: torch.Tensor) -> torch.Tensor:
    """(lmax+1, *x.shape) tensor of i~_0(x) .. i~_lmax(x); x >= 0, float64."""
    nl = lmax + 1
    # --- series branch on xs = min(x, 40) ---
    xs = torch.where(x <= _X_SWITCH, x, torch.full_like(x, _X_SWITCH))
    x2 = xs * xs
    emx = torch.exp(-xs)
    den = torch.as_tensor(_series_denoms(lmax), dtype=x.dtype,
                          device=x.device).reshape((_NSERIES, nl) + (1,) * x.dim())
    t = torch.ones((1, nl) + x.shape, dtype=x.dtype, device=x.device)
    s = t[0].clone()
    for k0 in range(0, _NSERIES, _KBLOCK):
        terms = t[-1:] * torch.cumprod(x2 / den[k0:k0 + _KBLOCK], dim=0)
        s = s + terms.sum(0)
        t = terms
    inv_df = np.array([1.0 / _dfact(2 * l + 1) for l in range(nl)])
    series = (s * emx) * _col(inv_df, x)
    if lmax > 0:
        xpow = torch.cumprod(xs.expand((lmax,) + x.shape), dim=0)
        series = torch.cat([series[:1], series[1:] * xpow])
    # --- closed form on xl = max(x, 40) ---
    xl = torch.where(x > _X_SWITCH, x, torch.full_like(x, _X_SWITCH))
    inv_2x = (1.0 / xl) * 0.5
    em2x = torch.exp(xl * -2.0)
    pc, qc, sign = _asym_table(lmax)
    p = torch.zeros((nl,) + x.shape, dtype=x.dtype, device=x.device)
    q = torch.zeros_like(p)
    for k in range(nl):
        p = torch.addcmul(_col(pc[k], x), p, inv_2x)
        q = torch.addcmul(_col(qc[k], x), q, inv_2x)
    asym = (p + (em2x * q) * _col(sign, x)) * inv_2x
    return torch.where(x <= _X_SWITCH, series, asym)


def ine_np(lmax: int, x: np.ndarray):
    """f64 numpy oracle: i~_l = sqrt(pi/2x) * ive(l+1/2, x) (overflow-safe).

    Copy of ``joltqc_tpu/ops/bessel.py::ine_np``."""
    from scipy.special import ive

    x = np.asarray(x, np.float64)
    xs = np.maximum(x, 1e-300)
    pref = np.sqrt(np.pi / (2.0 * xs))
    out = np.stack([pref * ive(l + 0.5, xs) for l in range(lmax + 1)])
    # exact x = 0 limit: i_l(0) = delta_{l0}
    out[:, x == 0] = 0.0
    out[0, x == 0] = 1.0
    return out


__all__ = ["ine", "ine_np"]
