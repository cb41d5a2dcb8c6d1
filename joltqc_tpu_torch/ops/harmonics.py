"""Real solid harmonics: cartesian <-> spherical transformation coefficients.

Replaces the reference's generated CUDA transform tables
(JoltQC jqc/backend/common/cart2sph.cu, sph2cart.cu): here the
transforms are dense per-l matrices applied with einsum/matmul (MXU), so
only the coefficient matrices are needed.

Conventions:
 - cartesian components of shell l are ordered lexicographically by
   (lx descending, then ly descending): e.g. d: xx,xy,xz,yy,yz,zz.
 - spherical components ordered m = -l..l (tesseral harmonics,
   sin branch for m<0, cos branch for m>0).
 - coefficients follow Schlegel & Frisch, IJQC 54, 83 (1995); validated
   in tests by harmonicity and unit-sphere orthonormality (both exact
   properties, independent of transcription).

``cart_to_sph_factors(l)`` gives C of shape (2l+1, nfcart) such that a
spherical GTO = sum_c C[m,c] * (cartesian monomial c) * radial, with the
normalization convention that a primitive gaussian normalized for the
(l,0,0) cartesian component yields unit-norm spherical functions.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb, factorial

import numpy as np


def cart_components(l: int):
    """Cartesian monomial exponents, ordered (lx desc, ly desc)."""
    return [
        (lx, ly, l - lx - ly)
        for lx in range(l, -1, -1)
        for ly in range(l - lx, -1, -1)
    ]


def double_factorial(n: int) -> int:
    if n <= 0:
        return 1
    out = 1
    while n > 0:
        out *= n
        n -= 2
    return out


@lru_cache(maxsize=None)
def _sph_coef_table(l: int) -> np.ndarray:
    """Unnormalized real-solid-harmonic coefficients c[m+l, cart_idx]."""
    comps = cart_components(l)
    idx = {c: i for i, c in enumerate(comps)}
    out = np.zeros((2 * l + 1, len(comps)))
    for m in range(-l, l + 1):
        ma = abs(m)
        # N_lm (Racah-style normalization of the solid harmonic)
        norm = (
            1.0
            / (2**ma * factorial(l))
            * np.sqrt(
                2.0 * factorial(l + ma) * factorial(l - ma)
                / (2.0 if m == 0 else 1.0)
            )
        )
        # overall per-m scale is re-fixed by unit-sphere normalization in
        # cart_to_sph_factors, so only relative coefficients/phases matter.
        # Derivation: r^l Y_lm = (x+iy)^ma * sum_j c1(j) z^{l-ma-2j} r^{2j},
        # from P_l^m via the Rodrigues expansion of P_l; r^{2j} expands as a
        # trinomial over (x^2, y^2, z^2).
        jmax = (l - ma) // 2
        for j in range(jmax + 1):
            c1 = (
                (-1) ** j
                * comb(l, j)
                * comb(2 * l - 2 * j, l)
                * factorial(l - 2 * j)
                // factorial(l - 2 * j - ma)
            )
            for k1 in range(j + 1):
                for k2 in range(j - k1 + 1):
                    k3 = j - k1 - k2
                    tri = factorial(j) // (
                        factorial(k1) * factorial(k2) * factorial(k3)
                    )
                    for t in range(ma + 1):
                        lx = 2 * k1 + ma - t
                        ly = 2 * k2 + t
                        lz = l - lx - ly
                        if lx < 0 or ly < 0 or lz < 0:
                            continue
                        # angular phase from the (x + i y)^ma expansion term t
                        if m >= 0:
                            if t % 2 != 0:  # cos branch: Re(i^t)
                                continue
                            ang = (-1) ** (t // 2)
                        else:
                            if t % 2 != 1:  # sin branch: Im(i^t)
                                continue
                            ang = (-1) ** ((t - 1) // 2)
                        out[m + l, idx[(lx, ly, lz)]] += (
                            norm * c1 * tri * comb(ma, t) * ang
                        )
    return out


def _sphere_monomial_integral(p: int, q: int, r: int) -> float:
    """∫_{S²} x^p y^q z^r dΩ (exact)."""
    if p % 2 or q % 2 or r % 2:
        return 0.0
    num = (
        double_factorial(p - 1) * double_factorial(q - 1) * double_factorial(r - 1)
    )
    return 4.0 * np.pi * num / double_factorial(p + q + r + 1)


@lru_cache(maxsize=None)
def sph_gram(l: int) -> np.ndarray:
    """Gram matrix of cartesian monomials of degree l on the unit sphere."""
    comps = cart_components(l)
    n = len(comps)
    g = np.zeros((n, n))
    for i, (a, b, c) in enumerate(comps):
        for j, (d, e, f) in enumerate(comps):
            g[i, j] = _sphere_monomial_integral(a + d, b + e, c + f)
    return g


@lru_cache(maxsize=None)
def cart_to_sph_factors(l: int) -> np.ndarray:
    """C[m, cart] mapping cartesian GTO components (normalized with the
    (l,0,0)-component convention) to unit-norm spherical GTOs."""
    raw = _sph_coef_table(l)
    g = sph_gram(l)
    # normalize each harmonic on the sphere against the metric of the
    # *monomials*, then rescale to the GTO normalization convention:
    # a radial-normalized GTO uses N(l,0,0) which makes <x^l|x^l> = 1, i.e.
    # monomial norm of x^l is 1/(sphere-norm factor). Concretely:
    # the (l,0,0) cartesian function has sphere integral I_l = ∫ x^{2l} dΩ;
    # unit-normalized harmonics must be scaled so that expressing them in
    # terms of *normalized* cartesian components keeps <sph|sph> = 1.
    out = np.zeros_like(raw)
    norm_x_l = np.sqrt(_sphere_monomial_integral(2 * l, 0, 0))
    for i in range(2 * l + 1):
        v = raw[i]
        s = np.sqrt(v @ g @ v)
        out[i] = v / s * norm_x_l
    return out


@lru_cache(maxsize=None)
def real_sph_ortho(l: int) -> np.ndarray:
    """Orthonormal real spherical harmonics as monomial coefficients.

    Returns Y[m, cart_idx] with Y_lm(w) = sum_c Y[m, c] * w^comps[c] for
    unit vectors w, satisfying the exact orthonormality
    ``integral_{S^2} Y_lm Y_lm' dOmega = delta`` (used by the ECP angular
    tables, ops/ecp_tables.py)."""
    raw = _sph_coef_table(l)
    g = sph_gram(l)
    out = np.zeros_like(raw)
    for i in range(2 * l + 1):
        v = raw[i]
        out[i] = v / np.sqrt(v @ g @ v)
    return out


@lru_cache(maxsize=None)
def cart_norm_factors(l: int) -> np.ndarray:
    """Per-cartesian-component self-norm relative to the (l,0,0) component.

    With the shell coefficient normalized for x^l, component (lx,ly,lz)
    has norm sqrt((2lx-1)!!(2ly-1)!!(2lz-1)!!/(2l-1)!!); dividing by this
    gives unit-norm cartesian AOs (our cart=True convention).
    """
    comps = cart_components(l)
    ref = double_factorial(2 * l - 1)
    return np.array(
        [
            np.sqrt(
                double_factorial(2 * a - 1)
                * double_factorial(2 * b - 1)
                * double_factorial(2 * c - 1)
                / ref
            )
            for (a, b, c) in comps
        ]
    )


__all__ = [
    "cart_components",
    "cart_to_sph_factors",
    "cart_norm_factors",
    "sph_gram",
    "double_factorial",
]
