"""Numpy f64 oracle for ECP integrals (test reference).

Copy of ``joltqc_tpu/mol/ecp_np.py``: the port's own float64 host
oracle, which ``chip_smoke.py`` holds the engine on the card against.
Implements the Bessel-expansion semi-local ECP integrals
(McMurchie-Davidson-style angular reduction) in plain numpy with
per-primitive-pair adaptive radial quadrature -- the correctness anchor
for scf/ecp.py, playing the role PySCF's ``mol.intor('ECPscalar')``
plays for the reference (JoltQC jqc/pyscf/tests/test_ecp.py:108-190).

Math (channel data d, zeta, n with U(r) = sum d r^(n-2) e^(-zeta r^2)):

type2 (semi-local channel l, ECP at C, shells at A and B; D = A - C):
  <i|P_l|j> = sum_m int r^2 U_l(r) P_i[m](r) P_j[m](r) dr
  P_i[m](r) = 4 pi sum_{p<=cart_i} B_p (-D)^(cart_i - p) r^|p|
              sum_lam i~_lam(2 a r |D|) e^(-a (r-|D|)^2)
              sum_mu Y_lam,mu(D^) T[p, lam mu, l m]
  T[p, uv, lm] = int_{S^2} w^p Y_uv Y_lm dOmega   (exact, host table)

type1 (local channel): double binomial expansion, k = 2(a D_i + b D_j):
  <i|U_L|j> = sum_{ab} c_a c_b sum_{pi,pj} B (-Di)^.. (-Dj)^..
     sum_lam (2 lam+1) [4pi/(2lam+1) sum_mu Y_lam,mu(k^) S[pi+pj, lam mu]]
     int r^(2+s) U_L(r) e^(-(a+b) r^2 + k r - a Di^2 - b Dj^2) i~_lam(kr) dr
  S[q, uv] = int w^q Y_uv dOmega
"""

from __future__ import annotations

from functools import lru_cache
from math import comb

import numpy as np

from ..ops.bessel import ine_np
from ..ops.harmonics import (
    _sphere_monomial_integral,
    cart_components,
    real_sph_ortho,
)
from .ecp import ECPChannel, ECPData


# ------------------------------------------------------------ angular tables
def eval_Y(l: int, u: np.ndarray) -> np.ndarray:
    """Orthonormal real Y_lm at unit vectors u (..., 3) -> (2l+1, ...)."""
    coef = real_sph_ortho(l)
    comps = cart_components(l)
    monos = np.stack(
        [u[..., 0] ** a * u[..., 1] ** b * u[..., 2] ** c for (a, b, c) in comps]
    )
    return np.tensordot(coef, monos, axes=1)


@lru_cache(maxsize=None)
def mono_Y_integral(q: tuple, lam: int) -> np.ndarray:
    """S[mu] = int w^q Y_lam,mu dOmega (exact)."""
    coef = real_sph_ortho(lam)
    comps = cart_components(lam)
    out = np.zeros(2 * lam + 1)
    for m in range(2 * lam + 1):
        for c, (a, b, cc) in zip(coef[m], comps):
            if c != 0.0:
                out[m] += c * _sphere_monomial_integral(
                    q[0] + a, q[1] + b, q[2] + cc
                )
    return out


@lru_cache(maxsize=None)
def mono_YY_integral(q: tuple, lam: int, l: int) -> np.ndarray:
    """T[mu, m] = int w^q Y_lam,mu Y_lm dOmega (exact)."""
    ca, compa = real_sph_ortho(lam), cart_components(lam)
    cb, compb = real_sph_ortho(l), cart_components(l)
    out = np.zeros((2 * lam + 1, 2 * l + 1))
    for mu in range(2 * lam + 1):
        for m in range(2 * l + 1):
            v = 0.0
            for c1, (a1, b1, c1z) in zip(ca[mu], compa):
                if c1 == 0.0:
                    continue
                for c2, (a2, b2, c2z) in zip(cb[m], compb):
                    if c2 == 0.0:
                        continue
                    v += c1 * c2 * _sphere_monomial_integral(
                        q[0] + a1 + a2, q[1] + b1 + b2, q[2] + c1z + c2z
                    )
            out[mu, m] = v
    return out


def _binom_terms(lx, ly, lz, D):
    """[(p, coef)] for (r w - D)^(lx,ly,lz) expansion; coef includes (-D)^rest."""
    out = []
    for px in range(lx + 1):
        for py in range(ly + 1):
            for pz in range(lz + 1):
                c = (
                    comb(lx, px) * comb(ly, py) * comb(lz, pz)
                    * (-D[0]) ** (lx - px)
                    * (-D[1]) ** (ly - py)
                    * (-D[2]) ** (lz - pz)
                )
                if c != 0.0:
                    out.append(((px, py, pz), c))
    return out


def _radial_grid(p, kmag, zeta_min, npts=256):
    """Gauss-Legendre nodes on the support of e^{-p r^2 + k r} U(r)."""
    ptot = p + max(zeta_min, 0.0)
    r_star = kmag / (2.0 * ptot) if ptot > 0 else 1.0
    sigma = 1.0 / np.sqrt(2.0 * ptot)
    lo = max(0.0, r_star - 12.0 * sigma)
    hi = r_star + 12.0 * sigma
    x, w = np.polynomial.legendre.leggauss(npts)
    r = 0.5 * (hi - lo) * (x + 1.0) + lo
    return r, w * 0.5 * (hi - lo)


def _u_channel(ch: ECPChannel, r):
    u = np.zeros_like(r)
    for n, z, d in zip(ch.powers, ch.exps, ch.coefs):
        u += d * r ** (n - 2.0) * np.exp(-z * r * r)
    return u


def _safe_unit(D):
    n = np.linalg.norm(D)
    if n < 1e-12:
        return np.array([0.0, 0.0, 1.0]), 0.0
    return D / n, n


def type1_cart_np(shA, shB, C, ch: ECPChannel) -> np.ndarray:
    """<cart_i | U_L(r_C) | cart_j> matrix (nfa, nfb), f64."""
    la, lb = shA.l, shB.l
    compsa, compsb = cart_components(la), cart_components(lb)
    Di = shA.coord - C
    Dj = shB.coord - C
    zeta_min = float(ch.exps.min())
    out = np.zeros((len(compsa), len(compsb)))
    for a, caa in zip(shA.exps, shA.coeffs):
        for b, cbb in zip(shB.exps, shB.coeffs):
            kvec = 2.0 * (a * Di + b * Dj)
            khat, kmag = _safe_unit(kvec)
            p = a + b
            r, w = _radial_grid(p, kmag, zeta_min)
            expo = -p * r * r + kmag * r - a * Di @ Di - b * Dj @ Dj
            base = np.exp(expo) * _u_channel(ch, r) * r * r
            lam_max = la + lb
            ines = ine_np(lam_max, kmag * r)  # (lam, K)
            Yk = [eval_Y(lam, khat) for lam in range(lam_max + 1)]
            for fi, (ax, ay, az) in enumerate(compsa):
                ti = _binom_terms(ax, ay, az, Di)
                for fj, (bx, by, bz) in enumerate(compsb):
                    tj = _binom_terms(bx, by, bz, Dj)
                    val = 0.0
                    for (pi, ci) in ti:
                        for (pj, cj) in tj:
                            q = (pi[0] + pj[0], pi[1] + pj[1], pi[2] + pj[2])
                            s = sum(q)
                            rad_s = base * r**s
                            for lam in range(lam_max + 1):
                                S = mono_Y_integral(q, lam)
                                # (2lam+1) i_lam P_lam expansion x addition
                                # theorem leaves a net 4 pi factor
                                ang = 4.0 * np.pi * float(S @ Yk[lam])
                                if ang == 0.0:
                                    continue
                                val += ci * cj * ang * float(
                                    np.sum(w * rad_s * ines[lam])
                                )
                    out[fi, fj] += caa * cbb * val
    return out


def _proj_coeffs(sh, C, l):
    """Angular projection data for <lm| shell>: returns per-prim closures."""
    Dhat, Dmag = _safe_unit(sh.coord - C)
    lam_max = l + sh.l
    Y_D = [eval_Y(lam, Dhat) for lam in range(lam_max + 1)]
    comps = cart_components(sh.l)
    terms = []  # per cart comp: [(s, lam, ang_vec(m), coef)]
    for (ax, ay, az) in comps:
        rows = []
        for (p, c) in _binom_terms(ax, ay, az, sh.coord - C):
            s = sum(p)
            for lam in range(lam_max + 1):
                T = mono_YY_integral(p, lam, l)  # (mu, m)
                ang = Y_D[lam] @ T  # (m,)
                if np.abs(ang).max() > 1e-16:
                    rows.append((s, lam, 4.0 * np.pi * c * ang))
        terms.append(rows)
    return terms, Dmag, lam_max


def type2_cart_np(shA, shB, C, ch: ECPChannel) -> np.ndarray:
    """<cart_i |lm>(U_l)<lm| cart_j> summed over m: (nfa, nfb), f64."""
    l = ch.l
    terms_i, Dmag_i, lmax_i = _proj_coeffs(shA, C, l)
    terms_j, Dmag_j, lmax_j = _proj_coeffs(shB, C, l)
    zeta_min = float(ch.exps.min())
    nfa, nfb = len(terms_i), len(terms_j)
    out = np.zeros((nfa, nfb))
    for a, caa in zip(shA.exps, shA.coeffs):
        for b, cbb in zip(shB.exps, shB.coeffs):
            p = a + b
            kmag = 2.0 * (a * Dmag_i + b * Dmag_j)
            r, w = _radial_grid(p, kmag, zeta_min)
            base = (
                np.exp(
                    -a * (r - Dmag_i) ** 2
                    - b * (r - Dmag_j) ** 2
                )
                * _u_channel(ch, r)
                * r
                * r
            )
            ines_i = ine_np(lmax_i, 2.0 * a * Dmag_i * r)
            ines_j = ine_np(lmax_j, 2.0 * b * Dmag_j * r)
            for fi, rows_i in enumerate(terms_i):
                for fj, rows_j in enumerate(terms_j):
                    val = 0.0
                    for (si, lami, angi) in rows_i:
                        for (sj, lamj, angj) in rows_j:
                            am = float(angi @ angj)
                            if am == 0.0:
                                continue
                            rad = float(
                                np.sum(
                                    w
                                    * base
                                    * r ** (si + sj)
                                    * ines_i[lami]
                                    * ines_j[lamj]
                                )
                            )
                            val += am * rad
                    out[fi, fj] += caa * cbb * val
    return out


def ecp_matrix_np(mol, layout) -> np.ndarray:
    """Full ECP matrix in the internal cartesian AO basis, f64."""
    nao = layout.nao_int
    V = np.zeros((nao, nao))
    if not getattr(mol, "ecp", None):
        return V
    shells = mol.shells
    al = layout.ao_loc_int
    for ia in range(mol.natm):
        sym = mol.atom_symbols[ia]
        data: ECPData | None = mol.ecp.get(sym)
        if data is None:
            continue
        C = mol.coords[ia]
        loc = data.local()
        for i, shi in enumerate(shells):
            for j, shj in enumerate(shells):
                if j > i:
                    continue
                blk = np.zeros((al[i + 1] - al[i], al[j + 1] - al[j]))
                if loc is not None:
                    blk += type1_cart_np(shi, shj, C, loc)
                for ch in data.channels:
                    if ch.l >= 0:
                        blk += type2_cart_np(shi, shj, C, ch)
                V[al[i]:al[i + 1], al[j]:al[j + 1]] += blk
                if i != j:
                    V[al[j]:al[j + 1], al[i]:al[i + 1]] += blk.T
    return V


__all__ = [
    "type1_cart_np",
    "type2_cart_np",
    "ecp_matrix_np",
    "eval_Y",
    "mono_Y_integral",
    "mono_YY_integral",
]
