"""Reference integrals in numpy float64 (McMurchie-Davidson recurrences).

This module is the framework's *oracle*: slow, clear, host-side float64
implementations of overlap / kinetic / nuclear-attraction / ERI used to
(a) validate every kernel (the role CPU PySCF plays for the reference
tests, e.g. JoltQC jqc/pyscf/tests/test_jk.py comparing against
``pyscf.scf.hf.get_jk``), and (b) provide cheap O(N^2) one-electron
matrices for the host-side SCF loop on small systems.
"""

from __future__ import annotations

import numpy as np
from scipy import special

from ..ops.harmonics import cart_components, cart_norm_factors, cart_to_sph_factors
from .molecule import Molecule


# ------------------------------------------------------------------ Boys
def boys_np(mmax: int, x: np.ndarray) -> np.ndarray:
    """F_m(x) for m=0..mmax, stacked on axis 0 (float64, scipy oracle)."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    out = np.empty((mmax + 1,) + x.shape)
    tiny = x < 1e-14
    xs = np.where(tiny, 1.0, x)
    for m in range(mmax + 1):
        a = m + 0.5
        val = special.gamma(a) * special.gammainc(a, xs) / (2 * xs**a)
        out[m] = np.where(tiny, 1.0 / (2 * m + 1), val)
    return out


# ------------------------------------------------- Hermite E coefficients
def e_coeffs(li: int, lj: int, a: float, b: float, ab: float) -> np.ndarray:
    """E[i, j, t] Hermite expansion coefficients for one dimension.

    ab = A - B (component).  Includes the gaussian prefactor
    exp(-mu*ab^2) in E[0,0,0].
    """
    p = a + b
    mu = a * b / p
    xpa = -b * ab / p  # P - A
    xpb = a * ab / p  # P - B
    ntmax = li + lj + 1
    E = np.zeros((li + 1, lj + 1, ntmax + 1))  # one spare t slot for recurrence
    E[0, 0, 0] = np.exp(-mu * ab * ab)
    inv2p = 1.0 / (2 * p)
    for i in range(li):
        for t in range(i + 2):
            E[i + 1, 0, t] = (
                (inv2p * E[i, 0, t - 1] if t > 0 else 0.0)
                + xpa * E[i, 0, t]
                + (t + 1) * E[i, 0, t + 1]
            )
    for j in range(lj):
        for i in range(li + 1):
            for t in range(i + j + 2):
                E[i, j + 1, t] = (
                    (inv2p * E[i, j, t - 1] if t > 0 else 0.0)
                    + xpb * E[i, j, t]
                    + (t + 1) * E[i, j, t + 1]
                )
    return E[:, :, : li + lj + 1]


# ------------------------------------------------- Hermite R integrals
def hermite_r(tmax: int, umax: int, vmax: int, p: float, pq: np.ndarray) -> np.ndarray:
    """R[t,u,v] = R^0_{tuv}(p, PQ): Hermite Coulomb integrals."""
    nmax = tmax + umax + vmax
    fb = boys_np(nmax, np.array([p * (pq @ pq)]))[:, 0]
    rn = np.zeros((nmax + 1, tmax + 1, umax + 1, vmax + 1))
    for n in range(nmax + 1):
        rn[n, 0, 0, 0] = (-2.0 * p) ** n * fb[n]
    # build up t, u, v; R^n_{t+1,u,v} = t R^{n+1}_{t-1,u,v} + X R^{n+1}_{t,u,v}
    for t in range(tmax):
        for n in range(nmax - t):
            rn[n, t + 1, 0, 0] = (
                (t * rn[n + 1, t - 1, 0, 0] if t > 0 else 0.0)
                + pq[0] * rn[n + 1, t, 0, 0]
            )
    for u in range(umax):
        for t in range(tmax + 1):
            for n in range(nmax - t - u):
                rn[n, t, u + 1, 0] = (
                    (u * rn[n + 1, t, u - 1, 0] if u > 0 else 0.0)
                    + pq[1] * rn[n + 1, t, u, 0]
                )
    for v in range(vmax):
        for u in range(umax + 1):
            for t in range(tmax + 1):
                for n in range(nmax - t - u - v):
                    rn[n, t, u, v + 1] = (
                        (v * rn[n + 1, t, u, v - 1] if v > 0 else 0.0)
                        + pq[2] * rn[n + 1, t, u, v]
                    )
    return rn[0]


# ----------------------------------------------------------- shell pairs
def _pair_e3d(sh_i, sh_j):
    """Yield (ci*cj, p, P, Ex, Ey, Ez) for each primitive pair."""
    A, B = sh_i.coord, sh_j.coord
    for ai, ci in zip(sh_i.exps, sh_i.coeffs):
        for aj, cj in zip(sh_j.exps, sh_j.coeffs):
            p = ai + aj
            P = (ai * A + aj * B) / p
            ex = e_coeffs(sh_i.l, sh_j.l, ai, aj, A[0] - B[0])
            ey = e_coeffs(sh_i.l, sh_j.l, ai, aj, A[1] - B[1])
            ez = e_coeffs(sh_i.l, sh_j.l, ai, aj, A[2] - B[2])
            yield ci * cj, ai, aj, p, P, ex, ey, ez


def _block_transform(mol: Molecule, block: np.ndarray, ls: tuple[int, ...]):
    """Transform a cartesian shell block to the mol's AO convention on
    every axis (sph: solid-harmonic matrices; cart: per-component norms)."""
    out = block
    for ax, l in enumerate(ls):
        if mol.cart:
            w = 1.0 / cart_norm_factors(l)
            out = np.moveaxis(np.moveaxis(out, ax, -1) * w, -1, ax)
        else:
            c = cart_to_sph_factors(l)
            out = np.tensordot(out, c.T, axes=([ax], [0]))
            out = np.moveaxis(out, -1, ax)
    return out


# ------------------------------------------------------------- integrals
def overlap(mol: Molecule) -> np.ndarray:
    return _one_electron(mol, kind="ovlp")


def kinetic(mol: Molecule) -> np.ndarray:
    return _one_electron(mol, kind="kin")


def nuclear(mol: Molecule) -> np.ndarray:
    return _one_electron(mol, kind="nuc")


def _one_electron(mol: Molecule, kind: str) -> np.ndarray:
    nao = mol.nao
    ao_loc = mol.ao_loc
    out = np.zeros((nao, nao))
    zs = mol.atom_charges_eff  # ECP atoms: Z - ncore
    for isab, sh_i in enumerate(mol.shells):
        ci_comps = cart_components(sh_i.l)
        for jsab, sh_j in enumerate(mol.shells):
            if jsab > isab:
                continue
            cj_comps = cart_components(sh_j.l)
            blk = np.zeros((len(ci_comps), len(cj_comps)))
            li, lj = sh_i.l, sh_j.l
            # for kinetic we need E with lj+2
            for cc, ai, aj, p, P, ex, ey, ez in _pair_e3d_ext(
                sh_i, sh_j, extra_j=(2 if kind == "kin" else 0)
            ):
                sq = np.sqrt(np.pi / p)
                if kind == "nuc":
                    # V = (2*pi/p) * sum_tuv E R_tuv summed over nuclei
                    rsum = np.zeros((li + lj + 1,) * 3)
                    for C, z in zip(mol.coords, zs):
                        rsum += z * hermite_r(li + lj, li + lj, li + lj, p, P - C)
                for ii, (ix, iy, iz) in enumerate(ci_comps):
                    for jj, (jx, jy, jz) in enumerate(cj_comps):
                        if kind == "ovlp":
                            blk[ii, jj] += (
                                cc
                                * ex[ix, jx, 0]
                                * ey[iy, jy, 0]
                                * ez[iz, jz, 0]
                                * sq**3
                            )
                        elif kind == "kin":
                            sx = ex[:, :, 0] * sq
                            sy = ey[:, :, 0] * sq
                            sz = ez[:, :, 0] * sq
                            tx = _t1d(sx, ix, jx, aj)
                            ty = _t1d(sy, iy, jy, aj)
                            tz = _t1d(sz, iz, jz, aj)
                            blk[ii, jj] += cc * (
                                tx * sy[iy, jy] * sz[iz, jz]
                                + sx[ix, jx] * ty * sz[iz, jz]
                                + sx[ix, jx] * sy[iy, jy] * tz
                            )
                        else:  # nuc
                            acc = 0.0
                            for t in range(ix + jx + 1):
                                for u in range(iy + jy + 1):
                                    for v in range(iz + jz + 1):
                                        acc += (
                                            ex[ix, jx, t]
                                            * ey[iy, jy, u]
                                            * ez[iz, jz, v]
                                            * rsum[t, u, v]
                                        )
                            blk[ii, jj] += cc * (2 * np.pi / p) * acc
            if kind == "nuc":
                blk = -blk
            blk = _block_transform(mol, blk, (li, lj))
            i0, i1 = ao_loc[isab], ao_loc[isab + 1]
            j0, j1 = ao_loc[jsab], ao_loc[jsab + 1]
            out[i0:i1, j0:j1] = blk
            if isab != jsab:
                out[j0:j1, i0:i1] = blk.T
    return out


def _t1d(s: np.ndarray, i: int, j: int, b: float) -> float:
    """1D kinetic-energy integral from 1D overlaps (derivative on ket)."""
    t = -2.0 * b * b * s[i, j + 2] + b * (2 * j + 1) * s[i, j]
    if j >= 2:
        t -= 0.5 * j * (j - 1) * s[i, j - 2]
    return t


def _pair_e3d_ext(sh_i, sh_j, extra_j=0):
    A, B = sh_i.coord, sh_j.coord
    for ai, ci in zip(sh_i.exps, sh_i.coeffs):
        for aj, cj in zip(sh_j.exps, sh_j.coeffs):
            p = ai + aj
            P = (ai * A + aj * B) / p
            ex = e_coeffs(sh_i.l, sh_j.l + extra_j, ai, aj, A[0] - B[0])
            ey = e_coeffs(sh_i.l, sh_j.l + extra_j, ai, aj, A[1] - B[1])
            ez = e_coeffs(sh_i.l, sh_j.l + extra_j, ai, aj, A[2] - B[2])
            yield ci * cj, ai, aj, p, P, ex, ey, ez


def eri(mol: Molecule, omega: float = 0.0) -> np.ndarray:
    """Full (nao,nao,nao,nao) ERI tensor in chemists' notation (ij|kl).

    O(N^4) python loops -- oracle for small systems only.  ``omega`` > 0
    gives the long-range erf(omega r)/r kernel (range separation).
    """
    nao = mol.nao
    ao_loc = mol.ao_loc
    out = np.zeros((nao, nao, nao, nao))
    nsh = len(mol.shells)
    for isab in range(nsh):
        for jsab in range(isab + 1):
            for ksab in range(nsh):
                for lsab in range(ksab + 1):
                    if (isab, jsab) < (ksab, lsab):
                        continue
                    blk = _eri_shell_quartet(
                        mol.shells[isab],
                        mol.shells[jsab],
                        mol.shells[ksab],
                        mol.shells[lsab],
                        omega,
                    )
                    blk = _block_transform(
                        mol,
                        blk,
                        (
                            mol.shells[isab].l,
                            mol.shells[jsab].l,
                            mol.shells[ksab].l,
                            mol.shells[lsab].l,
                        ),
                    )
                    i0, i1 = ao_loc[isab], ao_loc[isab + 1]
                    j0, j1 = ao_loc[jsab], ao_loc[jsab + 1]
                    k0, k1 = ao_loc[ksab], ao_loc[ksab + 1]
                    l0, l1 = ao_loc[lsab], ao_loc[lsab + 1]
                    out[i0:i1, j0:j1, k0:k1, l0:l1] = blk
                    out[j0:j1, i0:i1, k0:k1, l0:l1] = blk.transpose(1, 0, 2, 3)
                    out[i0:i1, j0:j1, l0:l1, k0:k1] = blk.transpose(0, 1, 3, 2)
                    out[j0:j1, i0:i1, l0:l1, k0:k1] = blk.transpose(1, 0, 3, 2)
                    out[k0:k1, l0:l1, i0:i1, j0:j1] = blk.transpose(2, 3, 0, 1)
                    out[l0:l1, k0:k1, i0:i1, j0:j1] = blk.transpose(3, 2, 0, 1)
                    out[k0:k1, l0:l1, j0:j1, i0:i1] = blk.transpose(2, 3, 1, 0)
                    out[l0:l1, k0:k1, j0:j1, i0:i1] = blk.transpose(3, 2, 1, 0)
    return out


def _eri_shell_quartet(sa, sb, sc, sd, omega: float = 0.0) -> np.ndarray:
    la, lb, lc, ld = sa.l, sb.l, sc.l, sd.l
    lab, lcd = la + lb, lc + ld
    na, nb = len(cart_components(la)), len(cart_components(lb))
    nc, nd = len(cart_components(lc)), len(cart_components(ld))
    out = np.zeros((na, nb, nc, nd))
    comps_a, comps_b = cart_components(la), cart_components(lb)
    comps_c, comps_d = cart_components(lc), cart_components(ld)
    for cc1, ai, aj, p, P, exab, eyab, ezab in _pair_e3d_ext(sa, sb):
        for cc2, ak, al, q, Q, excd, eycd, ezcd in _pair_e3d_ext(sc, sd):
            theta = p * q / (p + q)
            pref = 2 * np.pi**2.5 / (p * q * np.sqrt(p + q))
            if omega > 0.0:
                # long-range attenuation: theta' = theta*w^2/(theta+w^2),
                # prefactor scaled by sqrt(theta'/theta)
                w2 = omega * omega
                theta_lr = theta * w2 / (theta + w2)
                pref *= np.sqrt(theta_lr / theta)
                theta = theta_lr
            # R with the scaled exponent argument
            R = _hermite_r_scaled(lab, lcd, theta, P - Q)
            # contract: [ab|cd] = pref * sum_tuv E^ab_tuv sum_TUV (-1)^{T+U+V} E^cd R_{t+T,...}
            for ia_, (ix, iy, iz) in enumerate(comps_a):
                for jb_, (jx, jy, jz) in enumerate(comps_b):
                    for kc_, (kx, ky, kz) in enumerate(comps_c):
                        for ld_, (lx, ly, lz) in enumerate(comps_d):
                            acc = 0.0
                            for t in range(ix + jx + 1):
                                ext = exab[ix, jx, t]
                                if ext == 0.0:
                                    continue
                                for u in range(iy + jy + 1):
                                    eyu = eyab[iy, jy, u]
                                    if eyu == 0.0:
                                        continue
                                    for v in range(iz + jz + 1):
                                        ezv = ezab[iz, jz, v]
                                        if ezv == 0.0:
                                            continue
                                        acc2 = 0.0
                                        for T in range(kx + lx + 1):
                                            exT = excd[kx, lx, T]
                                            if exT == 0.0:
                                                continue
                                            for U in range(ky + ly + 1):
                                                eyU = eycd[ky, ly, U]
                                                if eyU == 0.0:
                                                    continue
                                                for V in range(kz + lz + 1):
                                                    ezV = ezcd[kz, lz, V]
                                                    if ezV == 0.0:
                                                        continue
                                                    sgn = (
                                                        -1.0
                                                        if (T + U + V) % 2
                                                        else 1.0
                                                    )
                                                    acc2 += (
                                                        sgn
                                                        * exT
                                                        * eyU
                                                        * ezV
                                                        * R[t + T, u + U, v + V]
                                                    )
                                        acc += ext * eyu * ezv * acc2
                            out[ia_, jb_, kc_, ld_] += cc1 * cc2 * pref * acc
    return out


def _hermite_r_scaled(lab: int, lcd: int, theta: float, pq: np.ndarray) -> np.ndarray:
    n = lab + lcd
    return hermite_r(n, n, n, theta, pq)[: n + 1, : n + 1, : n + 1]


__all__ = ["boys_np", "e_coeffs", "hermite_r", "overlap", "kinetic", "nuclear", "eri"]
