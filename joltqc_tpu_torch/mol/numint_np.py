"""Numpy float64 oracle for grid integration (test reference).

Copy of ``joltqc_tpu/mol/numint_np.py``: the float64 oracle of the
port's tests and of ``chip_smoke.py``.

Mirrors dft/numint.py in plain f64 numpy; used by the test suite the way
the reference uses PySCF's ``ni.eval_rho``/``eval_ao`` as oracle
(JoltQC jqc/pyscf/tests/test_rks.py:37-56).
"""

from __future__ import annotations

import numpy as np

from ..mol.layout import BasisLayout
from ..ops.harmonics import cart_components


def eval_ao_np(layout: BasisLayout, points, deriv: int = 0):
    """AO values (and gradients) in internal cartesian order, f64.

    Returns (npts, nao) or tuple (ao, dx, dy, dz)."""
    mol = layout.mol
    G = len(points)
    nao = layout.nao_int
    ao = np.zeros((G, nao))
    grads = [np.zeros((G, nao)) for _ in range(3)] if deriv else []
    for i, sh in enumerate(mol.shells):
        col = layout.ao_loc_int[i]
        rel = points - sh.coord[None, :]
        r2 = (rel**2).sum(1)
        ex = np.exp(-sh.exps[None, :] * r2[:, None])
        rad = (sh.coeffs[None, :] * ex).sum(1)
        drad = (-2.0 * sh.exps[None, :] * sh.coeffs[None, :] * ex).sum(1)
        for k, (lx, ly, lz) in enumerate(cart_components(sh.l)):
            mono = rel[:, 0] ** lx * rel[:, 1] ** ly * rel[:, 2] ** lz
            ao[:, col + k] = rad * mono
            if deriv:
                for d, n in enumerate((lx, ly, lz)):
                    g = drad * rel[:, d] * mono
                    if n > 0:
                        pw = [lx, ly, lz]
                        pw[d] -= 1
                        g = g + rad * n * (
                            rel[:, 0] ** pw[0] * rel[:, 1] ** pw[1] * rel[:, 2] ** pw[2]
                        )
                    grads[d][:, col + k] = g
    if deriv:
        return (ao, *grads)
    return ao


def _fam(family):
    if isinstance(family, bool):  # back-compat: gga flag
        return "gga" if family else "lda"
    return family


def eval_rho_np(layout: BasisLayout, points, dm_int, family):
    """rho rows (1 | 4 | 5, npts) in f64; family: 'lda'|'gga'|'mgga'."""
    family = _fam(family)
    if family != "lda":
        ao, dx, dy, dz = eval_ao_np(layout, points, deriv=1)
    else:
        ao = eval_ao_np(layout, points)
    t = ao @ dm_int
    rho0 = (t * ao).sum(1)
    if family == "lda":
        return rho0[None, :]
    rows = [rho0] + [2.0 * (t * d).sum(1) for d in (dx, dy, dz)]
    if family == "mgga":
        tau = sum(((d @ dm_int) * d).sum(1) for d in (dx, dy, dz))
        rows.append(0.5 * tau)
    return np.stack(rows)


def eval_vxc_np(layout: BasisLayout, points, wv, family):
    """V_xc matrix (internal basis) in f64 from potential rows wv."""
    family = _fam(family)
    if family != "lda":
        ao, dx, dy, dz = eval_ao_np(layout, points, deriv=1)
    else:
        ao = eval_ao_np(layout, points)
    mid = ao * (0.5 * wv[0])[:, None]
    if family != "lda":
        for d, dao in enumerate((dx, dy, dz)):
            mid = mid + dao * wv[1 + d][:, None]
    half = ao.T @ mid
    if family == "mgga":
        for dao in (dx, dy, dz):
            half = half + dao.T @ (dao * (0.25 * wv[4])[:, None])
    return half + half.T


__all__ = ["eval_ao_np", "eval_rho_np", "eval_vxc_np"]
