"""Molecular quadrature grids: radial x angular + Becke weights.

Copy of ``joltqc_tpu/dft/grids.py`` (host numpy and scipy): the grid is
bit-identical to the JAX package's.

Reference counterpart: jqc/pyscf/rks.py:100-177 (build_grids: PySCF atomic
grids + Becke partition + 1-Bohr box sort).  Differences from PySCF:

 - Angular grids are LEBEDEV rules (octahedral-symmetry quadrature,
   nodes generated by scipy.integrate.lebedev_rule -- no tables carried
   in this repo), defaulting to the standard (75, 302)-class atomic
   grids; a Gauss-Legendre(cos theta) x uniform(phi) product rule
   remains as the data-free fallback (pass ``n_theta=``), at ~1.5-2x
   the points for equal degree.
 - Radial grids are Gauss-Chebyshev (2nd kind) with the Becke rational
   map r = R (1+x)/(1-x).
 - Becke partition-of-unity weights with Bragg-radius size adjustment,
   k=3 smoothing, vectorized over all grid points at once (host numpy,
   one-time O(natm^2 * ngrid)).
 - Points are blocked/padded to a multiple of ``block`` (default 1024)
   and sorted into spatial boxes for locality, mirroring
   ``arg_group_grids`` (jqc/pyscf/rks.py:71-97).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..mol.molecule import Molecule
from ..utils.trace import span
from .radii import bragg_radius


@lru_cache(maxsize=1)
def _lebedev_degrees():
    """Sorted (degree, npts) pairs scipy can generate ((),) if none)."""
    try:
        from scipy.integrate import lebedev_rule
    except ImportError:  # pragma: no cover - old scipy
        return ()
    out = []
    for deg in range(3, 132, 2):
        try:
            x, _ = lebedev_rule(deg)
        except Exception:
            continue
        out.append((deg, x.shape[1]))
    return tuple(out)


@lru_cache(maxsize=None)
def lebedev_grid(n_ang: int):
    """Unit-sphere Lebedev nodes/weights with >= n_ang points.

    Picks the smallest standard Lebedev rule with at least ``n_ang``
    points (the PySCF convention for (n_rad, n_ang) atomic grid specs).
    Returns (points (N,3), weights (N,)), weights summing to 4*pi.
    """
    from scipy.integrate import lebedev_rule

    table = _lebedev_degrees()
    if not table:
        raise RuntimeError("scipy.integrate.lebedev_rule unavailable")
    deg = table[-1][0]
    for d, npts in table:
        if npts >= n_ang:
            deg = d
            break
    x, w = lebedev_rule(deg)
    return np.ascontiguousarray(x.T), w.copy()


@lru_cache(maxsize=None)
def _lebedev_by_degree(degree: int):
    """Lebedev rule rounded DOWN to the nearest available degree >= 3."""
    from scipy.integrate import lebedev_rule

    table = _lebedev_degrees()
    best = table[0][0]
    for d, _ in table:
        if d <= degree:
            best = d
    x, w = lebedev_rule(best)
    return np.ascontiguousarray(x.T), w.copy()


def gauss_chebyshev_becke(n: int, R: float):
    """Radial nodes/weights on (0, inf) for integrands ~ f(r) (dr measure).

    Gauss-Chebyshev 2nd kind on (-1,1) + Becke map r = R(1+x)/(1-x):
    returns (r, w) with  integral_0^inf f(r) dr ~= sum w_i f(r_i).
    """
    i = np.arange(1, n + 1)
    theta = i * np.pi / (n + 1)
    x = np.cos(theta)
    # GC2 rule for integral f(x) sqrt(1-x^2) dx; divide by the weight fn
    w_cheb = (np.pi / (n + 1)) * np.sin(theta)  # == w2 / sqrt(1-x^2)
    r = R * (1 + x) / (1 - x)
    drdx = 2.0 * R / (1 - x) ** 2
    return r[::-1], (w_cheb * drdx)[::-1]  # ascending r


def angular_product_grid(n_theta: int, n_phi: int | None = None):
    """Unit-sphere nodes/weights: GL in cos(theta) x uniform phi.

    Exact for spherical harmonics up to degree min(2*n_theta-1, n_phi-1).
    Returns (points (N,3), weights (N,)) with sum(weights) == 4*pi.
    """
    if n_phi is None:
        n_phi = 2 * n_theta
    ct, wt = np.polynomial.legendre.leggauss(n_theta)
    st = np.sqrt(1.0 - ct**2)
    phi = 2.0 * np.pi * (np.arange(n_phi) + 0.5) / n_phi
    wp = 2.0 * np.pi / n_phi
    x = (st[:, None] * np.cos(phi)[None, :]).ravel()
    y = (st[:, None] * np.sin(phi)[None, :]).ravel()
    z = np.broadcast_to(ct[:, None], (n_theta, n_phi)).ravel()
    w = np.broadcast_to((wt * wp)[:, None], (n_theta, n_phi)).ravel()
    return np.stack([x, y, z], axis=1), w.copy()


def _becke_step(mu, a):
    """Size-adjusted smoothing: nu = mu + a(1-mu^2), then k=3 Becke poly."""
    nu = mu + a * (1.0 - mu * mu)
    for _ in range(3):
        nu = 1.5 * nu - 0.5 * nu**3
    return 0.5 * (1.0 - nu)  # cell function s(mu)


def becke_weights(coords_atm, radii, points, atom_of_point):
    """Becke partition-of-unity weight of each point's parent atom."""
    natm = len(coords_atm)
    if natm == 1:
        return np.ones(len(points))
    # pairwise size-adjustment parameters a_ij (Becke 1988 appendix)
    chi = radii[:, None] / radii[None, :]
    u = (chi - 1.0) / (chi + 1.0)
    a = np.clip(u / (u * u - 1.0), -0.5, 0.5)
    np.fill_diagonal(a, 0.0)

    d_pa = np.linalg.norm(points[:, None, :] - coords_atm[None, :, :], axis=2)
    r_ab = np.linalg.norm(coords_atm[:, None, :] - coords_atm[None, :, :], axis=2)
    np.fill_diagonal(r_ab, 1.0)

    P = np.ones((len(points), natm))
    for i in range(natm):
        for j in range(natm):
            if i == j:
                continue
            mu = (d_pa[:, i] - d_pa[:, j]) / r_ab[i, j]
            P[:, i] *= _becke_step(mu, a[i, j])
    Psum = P.sum(axis=1)
    return P[np.arange(len(points)), atom_of_point] / np.maximum(Psum, 1e-300)


def _default_n_rad(z: int) -> int:
    """Per-element radial order (the PySCF level-3 convention shape)."""
    if z <= 2:
        return 50
    if z <= 10:
        return 75
    if z <= 18:
        return 80
    if z <= 36:
        return 90
    return 99


class Grids:
    """Molecular integration grid with Becke weights.

    Angular scheme: Lebedev rules by default (``n_ang`` target points;
    standard sizes 302/590/...; octahedral-symmetry nodes generated by
    scipy.integrate.lebedev_rule, no tables carried here).  Passing
    ``n_theta=`` selects the data-free GL(cos theta) x uniform(phi)
    product rule (kept for analytic degree control in tests; ~1.5-2x
    the points at equal degree).

    Attributes after build(): ``coords`` (N,3) Bohr, ``weights`` (N,),
    both padded to a multiple of ``block`` (pad weights are 0) and sorted
    into spatial boxes for AO-screening locality.  ``timing`` adds the
    host wall seconds of the spans build_s and becke_s (the Becke
    weights inside it; ``utils/trace.py``).
    """

    def __init__(
        self,
        mol: Molecule,
        n_rad: int | None = None,
        n_theta: int | None = None,
        n_phi: int | None = None,
        block: int = 1024,
        prune: bool = True,
        n_ang: int | None = None,
        angular: str | None = None,
    ):
        self.mol = mol
        self.n_rad = n_rad
        if angular is None:
            angular = (
                "product"
                if (n_theta is not None and n_ang is None)
                or not _lebedev_degrees()
                else "lebedev"
            )
        self.angular = angular
        self.n_ang = n_ang if n_ang is not None else 302
        self.n_theta = n_theta if n_theta is not None else 18
        self.n_phi = n_phi if n_phi is not None else 2 * self.n_theta
        self.block = block
        self.prune = prune
        self.coords = None
        self.weights = None
        self.timing: dict = {}

    def _angular_rule(self, div: int):
        """Angular nodes/weights for one prune tier (degree divisor)."""
        if self.angular == "lebedev":
            if div == 1:
                return lebedev_grid(self.n_ang)
            table = _lebedev_degrees()
            full_deg = next(d for d, npts in table if npts >= self.n_ang)
            return _lebedev_by_degree(max(3, int(full_deg / div)))
        nt = max(6, int(round(self.n_theta / div)))
        nph = (
            2 * nt
            if self.n_phi == 2 * self.n_theta
            else max(6, int(round(self.n_phi / div)))
        )
        return angular_product_grid(nt, nph)

    def build(self):
        with span(self.timing, "grids.build"):
            return self._build()

    def _build(self):
        mol = self.mol
        zs = mol.atom_charges
        radii = np.array([bragg_radius(z) for z in zs])

        pts_all, w_all, owner = [], [], []
        # tiered angular pruning (the product-grid analogue of PySCF's
        # nwchem_prune, data-free): the density is angularly smooth both
        # in the core (r << R_bragg, dominated by s-like cusp) and in the
        # far tail (r >> R_bragg), so those radial regions use reduced
        # GL x uniform orders.  Region edges in units of the Bragg
        # radius and n_theta fractions mirror the nwchem scheme
        # (reference gets this via PySCF grids, jqc/pyscf/rks.py:100-177).
        if not self.prune:
            tiers = ((np.inf, 1),)
        elif self.angular == "lebedev":
            # measured on the H2O density integral: the (3,2,1,2) product
            # divisors cost 2.5 digits through the TAIL tier on Lebedev
            # grids; (2,1.5,1,1.5) holds ~1e-7 at 0.57x the unpruned
            # points (vs 1.1e-5 for the aggressive scheme)
            tiers = ((0.25, 2), (0.5, 1.5), (4.5, 1), (np.inf, 1.5))
        else:
            tiers = ((0.25, 3), (0.5, 2), (4.5, 1), (np.inf, 2))
        ang = {}
        for _, div in tiers:
            if div not in ang:
                ang[div] = self._angular_rule(div)
        for ia in range(mol.natm):
            R = radii[ia] * (0.5 if zs[ia] > 1 else 1.0)
            n_rad = (
                self.n_rad if self.n_rad is not None
                else _default_n_rad(int(zs[ia]))
            )
            r, wr = gauss_chebyshev_becke(n_rad, R)
            edges = np.array([e for e, _ in tiers]) * radii[ia]
            region = np.searchsorted(edges, r, side="right")
            region = np.minimum(region, len(tiers) - 1)
            for t, (_, div) in enumerate(tiers):
                sel = region == t
                rsel = r[sel]
                if len(rsel) == 0:
                    continue
                s, wa = ang[div]
                p = (
                    mol.coords[ia][None, None, :]
                    + rsel[:, None, None] * s[None, :, :]
                ).reshape(-1, 3)
                w = (rsel**2 * wr[sel])[:, None] * wa[None, :]
                pts_all.append(p)
                w_all.append(w.reshape(-1))
                owner.append(np.full(len(p), ia, np.int32))

        points = np.concatenate(pts_all)
        w_quad = np.concatenate(w_all)
        owner = np.concatenate(owner)

        with span(self.timing, "grids.becke"):
            pw = becke_weights(mol.coords, radii, points, owner)
        weights = w_quad * pw

        # drop negligible points, sort into 2-Bohr boxes for locality
        keep = np.abs(weights) > 1e-16
        points, weights = points[keep], weights[keep]
        box = np.floor(points / 2.0).astype(np.int64)
        key = (box[:, 0] - box[:, 0].min()) * 1_000_000 + (
            box[:, 1] - box[:, 1].min()
        ) * 1_000 + (box[:, 2] - box[:, 2].min())
        order = np.argsort(key, kind="stable")
        points, weights = points[order], weights[order]

        # pad to a block multiple (zero weight)
        n = len(points)
        npad = (-n) % self.block
        if npad:
            points = np.concatenate([points, np.zeros((npad, 3))])
            weights = np.concatenate([weights, np.zeros(npad)])
        self.coords = points
        self.weights = weights
        self.size = n
        return self


__all__ = [
    "Grids",
    "gauss_chebyshev_becke",
    "angular_product_grid",
    "lebedev_grid",
    "becke_weights",
]
