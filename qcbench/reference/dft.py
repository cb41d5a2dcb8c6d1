"""The Kohn-Sham exchange-correlation part in plain PyTorch float64: the
molecular grid, AO values and gradients, rho and sigma, B3LYP's energy
density with its potentials by autograd, E_xc and V_xc.

The grid and the functional are those the configuration states: the
program's default grid (radial Gauss-Chebyshev with Becke's map, 75/80/50
radial points for first-row/second-row/H atoms, 302-point Lebedev rules
pruned in four radial tiers, Becke partition with Bragg radii, points of
weight 1e-16 or less dropped) and B3LYP in libxc's convention (0.08
Slater + 0.72 B88 exchange, 0.19 VWN-RPA + 0.81 LYP correlation, 0.20 HF
exchange).  Their formulas are frozen copies of the program's
``dft/grids.py``, ``dft/radii.py`` and ``dft/xc.py``; the Becke weights
are evaluated here on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .basis import BOHR, cart_components

# Bragg-Slater radii in Angstrom by atomic number, H..Ar
_BRAGG_ANG = [0.0, 0.35, 1.40, 1.45, 1.05, 0.85, 0.70, 0.65, 0.60, 0.50,
              1.50, 1.80, 1.50, 1.25, 1.10, 1.00, 1.00, 1.00, 1.88]
B3LYP_HYB = 0.20
POINTS_BLOCK = 16384
# distances by differences, not by the matrix-product identity
EXACT = "donot_use_mm_for_euclid_dist"


def _n_rad(z):
    return 50 if z <= 2 else 75 if z <= 10 else 80 if z <= 18 else 90


def _lebedev(degree_at_least_points=None, degree=None):
    from scipy.integrate import lebedev_rule

    table = []
    for deg in range(3, 132, 2):
        try:
            x, _ = lebedev_rule(deg)
        except Exception:
            continue
        table.append((deg, x.shape[1]))
    if degree is None:
        degree = next(d for d, n in table if n >= degree_at_least_points)
    else:
        degree = max(d for d, _ in table if d <= degree)
    x, w = lebedev_rule(degree)
    return np.ascontiguousarray(x.T), w.copy(), degree


def _radial(n, R):
    i = np.arange(1, n + 1)
    theta = i * np.pi / (n + 1)
    x = np.cos(theta)
    w = (np.pi / (n + 1)) * np.sin(theta)
    r = R * (1 + x) / (1 - x)
    return r[::-1], (w * 2.0 * R / (1 - x) ** 2)[::-1]


def grid(mol, device, n_ang=302):
    """(points (N, 3), weights (N,)) float64 on ``device``."""
    dev = torch.device(device)
    zs = mol.charges.astype(int)
    radii = np.array([_BRAGG_ANG[z] for z in zs]) / BOHR
    tiers = ((0.25, 2), (0.5, 1.5), (4.5, 1), (np.inf, 1.5))
    s_full, w_full, full_deg = _lebedev(n_ang)
    ang = {1: (s_full, w_full)}
    for _, div in tiers:
        if div not in ang:
            ang[div] = _lebedev(degree=max(3, int(full_deg / div)))[:2]
    pts, ws, owner = [], [], []
    for ia in range(len(zs)):
        R = radii[ia] * (0.5 if zs[ia] > 1 else 1.0)
        r, wr = _radial(_n_rad(zs[ia]), R)
        edges = np.array([e for e, _ in tiers]) * radii[ia]
        region = np.minimum(np.searchsorted(edges, r, side="right"),
                            len(tiers) - 1)
        for t, (_, div) in enumerate(tiers):
            sel = region == t
            if not sel.any():
                continue
            s, wa = ang[div]
            pts.append((mol.coords[ia][None, None, :] + r[sel][:, None, None]
                        * s[None, :, :]).reshape(-1, 3))
            ws.append(((r[sel] ** 2 * wr[sel])[:, None] * wa[None, :])
                      .reshape(-1))
            owner.append(np.full(sel.sum() * len(wa), ia))
    f64 = dict(dtype=torch.float64, device=dev)
    P = torch.as_tensor(np.concatenate(pts), **f64)
    W = torch.as_tensor(np.concatenate(ws), **f64)
    own = torch.as_tensor(np.concatenate(owner), device=dev)
    W = W * becke(torch.as_tensor(mol.coords, **f64),
                  torch.as_tensor(radii, **f64), P, own)
    keep = W.abs() > 1e-16
    return P[keep], W[keep]


def becke(atoms, radii, points, owner):
    """Becke's partition weight of each point's own atom (size-adjusted,
    three smoothing steps)."""
    n = len(atoms)
    if n == 1:
        return torch.ones(len(points), dtype=points.dtype,
                          device=points.device)
    chi = radii[:, None] / radii[None, :]
    u = (chi - 1.0) / (chi + 1.0)
    a = torch.clamp(u / (u * u - 1.0), -0.5, 0.5)
    a.fill_diagonal_(0.0)
    rab = torch.cdist(atoms, atoms, compute_mode=EXACT)
    rab.fill_diagonal_(1.0)
    out = torch.empty(len(points), dtype=points.dtype, device=points.device)
    for s in range(0, len(points), POINTS_BLOCK):
        p = points[s:s + POINTS_BLOCK]
        d = torch.cdist(p, atoms, compute_mode=EXACT)        # (G, n)
        mu = (d[:, :, None] - d[:, None, :]) / rab           # (G, n, n)
        nu = mu + a * (1.0 - mu * mu)
        for _ in range(3):
            nu = 1.5 * nu - 0.5 * nu ** 3
        cell = 0.5 * (1.0 - nu)
        eye = torch.eye(n, dtype=torch.bool, device=p.device)
        cell = torch.where(eye, torch.ones_like(cell), cell)
        Pw = cell.prod(-1)                                   # (G, n)
        o = owner[s:s + POINTS_BLOCK]
        out[s:s + POINTS_BLOCK] = (Pw.gather(1, o[:, None])[:, 0]
                                   / torch.clamp(Pw.sum(1), min=1e-300))
    return out


def ao_values(mol, points):
    """(4, G, nao_cart): AO values and their x, y, z derivatives."""
    G = len(points)
    out = torch.zeros((4, G, mol.nao_cart), dtype=points.dtype,
                      device=points.device)
    for i, sh in enumerate(mol.shells):
        c = torch.as_tensor(sh.coord, dtype=points.dtype,
                            device=points.device)
        e = torch.as_tensor(sh.exps, dtype=points.dtype, device=points.device)
        k = torch.as_tensor(sh.coeffs, dtype=points.dtype,
                            device=points.device)
        rel = points - c
        r2 = (rel * rel).sum(1)
        ex = torch.exp(-r2[:, None] * e[None, :])
        rad = ex @ k
        drad = ex @ (-2.0 * e * k)
        o = mol.ao_cart[i]
        for f, lxyz in enumerate(cart_components(sh.l)):
            mono = torch.ones_like(r2)
            for d in range(3):
                mono = mono * rel[:, d] ** lxyz[d]
            out[0, :, o + f] = rad * mono
            for d in range(3):
                g = drad * rel[:, d] * mono
                if lxyz[d]:
                    low = list(lxyz)
                    low[d] -= 1
                    m2 = torch.ones_like(r2)
                    for dd in range(3):
                        m2 = m2 * rel[:, dd] ** low[dd]
                    g = g + rad * lxyz[d] * m2
                out[1 + d, :, o + f] = g
    return out


# ---------------------------------------------------------------- B3LYP
_CX = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)
_CX_SPIN = 0.75 * (6.0 / np.pi) ** (1.0 / 3.0)
_CF = 0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)


def _slater(rho):
    return -_CX * rho ** (4.0 / 3.0)


def _b88(rho, sigma):
    rs, ss = rho / 2.0, sigma / 4.0
    beta = 0.0042
    r43 = rs ** (4.0 / 3.0)
    x = torch.sqrt(ss) / r43
    return 2.0 * (-_CX_SPIN * r43 - beta * r43 * x * x
                  / (1.0 + 6.0 * beta * x * torch.asinh(x)))


def _vwn_rpa(rho):
    A, b, c, x0 = 0.0310907, 13.0720, 42.7198, -0.409286
    x = torch.sqrt((3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0))
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = np.sqrt(4.0 * c - b * b)
    atn = torch.atan(Q / (2.0 * x + b))
    return rho * A * (torch.log(x * x / X) + (2.0 * b / Q) * atn
                      - (b * x0 / X0) * (torch.log((x - x0) ** 2 / X)
                                         + (2.0 * (b + 2.0 * x0) / Q) * atn))


def _lyp(rho, sigma):
    ra = rb = rho / 2.0
    saa = sab = sbb = sigma / 4.0
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    r13 = rho ** (-1.0 / 3.0)
    denom = 1.0 + d * r13
    omega = torch.exp(-c * r13) * rho ** (-11.0 / 3.0) / denom
    delta = c * r13 + d * r13 / denom
    sig = saa + 2.0 * sab + sbb
    G = ra * rb * (
        2.0 ** (11.0 / 3.0) * _CF * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
        + (47.0 / 18.0 - 7.0 * delta / 18.0) * sig
        - (2.5 - delta / 18.0) * (saa + sbb)
        - ((delta - 11.0) / 9.0) * ((ra / rho) * saa + (rb / rho) * sbb)
    ) - (2.0 / 3.0) * rho ** 2 * sig + ((2.0 / 3.0) * rho ** 2 - ra ** 2) \
        * sbb + ((2.0 / 3.0) * rho ** 2 - rb ** 2) * saa
    return -4.0 * a * ra * rb / (rho * denom) - a * b * omega * G


def b3lyp(rho, sigma):
    """(e per volume, vrho, vsigma); zero where rho <= 1e-14."""
    r = rho.detach().requires_grad_(True)
    s = sigma.detach().requires_grad_(True)
    with torch.enable_grad():
        rf = torch.clamp(r, min=1e-14)
        sf = torch.clamp(s, min=1e-28)
        e = (0.08 * _slater(rf) + 0.72 * _b88(rf, sf)
             + 0.19 * _vwn_rpa(rf) + 0.81 * _lyp(rf, sf))
        vr, vs = torch.autograd.grad(e.sum(), (r, s))
    dead = rho <= 1e-14
    return tuple(torch.where(dead, 0.0, x) for x in (e.detach(), vr, vs))


def exc_vxc(mol, dm_sph, device, pts=None, wts=None):
    """(E_xc of the semilocal part, V_xc in the spherical basis, electrons
    on the grid)."""
    dev = torch.device(device)
    if pts is None:
        pts, wts = grid(mol, dev)
    P = torch.as_tensor(mol.P, dtype=torch.float64, device=dev)
    D = P @ torch.as_tensor(dm_sph, dtype=torch.float64, device=dev) @ P.T
    n = mol.nao_cart
    V = torch.zeros((n, n), dtype=torch.float64, device=dev)
    exc = torch.zeros((), dtype=torch.float64, device=dev)
    nel = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, len(pts), POINTS_BLOCK):
        ao = ao_values(mol, pts[s:s + POINTS_BLOCK])
        w = wts[s:s + POINTS_BLOCK]
        t = ao[0] @ D                                        # (G, n)
        rho = (t * ao[0]).sum(1)
        grad = 2.0 * torch.einsum("gn,dgn->dg", t, ao[1:])   # (3, G)
        sigma = (grad * grad).sum(0)
        e, vr, vs = b3lyp(rho, sigma)
        exc = exc + (w * e).sum()
        nel = nel + (w * rho).sum()
        # V_mn = sum_g w [vr phi_m phi_n + 2 vs grad rho . grad(phi_m phi_n)]
        f = (w * vr)[:, None] * ao[0] * 0.5 \
            + 2.0 * (w * vs)[:, None] * torch.einsum("dg,dgn->gn", grad, ao[1:])
        half = ao[0].T @ f
        V += half + half.T
    Vs = P.T @ V @ P
    return float(exc), Vs.cpu().numpy(), float(nel)
