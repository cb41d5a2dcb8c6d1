"""Contracted cartesian ERI blocks by McMurchie-Davidson, plain PyTorch.

A frozen copy of the McMurchie-Davidson chain of the port's plain ERI
version (``joltqc_tpu_torch/ops/md.py``, and ``ops/boys.py`` for the Boys
function), kept here so that the benchmark's yardstick does not move when
the program changes.  Nothing of the program is imported.  The reference
runs it in float64.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .basis import cart_components

# ------------------------------------------------------------ Boys

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


# elements of the largest intermediates of one primitive-quartet slice
SLICE_ELEMS = 1 << 26


# ------------------------------------------------------------ index sets
@lru_cache(maxsize=None)
def tri_set(L: int):
    """All (t,u,v) with t+u+v <= L, deterministic order, + index map."""
    keys = [
        (t, u, v)
        for s in range(L + 1)
        for t in range(s + 1)
        for u in range(s - t + 1)
        for v in [s - t - u]
    ]
    return keys, {k: i for i, k in enumerate(keys)}


@lru_cache(maxsize=None)
def r_recurrence_tables(L: int):
    """Gather tables driving one downward level of the R recurrence.

    For each (t,u,v) != (0,0,0): pick the first nonzero axis d; then
      R^n_{tuv} = PQ[d] * R^{n+1}[idx1] + fac * R^{n+1}[idx2]."""
    keys, pos = tri_set(L)
    nr = len(keys)
    axis = np.zeros(nr, np.int64)
    idx1 = np.zeros(nr, np.int64)
    idx2 = np.zeros(nr, np.int64)
    fac = np.zeros(nr)
    for i, key in enumerate(keys):
        if i == 0:
            continue
        d = next(k for k in range(3) if key[k] > 0)
        n = key[d]
        dec1 = list(key)
        dec1[d] -= 1
        axis[i] = d
        idx1[i] = pos[tuple(dec1)]
        if n > 1:
            dec2 = list(key)
            dec2[d] -= 2
            idx2[i] = pos[tuple(dec2)]
            fac[i] = n - 1
    return axis, idx1, idx2, fac


@lru_cache(maxsize=None)
def coupling_index(lab: int, lcd: int) -> np.ndarray:
    """IDX[s_bra, s_ket] = flat index of (tuv_bra + tuv_ket) in tri_set(L)."""
    bra, _ = tri_set(lab)
    ket, _ = tri_set(lcd)
    _, pos = tri_set(lab + lcd)
    idx = np.empty((len(bra), len(ket)), np.int64)
    for i, a in enumerate(bra):
        for j, b in enumerate(ket):
            idx[i, j] = pos[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]
    return idx


@lru_cache(maxsize=None)
def ket_signs(lcd: int) -> np.ndarray:
    """(-1)^{t+u+v} for the ket Hermite set (derivative w.r.t. Q)."""
    ket, _ = tri_set(lcd)
    return np.array([(-1.0) ** sum(k) for k in ket])


@lru_cache(maxsize=None)
def e_gather_index(li: int, lj: int):
    """Per-dimension flat indices into the (li+1, lj+1, li+lj+1) E table
    for every (component pair, Hermite tri_set(li+lj) entry), plus the
    mask of entries that are identically zero."""
    lab = li + lj
    n = lab + 1
    tri, _ = tri_set(lab)
    pairs = [(a, b) for a in cart_components(li) for b in cart_components(lj)]
    idx = np.zeros((3, len(pairs), len(tri)), np.int64)
    ok = np.ones((len(pairs), len(tri)), bool)
    for f, (a, b) in enumerate(pairs):
        for k, tuv in enumerate(tri):
            for d in range(3):
                if tuv[d] > a[d] + b[d]:
                    ok[f, k] = False
                idx[d, f, k] = (a[d] * (lj + 1) + b[d]) * n + min(tuv[d], lab)
    return idx, ok


# ------------------------------------------------------------ pair data
def make_pair_data(A, B, a, b, coef):
    """Pair quantities.  A, B: (*batch, 3); a, b, coef: (*batch,) (A and
    B may broadcast against a and b, e.g. (P, 1, 3) against (P, npp))."""
    p = a + b
    invp = 1.0 / p
    P = (a[..., None] * A + b[..., None] * B) * invp[..., None]
    AB = A - B
    r2 = (AB * AB).sum(-1)
    epref = torch.exp(-(a * b * invp) * r2)
    return dict(p=p, P=P, xpa=P - A, xpb=P - B, epref=epref, coef=coef)


def e_table(li: int, lj: int, inv2p, xpa, xpb, epref):
    """Hermite E coefficients (*batch, 3, li+1, lj+1, li+lj+1); the x row
    is seeded with the gaussian prefactor ``epref``, y/z rows with 1.
    inv2p, epref: (*batch,); xpa, xpb: (*batch, 3)."""
    n = li + lj + 1
    E = torch.zeros((*epref.shape, 3, li + 1, lj + 1, n), dtype=epref.dtype,
                    device=epref.device)
    E[..., 0, 0, 0, 0] = epref
    E[..., 1:, 0, 0, 0] = 1.0
    h = inv2p[..., None, None]
    tw = torch.arange(1, n + 1, dtype=epref.dtype, device=epref.device)

    def step(cur, xp):
        # new[t] = inv2p*cur[t-1] + xp*cur[t] + (t+1)*cur[t+1]
        up = torch.nn.functional.pad(cur[..., :-1], (1, 0))
        down = torch.nn.functional.pad(cur[..., 1:], (0, 1))
        return h * up + xp[..., None] * cur + tw * down

    for i in range(li):
        E[..., i + 1, 0, :] = step(E[..., i, 0, :], xpa)
    for j in range(lj):
        for i in range(li + 1):
            E[..., i, j + 1, :] = step(E[..., i, j, :], xpb)
    return E


def e_rows(li: int, lj: int, E):
    """(*batch, 3, li+1, lj+1, n) E table -> (*batch, nf_ij, NT_ij)
    products Ex(t) Ey(u) Ez(v), the last axis in tri_set(li+lj) order."""
    idx, ok = e_gather_index(li, lj)
    flat = E.reshape(*E.shape[:-4], 3, -1)
    rows = None
    for d in range(3):
        g = flat[..., d, :][..., torch.as_tensor(idx[d], device=E.device)]
        rows = g if rows is None else rows * g
    return rows * torch.as_tensor(ok, dtype=E.dtype, device=E.device)


def r_table(L: int, theta, PQ, fvals):
    """Hermite Coulomb R^0_{tuv} stacked over tri_set(L): (*batch, NR).
    theta: (*batch,); PQ: (*batch, 3); fvals: (L+1, *batch)."""
    axis, idx1, idx2, fac = r_recurrence_tables(L)
    dev, dt = theta.device, theta.dtype
    nr = len(axis)
    m2t = -2.0 * theta
    Xvec = PQ[..., torch.as_tensor(axis, device=dev)]
    i1 = torch.as_tensor(idx1, device=dev)
    i2 = torch.as_tensor(idx2, device=dev)
    fc = torch.as_tensor(fac, dtype=dt, device=dev)
    pw = [torch.ones_like(theta)]
    for _ in range(L):
        pw.append(pw[-1] * m2t)
    cur = torch.zeros((*theta.shape, nr), dtype=dt, device=dev)
    cur[..., 0] = pw[L] * fvals[L]
    for m in range(L - 1, -1, -1):
        cur = Xvec * cur[..., i1] + fc * cur[..., i2]
        cur[..., 0] = pw[m] * fvals[m]
    return cur


def cart_eri_primitive(ls, pdata, qdata, omega: float = 0.0):
    """Cartesian ERI block (T, nfab, nfcd) of one primitive quartet,
    with the 2 pi^{5/2}/(pq sqrt(p+q)) prefactor and the coefficients.

    ``omega`` > 0 evaluates erf(omega r12)/r12: theta -> theta w^2/(theta
    + w^2) in the R construction and a sqrt(w^2/(theta + w^2)) scale."""
    la, lb, lc, ld = ls
    lab, lcd = la + lb, lc + ld
    L = lab + lcd
    p, q = pdata["p"], qdata["p"]
    pq_sum = p + q
    theta = p * q / pq_sum
    pref = (2.0 * math.pi ** 2.5) / (p * q * torch.sqrt(pq_sum))
    if omega and omega > 0.0:
        w2 = float(omega) ** 2
        fac = w2 / (theta + w2)
        theta = theta * fac
        pref = pref * torch.sqrt(fac)
    pref = pref * pdata["coef"] * qdata["coef"]
    PQ = pdata["P"] - qdata["P"]
    fvals = boys(L, theta * (PQ * PQ).sum(-1))
    RT = r_table(L, theta, PQ, fvals)

    EB = e_rows(la, lb, e_table(la, lb, 0.5 / p, pdata["xpa"],
                                pdata["xpb"], pdata["epref"]))
    ED = e_rows(lc, ld, e_table(lc, ld, 0.5 / q, qdata["xpa"],
                                qdata["xpb"], qdata["epref"]))
    ED = ED * torch.as_tensor(ket_signs(lcd), dtype=ED.dtype, device=ED.device)
    cidx = torch.as_tensor(coupling_index(lab, lcd), device=RT.device)
    M = RT[:, cidx]  # (T, NTab, NTcd)
    out = torch.bmm(EB, torch.bmm(M, ED.transpose(1, 2)))
    return out * pref[:, None, None]


def eri_plain(ls, nprims, quartet, omega: float = 0.0):
    """Plain contracted ERI blocks (T, nfab, nfcd): the sum over primitive
    quartets of ``cart_eri_primitive`` (contract of ops/eri.py).

    As in the JAX XLA path, the primitive quartets are flattened into the
    batch in slices of n quartets x T tasks, n chosen so that one slice's
    largest intermediates stay under SLICE_ELEMS elements."""
    la, lb, lc, ld = ls
    A, B, C, D = (quartet[f"coord_{x}"] for x in "abcd")
    ex = [quartet[f"exps_{x}"] for x in "abcd"]
    cf = [quartet[f"coefs_{x}"] for x in "abcd"]
    T = A.shape[0]
    nfab = len(cart_components(la)) * len(cart_components(lb))
    nfcd = len(cart_components(lc)) * len(cart_components(ld))
    ntab = len(tri_set(la + lb)[0])
    ntcd = len(tri_set(lc + ld)[0])
    per_row = ntab * ntcd + nfab * ntcd + nfab * nfcd + len(tri_set(sum(ls))[0])
    slots = np.array(np.meshgrid(*[np.arange(n) for n in nprims],
                                 indexing="ij")).reshape(4, -1)
    n_slice = max(1, min(slots.shape[1], SLICE_ELEMS // max(T * per_row, 1)))
    out = torch.zeros((T, nfab, nfcd), dtype=A.dtype, device=A.device)
    for s0 in range(0, slots.shape[1], n_slice):
        sl = torch.as_tensor(slots[:, s0 : s0 + n_slice], device=A.device)
        n = sl.shape[1]

        def col(x, k):  # (T, np) -> (n*T,) slot-major
            return x[:, sl[k]].T.reshape(-1)

        def rep(X):
            return X.repeat(n, 1)

        pd = make_pair_data(rep(A), rep(B), col(ex[0], 0), col(ex[1], 1),
                            col(cf[0], 0) * col(cf[1], 1))
        qd = make_pair_data(rep(C), rep(D), col(ex[2], 2), col(ex[3], 3),
                            col(cf[2], 2) * col(cf[3], 3))
        blk = cart_eri_primitive(ls, pd, qd, omega).view(n, T, nfab, nfcd)
        out += blk.sum(0)
    return out
