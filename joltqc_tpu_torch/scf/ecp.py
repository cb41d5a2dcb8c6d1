"""ECP engine: batched type-1/type-2 semi-local integrals in float64.

Port of ``joltqc_tpu/scf/ecp.py``.  Reference counterpart: JoltQC
jqc/backend/ecp.py and its CUDA kernels ecp_type1.cu / ecp_type2.cu.

 - a *task* is one (shell_i, shell_j, ECP center+channel) triple of a
   fixed class (li, lj, nprim buckets, channel l / local); a chunk of up
   to ``chunk`` tasks is evaluated with every stage vectorized over the
   tasks, the primitive pairs (stacked on an axis of their own) and the
   Bessel orders -- the angular algebra is batched float64 products
   against static host-precomputed tables;
 - the radial quadrature is a per-task 128-point Gauss-Legendre rule on
   +-12 sigma around the integrand's peak, clamped at 0 (the scheme of
   the numpy oracle, mol/ecp_np.py:_radial_grid);
 - the host side (angular tables, task lists with their peak-integrand
   screening and order, the derivative shift maps) is the JAX package's
   code; the JAX package's DF64 pairs are float64 here;
 - each call evaluates every chunk on the device, copies all blocks to
   the host in one transfer, and scatters them there in a fixed order
   (``np.add.at``, chunk after chunk), so results are bit-identical from
   run to run.  ECP cost is O(nbas^2 * necp), far off the SCF hot path.

Math (the oracle's operator algebra, mol/ecp_np.py docstring): type2
couples shell i to the projector via per-shell angular factors
ang_i[(fi, s_i, lam_i), m] and a radial table
rad[t, (s_i, lam_i), (s_j, lam_j)] = sum_r w U_l r^{2+s_i+s_j}
    e^{-a(r-|Di|)^2 - b(r-|Dj|)^2} i~_{lam_i}(2a|Di|r) i~_{lam_j}(2b|Dj|r);
type1 couples both shells to the local channel through the combined
k = 2(a Di + b Dj) direction.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb

import numpy as np
import torch

from ..mol.layout import BasisLayout
from ..ops.bessel import ine
from ..ops.cuda import resolve_device
from ..ops.harmonics import _sphere_monomial_integral, cart_components, real_sph_ortho
from .tasks import build_shell_classes

_NQUAD = 128  # radial Gauss-Legendre points (reference: 128-pt Chebyshev)
_WINDOW = 12.0  # +- window half-width in units of sigma
_SCREEN_EXP = 45.0  # drop tasks whose peak integrand is below e^-45


# ================================================================ static
@lru_cache(maxsize=None)
def _mono_basis(lam_max: int):
    """Monomial exponents covering the Y_0..Y_lam_max blocks.

    Returns (exps (K,3) int array, [slice per lam])."""
    exps, blocks = [], []
    for lam in range(lam_max + 1):
        start = len(exps)
        exps.extend(cart_components(lam))
        blocks.append(slice(start, len(exps)))
    return np.array(exps, np.int32), blocks


@lru_cache(maxsize=None)
def _mono_Y(q: tuple, lam: int) -> np.ndarray:
    """S[mu] = int w^q Y_lam,mu dOmega (exact)."""
    coef = real_sph_ortho(lam)
    comps = cart_components(lam)
    out = np.zeros(2 * lam + 1)
    for m in range(2 * lam + 1):
        for c, (a, b, cc) in zip(coef[m], comps):
            if c != 0.0:
                out[m] += c * _sphere_monomial_integral(q[0] + a, q[1] + b, q[2] + cc)
    return out


@lru_cache(maxsize=None)
def _mono_YY(q: tuple, lam: int, l: int) -> np.ndarray:
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


def _binom_rows(lx, ly, lz):
    """[(p, binom_coef)] for the (r w - D)^(lx,ly,lz) expansion."""
    out = []
    for px in range(lx + 1):
        for py in range(ly + 1):
            for pz in range(lz + 1):
                c = comb(lx, px) * comb(ly, py) * comb(lz, pz)
                out.append(((px, py, pz), float(c)))
    return out


@lru_cache(maxsize=None)
def _t2_shell_meta(l_sh: int, l_ecp: int):
    """Static angular metadata for one shell side of a type-2 task class.

    Row space: (cart comp fi, binomial term p, bessel order lam), pruned
    when the combined angular weight vanishes.  Per row:
      e_pow (3,)  -- exponents of the D_i-vector power (sign folded in)
      slot        -- flat (fi, s=|p|, lam) output slot
      W (K, 2l+1) -- monomials-of-Dhat -> m-vector map, includes the
                     binomial coefficient, (-1)^|e|, and the 4pi factor
    Returns dict(e_pow (R,3), slot (R,), W (R,K,M), nslot, ns, nlam, K).
    """
    comps = cart_components(l_sh)
    lam_max = l_sh + l_ecp
    mono_exps, blocks = _mono_basis(lam_max)
    K = len(mono_exps)
    M = 2 * l_ecp + 1
    ns, nlam = l_sh + 1, lam_max + 1
    e_pow, slot, W = [], [], []
    for fi, (ax, ay, az) in enumerate(comps):
        for (p, cb) in _binom_rows(ax, ay, az):
            e = (ax - p[0], ay - p[1], az - p[2])
            s = sum(p)
            sign = (-1.0) ** sum(e)
            for lam in range(lam_max + 1):
                T = _mono_YY(p, lam, l_ecp)  # (mu, M)
                S = real_sph_ortho(lam)  # (mu, K_lam)
                Wrow = np.zeros((K, M))
                Wrow[blocks[lam]] = 4.0 * np.pi * cb * sign * (S.T @ T)
                if np.abs(Wrow).max() < 1e-16:
                    continue
                e_pow.append(e)
                slot.append((fi * ns + s) * nlam + lam)
                W.append(Wrow)
    return dict(
        e_pow=np.array(e_pow, np.int32),
        slot=np.array(slot, np.int32),
        W=np.array(W),  # (R, K, M)
        nslot=len(comps) * ns * nlam,
        ns=ns,
        nlam=nlam,
        K=K,
        lam_max=lam_max,
        nf=len(comps),
    )


@lru_cache(maxsize=None)
def _t1_pair_meta(la: int, lb: int):
    """Static angular metadata for a type-1 (local channel) task class.

    Row space: (fi, fj, p_i, p_j, lam) pruned on vanishing V.  Per row:
      e_i, e_j (3,) -- D_i / D_j vector power exponents (signs folded)
      slot_out      -- fi*nfb + fj
      slot_rad      -- s*(lam_max+1) + lam,  s = |p_i + p_j|
      V (K,)        -- monomials-of-khat -> scalar angular weight
    """
    compsa, compsb = cart_components(la), cart_components(lb)
    lam_max = la + lb
    mono_exps, blocks = _mono_basis(lam_max)
    K = len(mono_exps)
    ns, nlam = la + lb + 1, lam_max + 1
    e_i, e_j, slot_out, slot_rad, V = [], [], [], [], []
    for fi, (ax, ay, az) in enumerate(compsa):
        rows_i = _binom_rows(ax, ay, az)
        for fj, (bx, by, bz) in enumerate(compsb):
            rows_j = _binom_rows(bx, by, bz)
            for (pi, cbi) in rows_i:
                ei = (ax - pi[0], ay - pi[1], az - pi[2])
                for (pj, cbj) in rows_j:
                    ej = (bx - pj[0], by - pj[1], bz - pj[2])
                    q = (pi[0] + pj[0], pi[1] + pj[1], pi[2] + pj[2])
                    s = sum(q)
                    sign = (-1.0) ** (sum(ei) + sum(ej))
                    for lam in range(lam_max + 1):
                        Sq = _mono_Y(q, lam)  # (mu,)
                        if np.abs(Sq).max() < 1e-16:
                            continue
                        S = real_sph_ortho(lam)  # (mu, K_lam)
                        Vrow = np.zeros(K)
                        Vrow[blocks[lam]] = 4.0 * np.pi * cbi * cbj * sign * (Sq @ S)
                        if np.abs(Vrow).max() < 1e-16:
                            continue
                        e_i.append(ei)
                        e_j.append(ej)
                        slot_out.append(fi * len(compsb) + fj)
                        slot_rad.append(s * nlam + lam)
                        V.append(Vrow)
    return dict(
        e_i=np.array(e_i, np.int32),
        e_j=np.array(e_j, np.int32),
        slot_out=np.array(slot_out, np.int32),
        slot_rad=np.array(slot_rad, np.int32),
        V=np.array(V),  # (R, K)
        ns=ns,
        nlam=nlam,
        K=K,
        lam_max=lam_max,
        nfa=len(compsa),
        nfb=len(compsb),
    )


@lru_cache(maxsize=None)
def _leg_nodes():
    x, w = np.polynomial.legendre.leggauss(_NQUAD)
    return x, w


@lru_cache(maxsize=None)
def _slot_groups(slot: tuple, nslot: int) -> np.ndarray:
    """(nslot, dmax) row indices per output slot, ascending, padded with
    len(slot) (an appended zero row): the 0/1 row->slot map as a gather."""
    rows = [[] for _ in range(nslot)]
    for r, s in enumerate(slot):
        rows[s].append(r)
    dmax = max(1, max(len(x) for x in rows))
    out = np.full((nslot, dmax), len(slot), np.int64)
    for s, x in enumerate(rows):
        out[s, : len(x)] = x
    return out


# ============================================================== device ops
class _Tables:
    """An engine's device copies of the static tables, by key."""

    def __init__(self, device):
        self.device = device
        self._cache = {}

    def get(self, key, make, dtype=torch.float64):
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(np.ascontiguousarray(make()), dtype=dtype,
                                device=self.device)
            self._cache[key] = t
        return t


def _group_sum(x, groups, dim: int):
    """Sum the rows of ``x`` along ``dim`` into slots: a gather of each
    slot's rows (``groups`` from _slot_groups, on the device) and a
    fixed-order sum -- the JAX package's exact 0/1 product."""
    pad = list(x.shape)
    pad[dim] = 1
    xp = torch.cat([x, x.new_zeros(pad)], dim)
    g = xp.index_select(dim, groups.reshape(-1))
    shape = list(x.shape)
    shape[dim:dim + 1] = list(groups.shape)
    return g.reshape(shape).sum(dim + 1)


def _safe_unit(D):
    """(..., 3) -> (Dhat (..., 3), |D| (...)); D = 0 -> z-hat, |D| = 0.

    The threshold is the JAX package's: r^2 < 1e-24 (every shell on the
    ECP atom itself takes this branch)."""
    r2 = D[..., 0] * D[..., 0] + D[..., 1] * D[..., 1] + D[..., 2] * D[..., 2]
    tiny = r2 < 1e-24
    mag = torch.sqrt(torch.where(tiny, torch.ones_like(r2), r2))
    hat = D * (1.0 / mag)[..., None]
    zhat = torch.zeros_like(hat)
    zhat[..., 2] = 1.0
    hat = torch.where(tiny[..., None], zhat, hat)
    mag = torch.where(tiny, torch.zeros_like(mag), mag)
    return hat, mag


def _pow_table(x, nmax: int):
    """(..., 3) -> (..., 3, nmax+1) powers x^0..x^nmax."""
    ones = torch.ones(x.shape + (1,), dtype=x.dtype, device=x.device)
    if nmax == 0:
        return ones
    rep = x[..., None].expand(x.shape + (nmax,))
    return torch.cat([ones, torch.cumprod(rep, dim=-1)], dim=-1)


def _gather_pow(pows, e_pow):
    """pows (..., 3, n+1), e_pow (R, 3) device int -> (..., R) product."""
    return (pows[..., 0, :][..., e_pow[:, 0]]
            * pows[..., 1, :][..., e_pow[:, 1]]
            * pows[..., 2, :][..., e_pow[:, 2]])


def _radial_grid(p, kmag, zmin: float, tab):
    """Per-task Gauss-Legendre nodes/weights on the integrand support.

    p, kmag (...); zmin the channel's smallest exponent.  Returns (r, w)
    (..., NQ)."""
    xs = tab.get(("legx",), lambda: _leg_nodes()[0])
    ws = tab.get(("legw",), lambda: _leg_nodes()[1])
    inv = 1.0 / (p + zmin)
    rstar = (kmag * inv) * 0.5
    sigma = torch.sqrt(inv * 0.5)
    lo = rstar - sigma * _WINDOW
    lo = torch.where(lo < 0.0, torch.zeros_like(lo), lo)
    hi = rstar + sigma * _WINDOW
    half = ((hi - lo) * 0.5)[..., None]
    # r = lo + half*(x+1); weights w * half
    r = (lo[..., None] + half * xs) + half
    return r, half * ws


def _channel_u(r, wq, ch):
    """w * U_l(r) * r^2 = sum_k d_k r^{n_k} e^{-z_k r^2} * w."""
    powers, exps, coefs = ch
    r2 = r * r
    out = torch.zeros_like(r)
    for n, z, d in zip(powers, exps, coefs):
        ex = torch.exp(-(r2 * float(z)))
        if int(n) == 0:
            out = out + ex * float(d)
        else:
            out = out + ((r if int(n) == 1 else r2) * float(d)) * ex
    return out * wq


def _r_powers(r, smax: int):
    """(..., NQ) -> (smax+1, ..., NQ) powers r^0..r^smax."""
    ones = torch.ones((1,) + r.shape, dtype=r.dtype, device=r.device)
    if smax == 0:
        return ones
    return torch.cat([ones, torch.cumprod(r.expand((smax,) + r.shape), 0)])


def _mono_vec(tab, hat, lam_max: int):
    """Unit vectors (..., 3) -> monomial vector (..., K)."""
    exps = tab.get(("mono", lam_max), lambda: _mono_basis(lam_max)[0],
                   torch.int64)
    return _gather_pow(_pow_table(hat, lam_max), exps)


def _prim_pairs(ea, eb, ca, cb):
    """(T, npa), (T, npb) -> (a, b, ca*cb), each (T, npa*npb), pair index
    ia*npb + ib (the JAX package's stacking order)."""
    npa, npb = ea.shape[1], eb.shape[1]
    a = ea.repeat_interleave(npb, dim=1)
    b = eb.repeat(1, npa)
    cc = ca.repeat_interleave(npb, dim=1) * cb.repeat(1, npa)
    return a, b, cc


def _ang_B(tab, meta, key, D, hat):
    """Angular tensor B[t, nslot, M] for one type-2 shell side."""
    K, M = meta["K"], meta["W"].shape[2]
    R = len(meta["slot"])
    T = D.shape[0]
    mono = _mono_vec(tab, hat, meta["lam_max"])  # (T, K)
    e_pow = tab.get(("t2e",) + key, lambda: meta["e_pow"], torch.int64)
    powD = _gather_pow(_pow_table(D, max(meta["ns"] - 1, 0)), e_pow)  # (T, R)
    W = tab.get(("t2W",) + key,
                lambda: meta["W"].transpose(1, 0, 2).reshape(K, R * M))
    # ang[t, r, m] = powD * sum_k mono[t,k] W[r,k,m]
    ang = (mono @ W).reshape(T, R, M) * powD[:, :, None]
    groups = tab.get(("t2g",) + key, lambda: _slot_groups(
        tuple(meta["slot"].tolist()), meta["nslot"]), torch.int64)
    return _group_sum(ang, groups, 1)  # (T, nslot, M)


# ============================================================== kernels
def _type2_batch(tab, la, lb, ch, zmin, A, B, C, ea, eb, ca, cb):
    """Type-2 (semi-local channel l = ch[0]) blocks (T, nfa, nfb) of one
    task chunk: shells of angular momenta la, lb at A, B (T, 3) with
    primitives (T, npa), (T, npb); the ECP at C (3,)."""
    lc = ch[0]
    mi = _t2_shell_meta(la, lc)
    mj = _t2_shell_meta(lb, lc)
    M = 2 * lc + 1
    nfa, nfb = mi["nf"], mj["nf"]
    Qi, Qj = mi["ns"] * mi["nlam"], mj["ns"] * mj["nlam"]
    Di = A - C
    Dj = B - C
    hat_i, dmi = _safe_unit(Di)
    hat_j, dmj = _safe_unit(Dj)
    Bi = _ang_B(tab, mi, (la, lc), Di, hat_i)  # (T, nfa*Qi, M)
    Bj = _ang_B(tab, mj, (lb, lc), Dj, hat_j)  # (T, nfb*Qj, M)

    # every primitive pair at once on axis 1: (T, P), (T, P, NQ)
    a, b, cc = _prim_pairs(ea, eb, ca, cb)
    T, P = a.shape
    dmi, dmj = dmi[:, None], dmj[:, None]
    kmag = (a * dmi + b * dmj) * 2.0
    r, wq = _radial_grid(a + b, kmag, zmin, tab)
    base = _channel_u(r, wq, ch[1:])
    # gaussian factor e^{-a(r-dmi)^2 - b(r-dmj)^2}
    ti = r - dmi[..., None]
    tj = r - dmj[..., None]
    expo = -(a[..., None] * (ti * ti) + b[..., None] * (tj * tj))
    base = (base * torch.exp(expo)) * cc[..., None]
    Ii = ine(mi["lam_max"], ((a * dmi) * 2.0)[..., None] * r)  # (nlam, T, P, NQ)
    Ij = ine(mj["lam_max"], ((b * dmj) * 2.0)[..., None] * r)
    A1 = _r_powers(r, mi["ns"] - 1)[:, None] * Ii[None]  # (ns, nlam, T, P, NQ)
    A2 = (_r_powers(r, mj["ns"] - 1)[:, None] * Ij[None]) * base
    n = P * r.shape[-1]
    # rad[t, Qi, Qj]: the sum over nodes and primitive pairs
    rad = torch.bmm(A1.reshape(Qi, T, n).transpose(0, 1),
                    A2.reshape(Qj, T, n).permute(1, 2, 0))

    # E[t, Qi, nfb*M] = rad @ Bj'[t, Qj, nfb*M]
    BjT = Bj.reshape(T, nfb, Qj, M).transpose(1, 2).reshape(T, Qj, nfb * M)
    E = torch.bmm(rad, BjT)
    # out[t, fi, fj] = sum_{Qi, M} Bi[t, fi, Qi, M] E[t, Qi, fj, M]
    E = E.reshape(T, Qi, nfb, M).transpose(2, 3).reshape(T, Qi * M, nfb)
    return torch.bmm(Bi.reshape(T, nfa, Qi * M), E)


def _type1_batch(tab, la, lb, ch, zmin, A, B, C, ea, eb, ca, cb):
    """Type-1 (local channel) blocks (T, nfa, nfb) of one task chunk."""
    meta = _t1_pair_meta(la, lb)
    nfa, nfb = meta["nfa"], meta["nfb"]
    ns = meta["ns"]
    key = (la, lb)
    Di = A - C
    Dj = B - C
    _, dmi = _safe_unit(Di)
    _, dmj = _safe_unit(Dj)
    e_i = tab.get(("t1ei",) + key, lambda: meta["e_i"], torch.int64)
    e_j = tab.get(("t1ej",) + key, lambda: meta["e_j"], torch.int64)
    powD = (_gather_pow(_pow_table(Di, la), e_i)
            * _gather_pow(_pow_table(Dj, lb), e_j))  # (T, R)
    Vt = tab.get(("t1V",) + key, lambda: meta["V"].T)  # (K, R)

    a, b, cc = _prim_pairs(ea, eb, ca, cb)  # (T, P)
    T, P = a.shape
    p = a + b
    kvec = (a[..., None] * Di[:, None, :] + b[..., None] * Dj[:, None, :]) * 2.0
    khat, kmag = _safe_unit(kvec)  # (T, P, 3), (T, P)
    # ang[t, p, r] = powD * sum_k mono V[k, r]
    ang = (_mono_vec(tab, khat, meta["lam_max"]) @ Vt) * powD[:, None, :]

    r, wq = _radial_grid(p, kmag, zmin, tab)
    base = _channel_u(r, wq, ch[1:])
    expo = ((kmag[..., None] * r - p[..., None] * (r * r))
            + (-(a * (dmi * dmi)[:, None] + b * (dmj * dmj)[:, None]))[..., None])
    base = (base * torch.exp(expo)) * cc[..., None]
    I = ine(meta["lam_max"], kmag[..., None] * r)  # (nlam, T, P, NQ)
    # rad[t, p, (s, lam)] = sum_r r^s i~_lam base
    rad = torch.einsum("stpn,ltpn->tpsl", _r_powers(r, ns - 1), I * base)
    slot_rad = tab.get(("t1sr",) + key, lambda: meta["slot_rad"], torch.int64)
    contrib = (ang * rad.reshape(T, P, -1)[..., slot_rad]).sum(1)  # (T, R)
    groups = tab.get(("t1g",) + key, lambda: _slot_groups(
        tuple(meta["slot_out"].tolist()), nfa * nfb), torch.int64)
    return _group_sum(contrib, groups, 1).reshape(T, nfa, nfb)


# ===================================================== derivative maps
@lru_cache(maxsize=None)
def _shift_maps(l: int):
    """Cartesian-component maps for d/dA via angular-momentum shifts.

    d/dA_d phi_(comp) = 2a * phi_(comp + e_d)  -  comp[d] * phi_(comp - e_d)
    (reference counterpart: the shifted-LI derivative kernels,
    JoltQC jqc/backend/ecp/ecp_type1_ip.cu).
    Returns (plus_idx (3, nf), minus_idx (3, nf), minus_coef (3, nf));
    minus_idx = 0 with coef 0 when comp[d] == 0."""
    comps = cart_components(l)
    up = {c: i for i, c in enumerate(cart_components(l + 1))}
    dn = {c: i for i, c in enumerate(cart_components(l - 1))} if l > 0 else {}
    nf = len(comps)
    plus = np.zeros((3, nf), np.int64)
    minus = np.zeros((3, nf), np.int64)
    mcoef = np.zeros((3, nf))
    for fi, c in enumerate(comps):
        for d in range(3):
            e = [0, 0, 0]
            e[d] = 1
            plus[d, fi] = up[(c[0] + e[0], c[1] + e[1], c[2] + e[2])]
            if c[d] > 0:
                minus[d, fi] = dn[(c[0] - e[0], c[1] - e[1], c[2] - e[2])]
                mcoef[d, fi] = c[d]
    return plus, minus, mcoef


@lru_cache(maxsize=None)
def _shift2_maps(l: int):
    """Second-derivative composition maps: d^2/dA_d dA_e via two shifts.

    D_e(D_d phi_c) = 4a^2 phi_{c+d+e}
                   - 2a (c_e + delta_de) phi_{c+d-e}
                   - 2a c_d phi_{c-d+e}
                   + c_d (c_e - delta_de) phi_{c-d-e}
    (terms with a negative component are absent).  Returns, for each
    (d, e): a list over fi of [(level, idx, coef)] where level indexes
    the kernel evaluation family: 2 -> l+2 with 4a^2-scaled coefs,
    1 -> l with 2a-scaled coefs, 0 -> l-2 with plain coefs."""
    comps = cart_components(l)
    # level mapping: kernel family 2 -> l+2, 1 -> l, 0 -> l-2
    pos2 = {c: i for i, c in enumerate(cart_components(l + 2))}
    pos1 = {c: i for i, c in enumerate(cart_components(l))}
    pos0 = (
        {c: i for i, c in enumerate(cart_components(l - 2))} if l >= 2 else {}
    )
    out = {}
    for d in range(3):
        for e in range(3):
            ed = np.eye(3, dtype=int)[d]
            ee = np.eye(3, dtype=int)[e]
            rows = []
            for fi, c in enumerate(comps):
                c = np.array(c, int)
                terms = []
                terms.append((2, pos2[tuple(c + ed + ee)], 1.0))
                t = c + ed - ee
                if t.min() >= 0:
                    terms.append((1, pos1[tuple(t)], -(c[e] + (1.0 if d == e else 0.0))))
                t = c - ed + ee
                if t.min() >= 0 and c[d] > 0:
                    terms.append((1, pos1[tuple(t)], -float(c[d])))
                t = c - ed - ee
                if t.min() >= 0 and c[d] > 0:
                    coef = c[d] * (c[e] - (1.0 if d == e else 0.0))
                    if coef != 0.0:
                        terms.append((0, pos0[tuple(t)], float(coef)))
                rows.append(terms)
            out[(d, e)] = rows
    return out


# Each derivative is a combination of value evaluations with shifted
# angular momenta and 2a- or 4a^2-scaled bra (ket) coefficients.  An
# evaluation is (dla, dlb, scale_a, scale_b); the *_evals functions list
# what a chunk needs, the *_combine functions take the host arrays in
# that order.
def _deriv_a_evals(la):
    """d/dA: l+1 with 2a-scaled coefficients, l-1 plain (l > 0)."""
    return [(1, 0, 1, 0)] + ([(-1, 0, 0, 0)] if la > 0 else [])


def _deriv_a_combine(la, vals):
    """(3, B, nfa, nfb) bra-centre derivative (see _shift_maps)."""
    plus, minus, mcoef = _shift_maps(la)
    out = vals[0][:, plus, :].transpose(1, 0, 2, 3)
    if la > 0:
        out = out - mcoef[:, None, :, None] * vals[1][:, minus, :].transpose(
            1, 0, 2, 3
        )
    return out


def _deriv2_aa_evals(la):
    """d^2/dA dA: l+2 (4a^2), l (2a), l-2 plain (l >= 2)."""
    return [(2, 0, 2, 0), (0, 0, 1, 0)] + ([(-2, 0, 0, 0)] if la >= 2 else [])


def _deriv2_aa_combine(la, vals):
    """(3, 3, B, nfa, nfb) d^2/dA_d dA_e blocks -- 'ipipv'."""
    Vs = {2: vals[0], 1: vals[1]}
    if la >= 2:
        Vs[0] = vals[2]
    maps = _shift2_maps(la)
    nfa = len(cart_components(la))
    B, nfb = Vs[2].shape[0], Vs[2].shape[2]
    out = np.zeros((3, 3, B, nfa, nfb))
    for (d, e), rows in maps.items():
        for fi, terms in enumerate(rows):
            for (lv, idx, coef) in terms:
                out[d, e, :, fi, :] += coef * Vs[lv][:, idx, :]
    return out


def _deriv_ab_evals(la, lb):
    """d^2/dA dB: (l_a +- 1) x (l_b +- 1), raised sides 2a-scaled."""
    out = []
    for sa, dla in ((1, 1), (0, -1)):
        if dla < 0 and la == 0:
            continue
        for sb, dlb in ((1, 1), (0, -1)):
            if dlb < 0 and lb == 0:
                continue
            out.append((dla, dlb, sa, sb))
    return out


def _deriv_ab_combine(la, lb, vals):
    """(3, 3, B, nfa, nfb) d^2/dA_d dB_e blocks -- 'ipvip'."""
    V = {(e[0], e[1]): v for e, v in zip(_deriv_ab_evals(la, lb), vals)}
    plus_a, minus_a, mca = _shift_maps(la)
    plus_b, minus_b, mcb = _shift_maps(lb)
    nfa = len(cart_components(la))
    nfb = len(cart_components(lb))
    B = V[(1, 1)].shape[0]
    out = np.zeros((3, 3, B, nfa, nfb))
    for d in range(3):
        for e in range(3):
            blk = V[(1, 1)][:, plus_a[d], :][:, :, plus_b[e]]
            if lb > 0:
                blk = blk - mcb[e][None, None, :] * V[(1, -1)][
                    :, plus_a[d], :
                ][:, :, minus_b[e]]
            if la > 0:
                blk = blk - mca[d][None, :, None] * V[(-1, 1)][
                    :, minus_a[d], :
                ][:, :, plus_b[e]]
                if lb > 0:
                    blk = blk + (
                        mca[d][None, :, None] * mcb[e][None, None, :]
                    ) * V[(-1, -1)][:, minus_a[d], :][:, :, minus_b[e]]
            out[d, e] = blk
    return out


# =============================================================== engine
class ECPEngine:
    """Batched evaluation of the full ECP matrix over a BasisLayout.

    Reference counterpart: the get_ecp host code (JoltQC
    jqc/backend/ecp.py:1371-1501).  Runs on ``cuda`` unless ``device``
    says otherwise; ``device="cpu"`` runs the same PyTorch code on the
    host.  ``last_run`` holds the chunk, task and evaluation counts of
    the latest call."""

    def __init__(self, layout: BasisLayout, device=None, chunk: int = 128):
        self.layout = layout
        self.mol = layout.mol
        self.chunk = chunk
        self.device = resolve_device(device)
        self.classes = build_shell_classes(layout)
        self._centers = self._collect_channels()
        self._tab = _Tables(self.device)
        self._task_list = None
        self.last_run: dict = {}

    def _collect_channels(self):
        """[(C coord, l, powers, exps, coefs, atom_idx)] per (atom, channel)."""
        mol = self.mol
        out = []
        if not getattr(mol, "ecp", None):
            return out
        for ia in range(mol.natm):
            data = mol.ecp.get(mol.atom_symbols[ia].capitalize())
            if data is None:
                continue
            C = mol.coords[ia]
            for ch in data.channels:
                out.append((C, ch.l, ch.powers, ch.exps, ch.coefs, ia))
        return out

    # ------------------------------------------------------------ tasks
    def _tasks(self):
        """Yield (class_i, class_j, channel, [(si, sj, icen), ...]) blocks."""
        classes = self.classes
        for ci in range(len(classes)):
            for cj in range(ci + 1):
                c1, c2 = classes[ci], classes[cj]
                for icen, (C, l, powers, exps, coefs, _ia) in enumerate(
                    self._centers
                ):
                    tasks = []
                    zmin = float(exps.min())
                    for si in range(c1.nshell):
                        if c1.shell_ids[si] < 0:
                            continue
                        dmi = np.linalg.norm(c1.coords[si] - C)
                        ai = c1.exps[si][c1.coefs[si] != 0]
                        a = float(ai.min()) if len(ai) else 1.0
                        sj_max = si + 1 if ci == cj else c2.nshell
                        for sj in range(sj_max):
                            if c2.shell_ids[sj] < 0:
                                continue
                            dmj = np.linalg.norm(c2.coords[sj] - C)
                            bj = c2.exps[sj][c2.coefs[sj] != 0]
                            b = float(bj.min()) if len(bj) else 1.0
                            # peak-integrand screening (collinear upper
                            # bound; see module docstring)
                            pt = a + b + zmin
                            rh = (a * dmi + b * dmj) / pt
                            val = (
                                a * (rh - dmi) ** 2
                                + b * (rh - dmj) ** 2
                                + zmin * rh * rh
                            )
                            if val < _SCREEN_EXP:
                                tasks.append((si, sj))
                    if tasks:
                        yield ci, cj, icen, tasks

    def _chunks(self):
        """[(ci, cj, icen, si, sj)]: the task lists cut into chunks of at
        most ``chunk`` tasks (si, sj int arrays), in the task order."""
        if self._task_list is None:
            out = []
            for ci, cj, icen, tasks in self._tasks():
                t = np.asarray(tasks, np.int64)
                for s in range(0, len(t), self.chunk):
                    out.append((ci, cj, icen, t[s:s + self.chunk, 0],
                                t[s:s + self.chunk, 1]))
            self._task_list = out
        return self._task_list

    # ------------------------------------------------------------ device
    def _class_tensors(self, ci: int, scale: int):
        """Device (coords, exps, coefs) of class ci; ``scale`` 1 or 2
        multiplies the coefficients by 2a or 4a^2 (the raising terms of
        the d/dA shift identity)."""
        c = self.classes[ci]

        def coefs():
            if scale == 1:
                return 2.0 * c.exps * c.coefs
            if scale == 2:
                return 4.0 * c.exps ** 2 * c.coefs
            return c.coefs

        tab = self._tab
        return (tab.get(("coords", ci), lambda: c.coords),
                tab.get(("exps", ci), lambda: c.exps),
                tab.get(("coefs", ci, scale), coefs))

    def _eval(self, ci, cj, icen, si, sj, la, lb, scale_a=0, scale_b=0):
        """Device blocks (T, nf(la), nf(lb)) of one chunk, the two sides'
        angular momenta set to la and lb (value: the classes' own)."""
        C, l, powers, exps, coefs, _ia = self._centers[icen]
        dev = self.device
        xa, ea, ca = self._class_tensors(ci, scale_a)
        xb, eb, cb = self._class_tensors(cj, scale_b)
        si = torch.as_tensor(si, device=dev)
        sj = torch.as_tensor(sj, device=dev)
        Cd = self._tab.get(("center", icen), lambda: C)
        # the JAX package offsets the radial window by the channel's
        # smallest exponent as a float32 value; so does this port
        zmin = float(np.float32(exps.min()))
        fn = _type1_batch if l < 0 else _type2_batch
        return fn(self._tab, la, lb, (l, powers, exps, coefs), zmin,
                  xa[si], xb[sj], Cd, ea[si], eb[sj], ca[si], cb[sj])

    def _run(self, jobs):
        """Evaluate every (chunk, dla, dlb, scale_a, scale_b) job on the
        device, then copy all blocks to the host in one transfer."""
        outs = []
        for (ci, cj, icen, si, sj), (dla, dlb, sa, sb) in jobs:
            outs.append(self._eval(ci, cj, icen, si, sj,
                                   self.classes[ci].l + dla,
                                   self.classes[cj].l + dlb, sa, sb))
        if not outs:
            return []
        flat = torch.cat([o.reshape(-1) for o in outs]).cpu().numpy()
        res, off = [], 0
        for o in outs:
            res.append(flat[off:off + o.numel()].reshape(o.shape))
            off += o.numel()
        return res

    def _note(self, chunks, njobs):
        self.last_run = {"chunks": len(chunks),
                         "tasks": int(sum(len(c[3]) for c in chunks)),
                         "evaluations": njobs}

    # ------------------------------------------------------------ host
    def _scatter(self, out, ci, cj, si, sj, blk, mirror):
        """out[..., a0+i, b0+j] += blk[..., t, i, j] for every task t, and
        off the shell diagonal out[..., b0+j, a0+i] += mirror[..., t, j, i]
        (np.add.at: a fixed order)."""
        c1, c2 = self.classes[ci], self.classes[cj]
        nfa, nfb = blk.shape[-2:]
        a0 = c1.ao[si].astype(np.int64)[:, None, None]
        b0 = c2.ao[sj].astype(np.int64)[:, None, None]
        fa = np.arange(nfa)
        fb = np.arange(nfb)
        off = ~((ci == cj) & (si == sj))
        outf = out.reshape((-1,) + out.shape[-2:])
        blk = blk.reshape((-1,) + blk.shape[-3:])
        mirror = mirror.reshape((-1,) + mirror.shape[-3:])
        for k in range(outf.shape[0]):
            np.add.at(outf[k], (a0 + fa[:, None], b0 + fb), blk[k])
            np.add.at(outf[k], ((b0 + fb[:, None])[off], (a0 + fa)[off]),
                      mirror[k][off])

    def _ecp_atoms(self):
        atoms = sorted({c[5] for c in self._centers})
        return atoms, {ia: k for k, ia in enumerate(atoms)}

    def _to_mol(self, out):
        """(..., nao_int, nao_int) -> (..., nao, nao) in the molecular basis."""
        lay = self.layout
        nmo = lay.nao_mol
        flat = out.reshape((-1,) + out.shape[-2:])
        res = [lay.mat_to_mol(m) for m in flat]
        return np.stack(res).reshape(out.shape[:-2] + (nmo, nmo)) if res else \
            np.zeros(out.shape[:-2] + (nmo, nmo))

    # ------------------------------------------------------------- matrix
    def build_int(self) -> np.ndarray:
        """Full ECP matrix in the internal cartesian AO basis."""
        nao = self.layout.nao_int
        V = np.zeros((nao, nao))
        chunks = self._chunks()
        blocks = self._run([(c, (0, 0, 0, 0)) for c in chunks])
        self._note(chunks, len(chunks))
        for (ci, cj, icen, si, sj), blk in zip(chunks, blocks):
            self._scatter(V, ci, cj, si, sj, blk, blk.transpose(0, 2, 1))
        return V

    def build(self) -> np.ndarray:
        """Full ECP matrix in the molecular AO basis."""
        return self.layout.mat_to_mol(self.build_int())

    def build_ipip(self, kind: str = "ipipv") -> np.ndarray:
        """Second-derivative ECP matrices per ECP atom: (necp, 9, nao, nao).

        kind='ipipv': <d^2/dA_d dA_e phi_i | U_k | phi_j> (both on bra);
        kind='ipvip': <d/dA_d phi_i | U_k | d/dB_e phi_j>.
        Rows are flattened (d, e) -> 3*d + e.  Reference counterpart:
        get_ecp_ipip (JoltQC jqc/backend/ecp.py:1141)."""
        if kind not in ("ipipv", "ipvip"):
            raise ValueError(kind)
        nao = self.layout.nao_int
        atoms, slot = self._ecp_atoms()
        out = np.zeros((len(atoms), 9, nao, nao))
        chunks = self._chunks()
        jobs, plan = [], []
        for c in chunks:
            ci, cj, icen, si, sj = c
            la, lb = self.classes[ci].l, self.classes[cj].l
            swapped = (cj, ci, icen, sj, si)
            if kind == "ipipv":
                # mirror (j, i) entry: <dd phi_j|U|phi_i> -- the swapped
                # evaluation already has rows = j-components
                ev, ev_sw = _deriv2_aa_evals(la), _deriv2_aa_evals(lb)
            else:
                # mirrored pair (j, i): <di phi_j | U | de phi_i>, the
                # transpose of this pair's blocks
                ev, ev_sw = _deriv_ab_evals(la, lb), []
            jobs += [(c, e) for e in ev] + [(swapped, e) for e in ev_sw]
            plan.append((len(ev), len(ev_sw)))
        vals = self._run(jobs)
        self._note(chunks, len(jobs))
        pos = 0
        for (ci, cj, icen, si, sj), (n, n_sw) in zip(chunks, plan):
            la, lb = self.classes[ci].l, self.classes[cj].l
            v, v_sw = vals[pos:pos + n], vals[pos + n:pos + n + n_sw]
            pos += n + n_sw
            if kind == "ipipv":
                dd = _deriv2_aa_combine(la, v)
                dd_swap = _deriv2_aa_combine(lb, v_sw)
            else:
                dd = _deriv_ab_combine(la, lb, v)
                dd_swap = dd.transpose(1, 0, 2, 4, 3)
            T = len(si)
            k = slot[self._centers[icen][5]]
            self._scatter(out[k], ci, cj, si, sj,
                          dd.reshape((9, T) + dd.shape[3:]),
                          dd_swap.reshape((9, T) + dd_swap.shape[3:]))
        return self._to_mol(out)

    # --------------------------------------------------------- derivatives
    def _deriv_chunks(self):
        """Per-chunk derivative data for gradient/ip assembly:
        [(ci, cj, atomC, si, sj, dA, dB)] where dA/dB are (3, B, nfa, nfb)
        derivatives w.r.t. the bra/ket shell centers."""
        chunks = self._chunks()
        jobs = []
        for c in chunks:
            ci, cj, icen, si, sj = c
            jobs += [(c, e) for e in _deriv_a_evals(self.classes[ci].l)]
            # ket derivative by operator symmetry: swap sides, transpose
            jobs += [((cj, ci, icen, sj, si), e)
                     for e in _deriv_a_evals(self.classes[cj].l)]
        vals = self._run(jobs)
        self._note(chunks, len(jobs))
        out, pos = [], 0
        for ci, cj, icen, si, sj in chunks:
            la, lb = self.classes[ci].l, self.classes[cj].l
            na, nb = len(_deriv_a_evals(la)), len(_deriv_a_evals(lb))
            dA = _deriv_a_combine(la, vals[pos:pos + na])
            dB = _deriv_a_combine(lb, vals[pos + na:pos + na + nb])
            pos += na + nb
            out.append((ci, cj, self._centers[icen][5], si, sj, dA,
                        dB.transpose(0, 1, 3, 2)))
        return out

    def build_ip(self) -> np.ndarray:
        """Bra-derivative ECP matrices per ECP atom: (necp, 3, nao, nao).

        ip[k, d] = <d/dA_d phi_i | U_k | phi_j> (derivative on the bra
        shell center A).  Reference counterpart: get_ecp_ip
        (JoltQC jqc/backend/ecp.py:953, ECP_ATOM_ID slots)."""
        nao = self.layout.nao_int
        atoms, slot = self._ecp_atoms()
        out = np.zeros((len(atoms), 3, nao, nao))
        for ci, cj, atomC, si, sj, dA, dB in self._deriv_chunks():
            # mirrored pair (j, i): its bra derivative is dB^T
            self._scatter(out[slot[atomC]], ci, cj, si, sj, dA,
                          dB.transpose(0, 1, 3, 2))
        return self._to_mol(out)

    def gradient(self, dm_mol) -> np.ndarray:
        """Nuclear gradient of E_ecp = sum_ij dm_ij V_ij: (natm, 3).

        dm must be symmetric (an SCF density).  Uses translation
        invariance dV/dC = -(dV/dA + dV/dB) for the ECP-center term;
        w = 2 off the shell diagonal."""
        dm_int = self.layout.dm_to_internal(np.asarray(dm_mol, np.float64))
        atom_of = np.array([sh.atom_idx for sh in self.mol.shells], np.int64)
        grad = np.zeros((self.mol.natm, 3))
        for ci, cj, atomC, si, sj, dA, dB in self._deriv_chunks():
            c1, c2 = self.classes[ci], self.classes[cj]
            nfa, nfb = dA.shape[2], dA.shape[3]
            rows = c1.ao[si].astype(np.int64)[:, None, None] + np.arange(nfa)[:, None]
            cols = c2.ao[sj].astype(np.int64)[:, None, None] + np.arange(nfb)
            blk_dm = dm_int[rows, cols]  # (B, nfa, nfb)
            w = np.where((ci == cj) & (si == sj), 1.0, 2.0)[:, None]
            ga = w * np.einsum("dtij,tij->td", dA, blk_dm)
            gb = w * np.einsum("dtij,tij->td", dB, blk_dm)
            np.add.at(grad, atom_of[c1.shell_ids[si]], ga)
            np.add.at(grad, atom_of[c2.shell_ids[sj]], gb)
            grad[atomC] -= (ga + gb).sum(0)
        return grad


__all__ = ["ECPEngine"]
