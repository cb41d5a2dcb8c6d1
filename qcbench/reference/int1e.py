"""One-electron integrals (overlap, kinetic, nuclear attraction) in plain
PyTorch float64, by McMurchie-Davidson on every shell pair, and the
core-Hamiltonian guess density built from them."""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from .basis import cart_components
from .eri import boys, e_rows, e_table, make_pair_data, r_table


def _pair_groups(mol):
    """{(li, lj, npi, npj): [(i, j), ...]} over every ordered shell pair."""
    groups = defaultdict(list)
    for i, si in enumerate(mol.shells):
        for j, sj in enumerate(mol.shells):
            groups[(si.l, sj.l, si.nprim, sj.nprim)].append((i, j))
    return groups


def _comp_index(l, dev):
    return torch.as_tensor(cart_components(l), device=dev)  # (nf, 3)


def one_electron(mol, device):
    """(S, T, V) in the spherical AO basis, float64 numpy."""
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    n = mol.nao_cart
    mats = {k: torch.zeros((n, n), **f64) for k in "STV"}
    atoms = torch.as_tensor(mol.coords, **f64)
    zs = mol.charges
    for (li, lj, npi, npj), pairs in _pair_groups(mol).items():
        ii = [i for i, _ in pairs]
        jj = [j for _, j in pairs]
        sh = mol.shells

        def stack(attr, idx):
            return torch.as_tensor(np.array([getattr(sh[k], attr)
                                             for k in idx]), **f64)

        A, B = stack("coord", ii), stack("coord", jj)          # (P, 3)
        ea, eb = stack("exps", ii), stack("exps", jj)          # (P, np)
        ca, cb = stack("coeffs", ii), stack("coeffs", jj)
        Pn = len(pairs)
        a = ea[:, :, None].expand(Pn, npi, npj).reshape(Pn, -1)
        b = eb[:, None, :].expand(Pn, npi, npj).reshape(Pn, -1)
        c = (ca[:, :, None] * cb[:, None, :]).reshape(Pn, -1)
        pd = make_pair_data(A[:, None, :], B[:, None, :], a, b, c)
        p = pd["p"]
        # 1-D overlaps with j up to lj + 2 (kinetic energy)
        E = e_table(li, lj + 2, 0.5 / p, pd["xpa"], pd["xpb"], pd["epref"])
        S1 = E[..., 0]                                  # (P, np, 3, li+1, lj+3)
        ca_, cb_ = _comp_index(li, dev), _comp_index(lj, dev)
        bb = b[..., None]

        def s1d(d, i, j):
            return S1[:, :, d][..., i, j]               # (P, np, nfa, nfb)

        Sd, Td = [], []
        for d in range(3):
            i = ca_[:, d][:, None].expand(-1, len(cb_))
            j = cb_[:, d][None, :].expand(len(ca_), -1)
            s = s1d(d, i, j)
            t = (-2.0 * bb[..., None] ** 2 * s1d(d, i, j + 2)
                 + bb[..., None] * (2 * j + 1) * s)
            jm = torch.clamp(j - 2, min=0)
            t = t - 0.5 * (j * (j - 1)) * s1d(d, i, jm)
            Sd.append(s)
            Td.append(t)
        pref = (math.pi / p) ** 1.5 * c
        S = Sd[0] * Sd[1] * Sd[2]
        T = Td[0] * Sd[1] * Sd[2] + Sd[0] * Td[1] * Sd[2] + Sd[0] * Sd[1] * Td[2]
        blocks = {"S": (S * pref[..., None, None]).sum(1),
                  "T": (T * pref[..., None, None]).sum(1)}
        # nuclear attraction: -Z (2 pi / p) sum_tuv E_tuv R_tuv(p, P - C)
        L = li + lj
        rows = e_rows(li, lj, e_table(li, lj, 0.5 / p, pd["xpa"], pd["xpb"],
                                      pd["epref"]))   # (P, np, nf, NT)
        V = torch.zeros_like(blocks["S"])
        for ia in range(len(zs)):
            PC = pd["P"] - atoms[ia]
            fv = boys(L, p * (PC * PC).sum(-1))
            R = r_table(L, p, PC, fv)                   # (P, np, NT)
            v = (rows * R[..., None, :]).sum(-1)        # (P, np, nf)
            V -= zs[ia] * ((2.0 * math.pi / p * c)[..., None] * v).sum(1) \
                .reshape(V.shape)
        blocks["V"] = V
        oi = torch.as_tensor(mol.ao_cart[ii], device=dev)
        oj = torch.as_tensor(mol.ao_cart[jj], device=dev)
        r = (oi[:, None, None] + torch.arange(len(ca_), device=dev)[:, None])
        q = (oj[:, None, None] + torch.arange(len(cb_), device=dev)[None, :])
        for k, blk in blocks.items():
            mats[k][r.expand_as(blk), q.expand_as(blk)] = blk
    Pm = torch.as_tensor(mol.P, **f64)
    return tuple((Pm.T @ mats[k] @ Pm).cpu().numpy() for k in "STV")


def core_guess_density(mol, device):
    """2 C_occ C_occ^T of the core Hamiltonian's generalised eigenproblem
    H C = S C e, in the spherical AO basis (float64 numpy)."""
    from scipy.linalg import eigh

    S, T, V = one_electron(mol, device)
    _, C = eigh(T + V, S)
    nocc = mol.nelectron // 2
    return 2.0 * C[:, :nocc] @ C[:, :nocc].T
