"""One-electron integrals in float64 PyTorch: overlap, kinetic, nuclear
attraction.

Port of ``joltqc_tpu/scf/int1e.py`` (which is XLA in the JAX package,
not a Pallas kernel), with the same McMurchie-Davidson formulas:
  S_ij = cc (pi/p)^{3/2} Ex(ix,jx,0) Ey(iy,jy,0) Ez(iz,jz,0)
  T_ij = cc (pi/p)^{3/2} sum_d t1d(d) prod_{d' != d} E(d')(0),
         t1d(i,j) = -2 b^2 E(i,j+2,0) + b(2j+1) E(i,j,0)
                    - j(j-1)/2 E(i,j-2,0)          (b = ket exponent)
  V_ij = -cc (2 pi/p) sum_C Z_C sum_tuv Ex(t) Ey(u) Ez(v) R_tuv(p, P-C)
vectorised over the shell pairs of each pair class (and over atoms for
V).  Blocks are placed densely: each pair class fills its own block of an
extended matrix with one row range per shell class (every position is
written once, so no float scatter-add), and the 0/1 fold R^T E R merges
the segments of split contractions, as the J/K engine does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..mol.layout import BasisLayout
from ..ops.boys import boys
from ..ops.cuda import resolve_device
from ..ops.harmonics import cart_components
from ..ops.md import e_rows, e_table, make_pair_data, r_table
from .tasks import build_pair_classes, build_shell_classes


def _nf(l):
    return len(cart_components(l))


class Int1eEngine:
    """Class-batched S/T/V builder over a BasisLayout (float64)."""

    def __init__(self, layout: BasisLayout, device=None):
        self.layout = layout
        self.device = resolve_device(device)
        self.nao = layout.nao_int
        self.classes = build_shell_classes(layout, merge_nprim=True)
        self.pair_classes = build_pair_classes(self.classes)
        # one row range per class, pad shell included (its pairs are
        # zero and the fold drops its rows)
        offs, n = [], 0
        for c in self.classes:
            offs.append(n)
            n += c.nshell * _nf(c.l)
        self._offs, self._ne = offs, n
        mol = layout.mol
        self._atoms = torch.as_tensor(np.asarray(mol.coords, np.float64),
                                      device=self.device)
        self._z = torch.as_tensor(np.asarray(mol.atom_charges_eff,
                                             np.float64), device=self.device)

    def _fold_matrix(self):
        R = np.zeros((self._ne, self.nao))
        for c, off in zip(self.classes, self._offs):
            nf = _nf(c.l)
            ns = c.nshell - 1
            rows = (off + np.arange(ns)[:, None] * nf + np.arange(nf)).ravel()
            cols = (c.ao[:ns, None] + np.arange(nf)).ravel()
            R[rows, cols] = 1.0
        return torch.as_tensor(R, device=self.device)

    def _pair_blocks(self, pc):
        """(S, T, V) blocks (P, nfi, nfj) of one pair class, weighted."""
        dev = self.device
        ci, cj = self.classes[pc.ci], self.classes[pc.cj]
        li, lj = ci.l, cj.l
        nfi, nfj = _nf(li), _nf(lj)
        P = pc.npair
        ii = torch.as_tensor(pc.i_loc, device=dev).long()
        jj = torch.as_tensor(pc.j_loc, device=dev).long()

        def t64(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        A = t64(ci.coords)[ii]
        B = t64(cj.coords)[jj]
        ea, ca = t64(ci.exps)[ii], t64(ci.coefs)[ii]
        eb, cb = t64(cj.exps)[jj], t64(cj.coefs)[jj]
        comps_i = cart_components(li)
        comps_j = cart_components(lj)
        fi_idx = torch.as_tensor(comps_i, device=dev)  # (nfi, 3)
        fj_idx = torch.as_tensor(comps_j, device=dev)
        S = torch.zeros((P, nfi, nfj), dtype=torch.float64, device=dev)
        Tk = torch.zeros_like(S)
        V = torch.zeros_like(S)
        natm = self._atoms.shape[0]
        L = li + lj
        for pa in range(ci.nprim):
            for pb in range(cj.nprim):
                a, b = ea[:, pa], eb[:, pb]
                cc = ca[:, pa] * cb[:, pb]
                pd = make_pair_data(A, B, a, b, cc)
                p = pd["p"]
                E = e_table(li, lj + 2, 0.5 / p, pd["xpa"], pd["xpb"],
                            pd["epref"])  # (P, 3, li+1, lj+3, n)
                pref = cc * (math.pi / p) ** 1.5
                # E(d)(i, j, 0) for every (component pair, dimension)
                ix = fi_idx[:, None, :].expand(nfi, nfj, 3)
                jx = fj_idx[None, :, :].expand(nfi, nfj, 3)
                d3 = torch.arange(3, device=dev).expand(nfi, nfj, 3)
                e0 = E[:, d3, ix, jx, 0]  # (P, nfi, nfj, 3)
                e2 = E[:, d3, ix, jx + 2, 0]
                em = E[:, d3, ix, (jx - 2).clamp(min=0), 0]
                jf = jx.to(torch.float64)
                bb = b[:, None, None, None]
                t1 = (-2.0 * bb * bb * e2 + bb * (2.0 * jf + 1.0) * e0
                      - 0.5 * jf * (jf - 1.0) * em * (jx >= 2))
                prod0 = e0.prod(-1)
                S += pref[:, None, None] * prod0
                tsum = (t1[..., 0] * e0[..., 1] * e0[..., 2]
                        + e0[..., 0] * t1[..., 1] * e0[..., 2]
                        + e0[..., 0] * e0[..., 1] * t1[..., 2])
                Tk += pref[:, None, None] * tsum
                # nuclear attraction: all atoms in one batch
                rows = e_rows(li, lj, E[:, :, :, : lj + 1, : L + 1]
                              .contiguous())  # (P, nfi*nfj, NT)
                PC = (pd["P"][None, :, :] - self._atoms[:, None, :]).reshape(
                    -1, 3)
                pp = p.repeat(natm)
                Rt = r_table(L, pp, PC, boys(L, pp * (PC * PC).sum(-1)))
                RZ = (Rt.view(natm, P, -1) * self._z[:, None, None]).sum(0)
                vv = torch.bmm(rows, RZ[:, :, None])[:, :, 0]
                V += (cc * (-2.0 * math.pi) / p)[:, None, None] * vv.view(
                    P, nfi, nfj)
        w = torch.as_tensor(np.where(pc.diag, 0.5, 1.0), device=dev)
        return tuple(x * w[:, None, None] for x in (S, Tk, V))

    def stv(self):
        """(S, T, V) in the molecular AO basis, numpy float64."""
        dev = self.device
        ne = self._ne
        mats = [torch.zeros((ne, ne), dtype=torch.float64, device=dev)
                for _ in range(3)]
        for pc in self.pair_classes:
            ci, cj = self.classes[pc.ci], self.classes[pc.cj]
            nfi, nfj = _nf(ci.l), _nf(cj.l)
            rows = (self._offs[pc.ci]
                    + torch.as_tensor(pc.i_loc, device=dev).long()[:, None]
                    * nfi + torch.arange(nfi, device=dev))  # (P, nfi)
            cols = (self._offs[pc.cj]
                    + torch.as_tensor(pc.j_loc, device=dev).long()[:, None]
                    * nfj + torch.arange(nfj, device=dev))
            r = rows[:, :, None].expand(-1, nfi, nfj)
            c = cols[:, None, :].expand(-1, nfi, nfj)
            for m, blk in zip(mats, self._pair_blocks(pc)):
                m[r, c] = blk
        R = self._fold_matrix()
        out = []
        for m in mats:
            x = R.T @ m @ R
            out.append(self.layout.mat_to_mol((x + x.T).cpu().numpy()))
        return tuple(out)

    def overlap(self):
        return self.stv()[0]

    def kinetic(self):
        return self.stv()[1]

    def nuclear(self):
        return self.stv()[2]


__all__ = ["Int1eEngine"]
