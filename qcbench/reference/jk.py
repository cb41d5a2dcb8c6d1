"""Coulomb and exchange matrices J, K of one density in float64: every
shell quartet whose Schwarz-times-density bound exceeds a threshold, its
contracted ERI block by ``eri.eri_plain``, contracted with the density
and added into J and K.  The same screened quartet enumeration gives the
work counts of the roofline readers (``quartet_counts``).

Shells are grouped into classes by (l, number of primitives); a pair
(i, j) with i >= j (shell order) belongs to the pair group of its two
classes; each unordered pair of pairs is one quartet with degeneracy
n_q (2 for i != j, 2 for k != l, 2 for distinct pairs), entering J' and
K' with weights n_q/4 and n_q/8, and J = J' + J'^T, K = K' + K'^T.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from .basis import nf_cart
from .eri import eri_plain

# elements of one chunk's ERI blocks
CHUNK_ELEMS = 1 << 24


class PairGroup:
    """Shell pairs (i >= j) whose shells lie in classes (ci, cj)."""

    def __init__(self, ci, cj, i, j, dev):
        self.ci, self.cj = ci, cj
        self.i = torch.as_tensor(np.asarray(i, np.int64), device=dev)
        self.j = torch.as_tensor(np.asarray(j, np.int64), device=dev)
        self.q = None  # (P,) log sqrt max |(ij|ij)|


class Shells:
    """Device tables of a RefMolecule's shells, classes and pair groups."""

    def __init__(self, mol, device):
        dev = self.dev = torch.device(device)
        self.mol = mol
        keys = sorted({(sh.l, sh.nprim) for sh in mol.shells})
        self.classes = keys
        cls_of = [keys.index((sh.l, sh.nprim)) for sh in mol.shells]
        self.cls_of = np.array(cls_of)
        self.l = np.array([sh.l for sh in mol.shells])
        f64 = dict(dtype=torch.float64, device=dev)
        n = len(mol.shells)
        npmax = max(sh.nprim for sh in mol.shells)
        coord = np.array([sh.coord for sh in mol.shells])
        exps = np.ones((n, npmax))
        coefs = np.zeros((n, npmax))
        for k, sh in enumerate(mol.shells):
            exps[k, :sh.nprim] = sh.exps
            coefs[k, :sh.nprim] = sh.coeffs
        self.coord = torch.as_tensor(coord, **f64)
        self.exps = torch.as_tensor(exps, **f64)
        self.coefs = torch.as_tensor(coefs, **f64)
        self.ao = torch.as_tensor(mol.ao_cart[:-1], device=dev)
        groups = defaultdict(lambda: ([], []))
        for i in range(n):
            for j in range(i + 1):
                g = groups[(cls_of[i], cls_of[j])]
                g[0].append(i)
                g[1].append(j)
        self.groups = [PairGroup(ci, cj, i, j, dev)
                       for (ci, cj), (i, j) in sorted(groups.items())]

    def quartet(self, sh4):
        """eri_plain's inputs for (T,) shell indices at the four positions."""
        out = {}
        for x, s in zip("abcd", sh4):
            npr = self.classes[self.cls_of[int(s[0])]][1]
            out[f"coord_{x}"] = self.coord[s]
            out[f"exps_{x}"] = self.exps[s, :npr]
            out[f"coefs_{x}"] = self.coefs[s, :npr]
        return out

    def ls_nprims(self, g, h):
        c = [self.classes[k] for k in (g.ci, g.cj, h.ci, h.cj)]
        return tuple(x[0] for x in c), tuple(x[1] for x in c)

    def schwarz(self):
        """q of every pair group: log sqrt max over components of the
        diagonal |(ij|ij)|, float64."""
        for g in self.groups:
            if g.q is not None:
                continue
            ls, nprims = self.ls_nprims(g, g)
            nf = nf_cart(ls[0]) * nf_cart(ls[1])
            T = max(1, CHUNK_ELEMS // (nf * nf))
            q = []
            for s in range(0, len(g.i), T):
                i, j = g.i[s:s + T], g.j[s:s + T]
                G = eri_plain(ls, nprims, self.quartet((i, j, i, j)))
                d = torch.diagonal(G, dim1=1, dim2=2).abs().amax(1)
                q.append(0.5 * torch.log(torch.clamp(d, min=1e-300)))
            g.q = torch.cat(q)
        return self

    def dm_log(self, dm_cart):
        """(nsh, nsh) log of the shell-block max |D|."""
        starts = self.mol.ao_cart[:-1]
        blk = np.maximum.reduceat(np.abs(dm_cart), starts, axis=0)
        blk = np.maximum.reduceat(blk, starts, axis=1)
        return torch.log(torch.clamp(torch.as_tensor(
            blk, dtype=torch.float64, device=self.dev), min=1e-300))

    def quartets(self, dlog, log_thresh):
        """Yield (g, h, p, q, bound): pair groups g >= h (list order) and
        the indices of their pairs whose quartet's log bound
        q_p + q_q + max of the six shell-block log |D| exceeds
        ``log_thresh``; for g == h only p >= q."""
        self.schwarz()
        for a, g in enumerate(self.groups):
            for h in self.groups[:a + 1]:
                qq = g.q[:, None] + h.q[None, :]
                cand = torch.nonzero(qq + dlog.max() > log_thresh)
                if a == self.groups.index(h):
                    cand = cand[cand[:, 0] >= cand[:, 1]]
                if not len(cand):
                    continue
                p, q = cand[:, 0], cand[:, 1]
                i, j, k, l = g.i[p], g.j[p], h.i[q], h.j[q]
                dmx = torch.stack([dlog[i, j], dlog[k, l], dlog[i, k],
                                   dlog[i, l], dlog[j, k], dlog[j, l]]).amax(0)
                bound = qq[p, q] + dmx
                keep = bound > log_thresh
                if bool(keep.any()):
                    yield g, h, p[keep], q[keep], bound[keep]


def quartet_counts(mol, dm_sph, cutoff_fp32, cutoff_fp64, device):
    """{(ls, nprims, tier): (quartets, primitive quartets)} of the quartets
    whose Schwarz-times-density bound exceeds cutoff_fp32, with tier
    'fp64' where it exceeds cutoff_fp64, else 'f32'."""
    sh = Shells(mol, device)
    dlog = sh.dm_log(mol.P @ dm_sph @ mol.P.T)
    out = defaultdict(lambda: [0, 0])
    for g, h, p, q, bound in sh.quartets(dlog, math.log(cutoff_fp32)):
        ls, nprims = sh.ls_nprims(g, h)
        n64 = int((bound > math.log(cutoff_fp64)).sum())
        for tier, n in (("fp64", n64), ("f32", len(p) - n64)):
            if n:
                out[(ls, nprims, tier)][0] += n
                out[(ls, nprims, tier)][1] += n * math.prod(nprims)
    return {k: tuple(v) for k, v in out.items()}


def get_jk(mol, dm_sph, device, thresh=1e-15, shells=None):
    """(J, K) of the spherical density dm_sph, float64 numpy."""
    sh = shells or Shells(mol, device)
    dev = sh.dev
    dm_cart = mol.P @ dm_sph @ mol.P.T
    D = torch.as_tensor(dm_cart, dtype=torch.float64, device=dev)
    n = mol.nao_cart
    J = torch.zeros(n * n, dtype=torch.float64, device=dev)
    K = torch.zeros(n * n, dtype=torch.float64, device=dev)
    dlog = sh.dm_log(dm_cart)
    for g, h, p, q, _ in sh.quartets(dlog, math.log(thresh)):
        ls, nprims = sh.ls_nprims(g, h)
        nfs = [nf_cart(x) for x in ls]
        ar = [torch.arange(f, device=dev) for f in nfs]
        T = max(1, CHUNK_ELEMS // math.prod(nfs))
        for s in range(0, len(p), T):
            pp, qq = p[s:s + T], q[s:s + T]
            i, j, k, l = g.i[pp], g.j[pp], h.i[qq], h.j[qq]
            G = eri_plain(ls, nprims, sh.quartet((i, j, k, l)))
            G = G.view(-1, *nfs)
            deg = ((1.0 + (i != j).double()) * (1.0 + (k != l).double())
                   * (1.0 + ((i != k) | (j != l)).double()))
            o = [sh.ao[x][:, None] + ar[m][None] for m, x in
                 enumerate((i, j, k, l))]

            def blk(x, y):
                return D[o[x][:, :, None], o[y][:, None, :]]

            def add(M, x, y, v):
                idx = o[x][:, :, None] * n + o[y][:, None, :]
                M.index_add_(0, idx.reshape(-1), v.reshape(-1))

            wj = (deg / 4.0)[:, None, None]
            wk = (deg / 8.0)[:, None, None]
            add(J, 0, 1, wj * torch.einsum("tabcd,tcd->tab", G, blk(2, 3)))
            add(J, 2, 3, wj * torch.einsum("tabcd,tab->tcd", G, blk(0, 1)))
            add(K, 0, 2, wk * torch.einsum("tabcd,tbd->tac", G, blk(1, 3)))
            add(K, 1, 2, wk * torch.einsum("tabcd,tad->tbc", G, blk(0, 3)))
            add(K, 0, 3, wk * torch.einsum("tabcd,tbc->tad", G, blk(1, 2)))
            add(K, 1, 3, wk * torch.einsum("tabcd,tac->tbd", G, blk(0, 2)))
    J = J.view(n, n)
    K = K.view(n, n)
    P = torch.as_tensor(mol.P, dtype=torch.float64, device=dev)
    J = P.T @ (J + J.T) @ P
    K = P.T @ (K + K.T) @ P
    return J.cpu().numpy(), K.cpu().numpy()
