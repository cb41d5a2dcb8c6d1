"""Numerical integration: AO values, density and the Vxc matrix.

Port of ``joltqc_tpu/dft/numint.py`` in PyTorch.  The function is the JAX
package's:

 - grid points are processed in blocks (default 1024);
 - AO values of a block are built per angular-momentum group (radial
   contraction times cartesian monomials) into a dense (G, nao) slab;
 - rho and the Vxc matrix are float32 matrix products at full float32
   precision (no TF32: the JAX package runs ``precision=HIGHEST``):
       rho    = sum_j (ao @ dm) * ao
       V_xc  += ao^T @ (W * ao)   (W folds weights and XC potentials)
 - each block's float32 ``half + half.T`` is summed block to block in
   float64 (the JAX package sums it in DF64), so the accumulation adds no
   float32 error.

Where the JAX package runs one ``lax.scan`` over all grid blocks, the port
loops over chunks of blocks, one batched product per chunk, writing into
device buffers that are read back once at the end (no host
synchronisation inside the loop).  The far-away padding (1e3 Bohr) and the
pow2 padding of a block selection are kept, so ``block_sel`` behaves the
same.

Supports LDA (rho), GGA (+grad rho) and meta-GGA (+tau) row families
(1 / 4 / 5 rows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mol.layout import BasisLayout
from ..ops.cuda import check_fp32_matmul, resolve_device
from ..ops.harmonics import cart_components

# elements of one (points x width) slab per chunk of grid blocks: bounds
# the transient memory of a chunk (a few such slabs live at once)
_CHUNK_ELEMS = 1 << 25


def _group_data(layout: BasisLayout, shells=None):
    """Per-l shell arrays (padded to common nprim) + AO column indices,
    for every shell or for the given subset (in layout group order)."""
    mol = layout.mol
    keep = None if shells is None else set(int(s) for s in shells)
    out = []
    for l in layout.ls:
        idx = [int(i) for i in layout.groups[l] if keep is None or int(i) in keep]
        if not idx:
            continue
        pmax = max(mol.shells[i].nprim for i in idx)
        S = len(idx)
        coords = np.zeros((S, 3))
        exps = np.zeros((S, pmax))
        coefs = np.zeros((S, pmax))
        cols = np.zeros(S, np.int32)
        for k, i in enumerate(idx):
            sh = mol.shells[i]
            coords[k] = sh.coord
            exps[k, : sh.nprim] = sh.exps
            coefs[k, : sh.nprim] = sh.coeffs
            cols[k] = layout.ao_loc_int[i]
        out.append((l, coords, exps, coefs, cols))
    return out


def _group_columns(gdata):
    """AO columns of the group-stacked slab, in slab order."""
    cols = []
    for l, _, _, _, starts in gdata:
        nf = len(cart_components(l))
        for c in starts:
            cols.extend(range(int(c), int(c) + nf))
    return np.array(cols, np.int64)


def _ao_group(l, grid, coords, exps, coefs, deriv):
    """One l-group's AO values on grid points.

    grid (..., G, 3); coords (..., S, 3); exps/coefs (..., S, P), the
    leading dims broadcasting.  Returns a tuple of (..., G, S*nf) tensors:
    (ao,) or (ao, dx, dy, dz)."""
    comps = cart_components(l)
    nf = len(comps)
    rel = grid[..., :, None, :] - coords[..., None, :, :]  # (..., G, S, 3)
    r2 = torch.sum(rel * rel, dim=-1)  # (..., G, S)
    ex = torch.exp(-exps[..., None, :, :] * r2[..., None])  # (..., G, S, P)
    rad = torch.sum(coefs[..., None, :, :] * ex, dim=-1)  # (..., G, S)
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    shape = r2.shape[:-1] + (r2.shape[-1] * nf,)

    def mono(lx, ly, lz):
        m = torch.ones_like(r2)
        for v, n in ((x, lx), (y, ly), (z, lz)):
            for _ in range(n):
                m = m * v
        return m

    ao = torch.stack([rad * mono(*c) for c in comps], dim=-1).reshape(shape)
    if deriv == 0:
        return (ao,)

    drad = torch.sum(-2.0 * exps[..., None, :, :] * coefs[..., None, :, :] * ex,
                     dim=-1)  # (..., G, S)
    outs = [ao]
    for d, v in enumerate((x, y, z)):
        grads = []
        for lx, ly, lz in comps:
            g = drad * v * mono(lx, ly, lz)
            n = (lx, ly, lz)[d]
            if n > 0:
                lower = [lx, ly, lz]
                lower[d] -= 1
                g = g + rad * n * mono(*lower)
            grads.append(g)
        outs.append(torch.stack(grads, dim=-1).reshape(shape))
    return tuple(outs)


def _ao_groups(tables, grid, deriv):
    """Group-stacked AO slab(s) of every group of ``tables``."""
    outs = None
    for l, coords, exps, coefs in tables:
        res = _ao_group(l, grid, coords, exps, coefs, deriv)
        outs = res if outs is None else tuple(
            torch.cat([a, b], dim=-1) for a, b in zip(outs, res)
        )
    return outs


def _rho_rows(aos, dm, family):
    """rho rows (..., rows, G) from AO slabs (..., G, W) and dm (..., W, W)."""
    ao = aos[0]
    t = torch.matmul(ao, dm)
    rows = [torch.sum(t * ao, dim=-1)]
    if family != "lda":
        rows += [2.0 * torch.sum(t * aos[1 + d], dim=-1) for d in range(3)]
    if family == "mgga":
        tau = torch.zeros_like(rows[0])
        for d in range(3):
            td = torch.matmul(aos[1 + d], dm)
            tau = tau + torch.sum(td * aos[1 + d], dim=-1)
        rows.append(0.5 * tau)
    return torch.stack(rows, dim=-2)


def _vxc_blocks(aos, wv, family):
    """Per-block V_xc (nb, W, W) from AO slabs (nb, G, W), wv (nb, rows, G)."""
    ao = aos[0]
    mid = ao * (0.5 * wv[:, 0])[..., None]
    if family != "lda":
        for d in range(3):
            mid = mid + aos[1 + d] * wv[:, 1 + d][..., None]
    half = torch.bmm(ao.transpose(1, 2), mid)
    if family == "mgga":
        for d in range(3):
            half = half + torch.bmm(
                aos[1 + d].transpose(1, 2),
                aos[1 + d] * (0.25 * wv[:, 4])[..., None],
            )
    return half + half.transpose(1, 2)


def _chunk_blocks(B, width):
    """Grid blocks per chunk for slabs of ``width`` columns."""
    return max(1, _CHUNK_ELEMS // (B * max(width, 1)))


class NumInt:
    """AO/rho/Vxc evaluator over a BasisLayout (internal cartesian AOs).

    Runs on ``device`` (``cuda`` unless the caller names another)."""

    def __init__(self, layout: BasisLayout, block: int = 1024, device=None):
        self.layout = layout
        self.block = block
        self.device = resolve_device(device)
        self.nao = layout.nao_int
        self.gdata = _group_data(layout)
        # column scatter: the group-stacked slab -> internal AO order
        self.col_perm = np.argsort(_group_columns(self.gdata)).astype(np.int32)
        self._tables = self.tables(torch.float32)
        self._perm_dev = torch.as_tensor(self.col_perm, dtype=torch.long,
                                         device=self.device)
        # widest per-point intermediate: the AO slab or one group's
        # (shells x primitives) exponentials
        self._width = max([self.nao] + [e.size for _, _, e, _, _ in self.gdata])

    def tables(self, dtype, gdata=None):
        """Device tables (l, coords, exps, coefs) of ``gdata`` (default:
        every group) in ``dtype``."""
        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        return [(l, dev(c), dev(e), dev(k))
                for l, c, e, k, _ in (self.gdata if gdata is None else gdata)]

    def _ao_full(self, grid, deriv):
        """AO slab(s) (..., G, nao) in internal AO order, all groups."""
        outs = _ao_groups(self._tables, grid, deriv)
        return tuple(o[..., self._perm_dev] for o in outs)

    # ---------------------------------------------------------------- ao
    def eval_ao_block(self, grid_block, deriv: int = 0):
        """AO (and gradient) values for one grid block, f32 (G, nao)."""
        grid = torch.as_tensor(np.asarray(grid_block), dtype=torch.float32,
                               device=self.device)
        return self._ao_full(grid, deriv)

    # --------------------------------------------------------------- rho
    def _rho(self, blocks, dm, family):
        """rho rows (nblk, rows, B) float64 numpy of the given blocks."""
        check_fp32_matmul(self.device, "numint")
        deriv = 0 if family == "lda" else 1
        rows = {"lda": 1, "gga": 4, "mgga": 5}[family]
        nblk, B = blocks.shape[:2]
        grid = torch.as_tensor(blocks, dtype=torch.float32, device=self.device)
        dm = torch.as_tensor(dm, dtype=torch.float32, device=self.device)
        out = torch.empty((nblk, rows, B), dtype=torch.float32,
                          device=self.device)
        nb = _chunk_blocks(B, self._width)
        for b0 in range(0, nblk, nb):
            aos = self._ao_full(grid[b0:b0 + nb], deriv)
            out[b0:b0 + nb] = _rho_rows(aos, dm, family)
        return out.cpu().double().numpy()

    # --------------------------------------------------------------- vxc
    def _vxc(self, blocks, wv_blocks, family):
        """V_xc (nao, nao) float64 numpy over the given blocks."""
        check_fp32_matmul(self.device, "numint")
        deriv = 0 if family == "lda" else 1
        nblk, B = blocks.shape[:2]
        grid = torch.as_tensor(blocks, dtype=torch.float32, device=self.device)
        wv = torch.as_tensor(wv_blocks, dtype=torch.float32,
                             device=self.device)
        acc = torch.zeros((self.nao, self.nao), dtype=torch.float64,
                          device=self.device)
        nb = _chunk_blocks(B, self._width)
        for b0 in range(0, nblk, nb):
            aos = self._ao_full(grid[b0:b0 + nb], deriv)
            mats = _vxc_blocks(aos, wv[b0:b0 + nb], family)
            acc += mats.double().sum(dim=0)
        return acc.cpu().numpy()


def _family_arg(family):
    if isinstance(family, bool):  # back-compat: gga flag
        return "gga" if family else "lda"
    return family


def _blocked(coords, B):
    """(N,3) -> (nblk, B, 3) with far-away zero-weight padding."""
    N = len(coords)
    npad = (-N) % B
    if npad:
        pad = np.full((npad, 3), 1e3)
        coords = np.concatenate([coords, pad])
    return coords.reshape(-1, B, 3), N


def _select_blocks(blocks, block_sel):
    """Gather a pow2-padded subset of grid blocks (pad = far-away)."""
    nsel = len(block_sel)
    npad = (1 << int(np.ceil(np.log2(max(nsel, 1))))) - nsel
    sub = blocks[np.asarray(block_sel, np.int64)]
    if npad:
        sub = np.concatenate([sub, np.full((npad,) + blocks.shape[1:], 1e3)])
    return sub


def _wv_blocks(wv, nblk, B):
    """Potential rows (rows, N) -> (nblk, rows, B), zero-padded."""
    rows = wv.shape[0]
    wvp = np.zeros((rows, nblk * B))
    wvp[:, : wv.shape[1]] = wv
    return wvp.reshape(rows, nblk, B).transpose(1, 0, 2)


def eval_rho_all(ni: NumInt, grids, dm_int, family, block_sel=None):
    """rho rows on the full padded grid: numpy (1 | 4 | 5, N).

    family: 'lda' | 'gga' | 'mgga' (rows: rho; +grad; +tau).
    ``block_sel`` (sorted int array) restricts evaluation to those grid
    blocks -- the incremental-DFT path evaluates only blocks where the
    delta density is significant; unevaluated blocks return 0."""
    family = _family_arg(family)
    B = ni.block
    blocks, N = _blocked(grids.coords, B)
    if block_sel is not None:
        got = ni._rho(_select_blocks(blocks, block_sel), dm_int, family)
        out = np.zeros((got.shape[1], len(blocks) * B))
        for k, b in enumerate(block_sel):
            out[:, b * B : (b + 1) * B] = got[k]
        return out[:, :N]
    out = ni._rho(blocks, dm_int, family)
    rows = out.shape[1]
    return out.transpose(1, 0, 2).reshape(rows, -1)[:, :N]


def eval_vxc_mat(ni: NumInt, grids, wv, family, block_sel=None):
    """V_xc matrix from potential rows wv (numpy (1 | 4 | 5, N)).

    ``block_sel`` restricts the quadrature to those grid blocks (the
    incremental path passes delta-wv and sums only significant blocks)."""
    family = _family_arg(family)
    B = ni.block
    blocks, N = _blocked(grids.coords, B)
    wv_blocks = _wv_blocks(wv[:, :N], len(blocks), B)
    if block_sel is not None:
        sub = _select_blocks(blocks, block_sel)
        wv_sub = wv_blocks[np.asarray(block_sel, np.int64)]
        npad = len(sub) - len(wv_sub)
        if npad:
            wv_sub = np.concatenate(
                [wv_sub, np.zeros((npad,) + wv_sub.shape[1:])]
            )
        return ni._vxc(sub, wv_sub, family)
    return ni._vxc(blocks, wv_blocks, family)


__all__ = ["NumInt", "eval_rho_all", "eval_vxc_mat"]
