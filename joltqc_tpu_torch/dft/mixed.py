"""Mixed float32/float64 precision for grid numerical integration.

Port of ``joltqc_tpu/dft/mixed.py``.  The routing is the JAX package's:

 - the float32 bulk runs the dense path (dft/numint.py) or the screened
   path (dft/screening.py);
 - the AO shell pairs whose magnitude bound exceeds ``cutoff_fp64``
   (``heavy_shell_pairs``, with the same pairing weights) go to a second,
   more precise tier;
 - rho combines the tiers EXCLUSIVELY (the density matrix is split
   dm = dm_light + dm_heavy; the bulk sees only dm_light);
 - the V_xc matrix combines by ENTRY OVERWRITE (heavy entries take the
   precise value, light ones keep the float32-accumulated value).

The JAX package evaluates its precise tier in compensated double-float
(DF64) over a padded list of AO *pairs*, chunked to fit TPU memory.  An
H100 has native float64, so here the tier is a plain float64 pass: the AO
values of every shell that occurs in a heavy pair are evaluated in
float64 on the grid, rho rows come from dense float64 products of those
columns with the (symmetrised) dm_heavy restricted to them, and V_xc from
the float64 ``half + half.T`` over those columns, of which only the heavy
entries are written.  This is the same function as the JAX package's in
exact arithmetic, and the same to float64 rounding.

An empty block selection returns the bulk's zero rows (rho) or zero
matrix (vxc) with no heavy pass, whatever the dtype of the empty array;
the JAX package returns the same for an integer-typed one and raises
IndexError for a float-typed one (``np.array([])``).

Pair selection uses analytic global AO bounds
   max_r |c r^l e^{-e r^2}| = |c| (l/2e)^{l/2} e^{-l/2}
per shell (plus the dm block / integrated |wv| factor).
"""

from __future__ import annotations

import numpy as np
import torch

from .numint import (
    NumInt,
    _ao_groups,
    _blocked,
    _chunk_blocks,
    _family_arg,
    _group_columns,
    _group_data,
    _rho_rows,
    _select_blocks,
    _vxc_blocks,
    _wv_blocks,
    eval_rho_all,
    eval_vxc_mat,
)


def shell_value_bound(l: int, exps, coefs) -> float:
    """Global bound on |contracted radial x r^l| over all r."""
    exps = np.asarray(exps, float)
    coefs = np.asarray(coefs, float)
    if l == 0:
        per = np.abs(coefs)
    else:
        per = np.abs(coefs) * (l / (2.0 * exps)) ** (l / 2.0) * np.exp(-l / 2.0)
    return float(per.sum())


def _ao_bounds(layout):
    """log global |AO| bound per shell (nbas,)."""
    out = np.empty(layout.nbas)
    for i, sh in enumerate(layout.mol.shells):
        out[i] = np.log(max(shell_value_bound(sh.l, sh.exps, sh.coeffs), 1e-300))
    return out


def heavy_shell_pairs(layout, weight_log, cutoff: float):
    """Shell pairs (I >= J) with aoB_I + aoB_J + weight_log_IJ > log cut.

    ``weight_log``: (nbas, nbas) log-magnitude of the pairing weight
    (log |dm| block bound for rho; log integrated |wv| for vxc)."""
    aoB = _ao_bounds(layout)
    bound = aoB[:, None] + aoB[None, :] + weight_log
    ii, jj = np.nonzero(np.tril(bound > np.log(cutoff)))
    return ii.astype(np.int32), jj.astype(np.int32)


def _heavy_mask(layout, ish, jsh):
    """(nao, nao) bool: the AO entries of the heavy shell pairs, both
    orders (a shell-level mask gathered to AO entries)."""
    shells = np.zeros((layout.nbas, layout.nbas), dtype=bool)
    shells[ish, jsh] = True
    shells |= shells.T
    owner = np.repeat(np.arange(layout.nbas), np.diff(layout.ao_loc_int))
    return shells[np.ix_(owner, owner)]


class _HeavyTier:
    """float64 AO values of the shells that occur in heavy pairs."""

    def __init__(self, ni: NumInt, ish, jsh):
        gdata = _group_data(ni.layout, np.union1d(ish, jsh))
        self.ni = ni
        self.cols = _group_columns(gdata)  # internal AO index per column
        self.tables = ni.tables(torch.float64, gdata)
        self.width = max([len(self.cols)] + [e.size for _, _, e, _, _ in gdata])

    def _chunks(self, blocks, deriv):
        """(start, AO slabs (nb, G, nh)) per chunk of grid blocks."""
        dev = self.ni.device
        grid = torch.as_tensor(blocks, dtype=torch.float64, device=dev)
        nb = _chunk_blocks(blocks.shape[1], self.width)
        for b0 in range(0, len(blocks), nb):
            yield b0, _ao_groups(self.tables, grid[b0:b0 + nb], deriv)

    def rho(self, blocks, dm_heavy, family):
        """float64 rho rows (nblk, rows, B) numpy of dm_heavy."""
        deriv = 0 if family == "lda" else 1
        rows = {"lda": 1, "gga": 4, "mgga": 5}[family]
        sub = dm_heavy[np.ix_(self.cols, self.cols)]
        dm = torch.as_tensor(0.5 * (sub + sub.T), dtype=torch.float64,
                             device=self.ni.device)
        out = torch.empty((len(blocks), rows, blocks.shape[1]),
                          dtype=torch.float64, device=self.ni.device)
        for b0, aos in self._chunks(blocks, deriv):
            out[b0:b0 + len(aos[0])] = _rho_rows(aos, dm, family)
        return out.cpu().numpy()

    def vxc(self, blocks, wv_blocks, family):
        """float64 V_xc (nh, nh) numpy over the heavy columns."""
        deriv = 0 if family == "lda" else 1
        nh = len(self.cols)
        wv = torch.as_tensor(wv_blocks, dtype=torch.float64,
                             device=self.ni.device)
        acc = torch.zeros((nh, nh), dtype=torch.float64, device=self.ni.device)
        for b0, aos in self._chunks(blocks, deriv):
            acc += _vxc_blocks(aos, wv[b0:b0 + len(aos[0])], family).sum(dim=0)
        return acc.cpu().numpy()


def eval_rho_mixed(ni: NumInt, grids, dm_int, family, layout,
                   cutoff_fp64: float = 1e-6, block_sel=None, bulk=None):
    """rho rows with float32 bulk + float64 heavy-pair tier.

    ``bulk``: optional float32 bulk evaluator ``bulk(dm, block_sel) ->
    rho`` (defaults to the dense path; the RKS driver passes the screened
    evaluator here so mixed precision composes with AO screening)."""
    family = _family_arg(family)
    if bulk is None:
        def bulk(d, sel):
            return eval_rho_all(ni, grids, d, family, block_sel=sel)

    D = layout.dm_cond(dm_int)
    wlog = np.log(np.maximum(D, 1e-300))
    ish, jsh = heavy_shell_pairs(layout, wlog, cutoff_fp64)
    if len(ish) == 0:
        return bulk(dm_int, block_sel)

    # exclusive split of the density matrix over AO index blocks
    mask = _heavy_mask(layout, ish, jsh)
    rho = bulk(np.where(mask, 0.0, dm_int), block_sel)
    if block_sel is not None and len(block_sel) == 0:
        return rho

    blocks, N = _blocked(grids.coords, ni.block)
    sub = blocks if block_sel is None else _select_blocks(blocks, block_sel)
    heavy = _HeavyTier(ni, ish, jsh).rho(
        sub, np.where(mask, dm_int, 0.0), family)
    rows = heavy.shape[1]
    B = ni.block
    full = np.zeros((rows, len(blocks) * B))
    targets = (np.arange(len(blocks)) if block_sel is None
               else np.asarray(block_sel, np.int64))
    full.reshape(rows, len(blocks), B)[:, targets] = \
        heavy[: len(targets)].transpose(1, 0, 2)
    return rho + full[:, :N]


def eval_vxc_mixed(ni: NumInt, grids, wv, family, layout,
                   cutoff_fp64: float = 1e-6, block_sel=None, bulk=None):
    """V_xc with float32 bulk + float64 overwrite of heavy entries.

    ``bulk``: optional float32 bulk evaluator ``bulk(wv, block_sel) ->
    mat`` (defaults dense; the RKS driver passes the screened evaluator).
    Where every shell pair is heavy the overwrite covers every entry, so
    the bulk is not evaluated (``ni.tier_counts["vxc_bulk_skipped"]``)."""
    family = _family_arg(family)
    if bulk is None:
        def bulk(w, sel):
            return eval_vxc_mat(ni, grids, w, family, block_sel=sel)

    ni.tier_counts["vxc_mixed"] += 1
    # pairing weight: integrated |wv| (the sum the matrix element sees)
    wsum = float(np.sum(np.abs(wv))) + 1e-300
    wlog = np.full((layout.nbas, layout.nbas), np.log(wsum))
    ish, jsh = heavy_shell_pairs(layout, wlog, cutoff_fp64)
    if len(ish) == 0 or (block_sel is not None and len(block_sel) == 0):
        return bulk(wv, block_sel)
    if len(ish) == layout.nbas * (layout.nbas + 1) // 2:
        ni.tier_counts["vxc_bulk_skipped"] += 1
        mat = np.zeros((layout.nao_int, layout.nao_int))
    else:
        mat = bulk(wv, block_sel)

    B = ni.block
    blocks, N = _blocked(grids.coords, B)
    wv_blocks = _wv_blocks(wv[:, :N], len(blocks), B)
    if block_sel is not None:
        sel = np.asarray(block_sel, np.int64)
        sub = _select_blocks(blocks, sel)
        wv_sub = np.zeros((len(sub),) + wv_blocks.shape[1:])
        wv_sub[: len(sel)] = wv_blocks[sel]
        blocks, wv_blocks = sub, wv_sub
    tier = _HeavyTier(ni, ish, jsh)
    vh = tier.vxc(blocks, wv_blocks, family)
    cols = np.ix_(tier.cols, tier.cols)
    heavy = _heavy_mask(layout, ish, jsh)[cols]
    mat[cols] = np.where(heavy, vh, mat[cols])
    return mat


__all__ = [
    "eval_rho_mixed",
    "eval_vxc_mixed",
    "heavy_shell_pairs",
    "shell_value_bound",
]
