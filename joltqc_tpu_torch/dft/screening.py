"""AO-value screening for grid integration (sparse numint).

Port of ``joltqc_tpu/dft/screening.py``.  ``GridScreening``'s host
tables are the JAX package's numpy code, so its packs are identical:

 - per (grid block, shell): an upper bound on log|AO| from the block's
   bounding box (log cmax + l*log rmax - e_min * dist^2), computed once
   per geometry;
 - blocks keep only significant shells and are bucketed by the padded
   AO width W (power of two); each bucket is one pack of per-group
   shell index lists (``gidx``, -1 = pad) and AO columns (``cols``, nao =
   the dropped scratch column).

The JAX package compiles one scan per pack shape.  Here nothing is
compiled: per chunk of a pack's blocks, shell data is gathered from
per-l-group tables by ``gidx`` (pad rows have zero coefficients, so
padded columns evaluate to exactly 0), the density sub-matrix is
gathered as dm[cols][:, cols], and each block's float32 V_xc sub-block is
added into a float64 accumulator at its (unique) matrix entries, block
after block, so the sum is deterministic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import check_fp32_matmul
from ..ops.harmonics import cart_components
from .numint import (
    NumInt,
    _ao_groups,
    _chunk_blocks,
    _family_arg,
    _rho_rows,
    _vxc_blocks,
)


def _next_pow2(n):
    return 1 << int(np.ceil(np.log2(max(n, 1))))


class GridScreening:
    """Per-block significant-shell structure over a fixed grid."""

    def __init__(self, ni: NumInt, grids, thresh: float = 1e-12):
        self.ni = ni
        B = ni.block
        coords = grids.coords
        N = len(coords)
        npad = (-N) % B
        if npad:
            coords = np.concatenate([coords, np.full((npad, 3), 1e3)])
        blocks = coords.reshape(-1, B, 3)
        self.blocks = blocks
        self.npts = N
        nblk = len(blocks)
        logt = np.log(thresh)

        # block bounding boxes (box-sorted grids -> tight)
        lo = blocks.min(axis=1)  # (nblk, 3)
        hi = blocks.max(axis=1)
        diam = np.linalg.norm(hi - lo, axis=1)  # (nblk,)

        # per group: significant shells per block
        self.group_sig = []  # [(l, [idx arrays per block])]
        sig_per_block = [[] for _ in range(nblk)]
        width = np.zeros(nblk, np.int64)
        for gi, (l, g_coords, g_exps, g_coefs, cols) in enumerate(ni.gdata):
            nf = len(cart_components(l))
            # distance from each shell center to each block AABB
            c = g_coords[None, :, :]  # (1, S, 3)
            d = np.maximum(lo[:, None, :] - c, 0.0) + np.maximum(
                c - hi[:, None, :], 0.0
            )
            dist = np.linalg.norm(d, axis=2)  # (nblk, S)
            rmax = dist + diam[:, None]
            emin = np.where(g_coefs != 0, g_exps, np.inf).min(axis=1)  # (S,)
            cmax = np.abs(g_coefs).max(axis=1)
            bound = (
                np.log(np.maximum(cmax, 1e-300))[None, :]
                + l * np.log(np.maximum(rmax, 1.0))
                - emin[None, :] * dist**2
            )
            keep = bound > logt  # (nblk, S)
            per_block = [np.where(keep[b])[0].astype(np.int32) for b in range(nblk)]
            self.group_sig.append((gi, l, nf, per_block))
            for b in range(nblk):
                sig_per_block[b].append(per_block[b])
                width[b] += len(per_block[b]) * nf

        # bucket blocks by padded total width
        self.buckets = {}
        for b in range(nblk):
            W = _next_pow2(max(int(width[b]), 8))
            self.buckets.setdefault(W, []).append(b)

        # pack per-bucket gather data.  The AO slab is laid out in GROUP
        # SEGMENTS of smax*nf columns each (smax = the bucket-wide max
        # significant count of that group, min 1); the cols array mirrors
        # exactly that layout, padding unused slots with nao (the dropped
        # scratch column).
        self.packed = []
        nao = ni.nao
        for Wkey, blks in sorted(self.buckets.items()):
            nb = len(blks)
            gidx = []
            gmax = []
            for (gi, l, nf, per_block) in self.group_sig:
                smax = max(
                    [len(per_block[b]) for b in blks] + [1]
                )
                gmax.append(smax)
                arr = np.full((nb, smax), -1, np.int32)
                for k, b in enumerate(blks):
                    arr[k, : len(per_block[b])] = per_block[b]
                gidx.append(arr)
            W_used = sum(
                smax * nf
                for smax, (gi, l, nf, pb) in zip(gmax, self.group_sig)
            )
            cols = np.full((nb, W_used), nao, np.int32)
            for k, b in enumerate(blks):
                off = 0
                for smax, (gi, l, nf, per_block) in zip(gmax, self.group_sig):
                    g_cols = ni.gdata[gi][4]
                    for t, s in enumerate(per_block[b]):
                        c0 = int(g_cols[s])
                        cols[k, off + t * nf : off + (t + 1) * nf] = np.arange(
                            c0, c0 + nf
                        )
                    off += smax * nf
            self.packed.append(
                dict(
                    W=W_used,
                    blocks=np.array(blks, np.int64),
                    gidx=gidx,
                    gmax=gmax,
                    cols=cols,
                )
            )

    # ------------------------------------------------------------ stats
    @property
    def fill_fraction(self) -> float:
        """Mean significant-AO fraction across blocks (screening gain)."""
        tot = sum(
            len(p["blocks"]) * p["W"] for p in self.packed
        )
        return tot / (len(self.blocks) * max(self.ni.nao, 1))


def _gather_group_tables(ni: NumInt):
    """Per-group float32 device tables with one trailing zero-coef pad row."""
    dev = ni.device
    out = []
    for (l, coords, exps, coefs, cols) in ni.gdata:
        out.append((
            l,
            torch.as_tensor(np.concatenate([coords, np.zeros((1, 3))]),
                            dtype=torch.float32, device=dev),
            torch.as_tensor(np.concatenate([exps, np.ones((1, exps.shape[1]))]),
                            dtype=torch.float32, device=dev),
            torch.as_tensor(np.concatenate([coefs, np.zeros((1, coefs.shape[1]))]),
                            dtype=torch.float32, device=dev),
        ))
    return out


def _ao_sub(tables, gidx, grid, deriv):
    """Gathered AO slab(s) (nb, G, W) for a chunk of blocks: ``gidx`` one
    (nb, smax) long tensor per group (-1 = pad), ``grid`` (nb, G, 3)."""
    sel_tables = []
    for (l, coords, exps, coefs), idx in zip(tables, gidx):
        sel = torch.where(idx < 0, coords.shape[0] - 1, idx)  # pad row
        sel_tables.append((l, coords[sel], exps[sel], coefs[sel]))
    return _ao_groups(sel_tables, grid, deriv)


def _pack_positions(pack, block_sel):
    """Pack-local positions of the selected global block ids, pow2-padded
    by repetition (repeats are harmless for rho -- same value rewritten --
    and are zero-weighted for vxc).  None if no selection; empty if the
    selection misses the pack entirely."""
    if block_sel is None:
        return None  # full pack
    sel = np.isin(pack["blocks"], np.asarray(block_sel, np.int64))
    pos = np.nonzero(sel)[0].astype(np.int64)
    if len(pos) == 0:
        return np.empty(0, np.int64)
    npad = _next_pow2(len(pos)) - len(pos)
    if npad:
        pos = np.concatenate([pos, np.full(npad, pos[0], np.int64)])
    return pos


def _pack_chunks(ni, scr, pack, pos, width):
    """(slice, grid, gidx, cols) device chunks of a pack's blocks."""
    dev = ni.device
    if pos is None:
        pos = np.arange(len(pack["blocks"]))
    blks = pack["blocks"][pos]
    grid = torch.as_tensor(scr.blocks[blks], dtype=torch.float32, device=dev)
    gidx = [torch.as_tensor(g[pos], dtype=torch.long, device=dev)
            for g in pack["gidx"]]
    cols = torch.as_tensor(pack["cols"][pos], dtype=torch.long, device=dev)
    nb = _chunk_blocks(ni.block, width)
    for b0 in range(0, len(pos), nb):
        s = slice(b0, b0 + nb)
        yield s, grid[s], [g[s] for g in gidx], cols[s]


def _pack_width(ni, pack):
    """Widest per-point intermediate of a pack: its slab or one group's
    (shells x primitives) exponentials."""
    return max([pack["W"]] + [
        smax * g[2].shape[1] for smax, g in zip(pack["gmax"], ni.gdata)])


def eval_rho_screened(ni: NumInt, scr: GridScreening, dm_int, family,
                      block_sel=None):
    """rho rows (1|4|5, N) via the bucketed sparse path.

    ``block_sel``: optional iterable of global grid-block ids -- only
    those blocks are evaluated (incremental DFT; unselected blocks
    return 0 rows)."""
    family = _family_arg(family)
    check_fp32_matmul(ni.device, "numint")
    deriv = 0 if family == "lda" else 1
    rows = {"lda": 1, "gga": 4, "mgga": 5}[family]
    tables = _gather_group_tables(ni)
    nao = ni.nao
    dev = ni.device
    dm_pad = torch.zeros((nao + 1, nao + 1), dtype=torch.float32, device=dev)
    dm_pad[:nao, :nao] = torch.as_tensor(dm_int, dtype=torch.float32,
                                         device=dev)
    B = ni.block
    out = torch.zeros((len(scr.blocks), rows, B), dtype=torch.float32,
                      device=dev)

    for pack in scr.packed:
        pos = _pack_positions(pack, block_sel)
        if pos is not None and len(pos) == 0:
            continue
        blks = pack["blocks"] if pos is None else pack["blocks"][pos]
        blks = torch.as_tensor(blks, dtype=torch.long, device=dev)
        for s, grid, gidx, cols in _pack_chunks(ni, scr, pack, pos,
                                                _pack_width(ni, pack)):
            aos = _ao_sub(tables, gidx, grid, deriv)
            dm_sub = dm_pad[cols[:, :, None], cols[:, None, :]]  # (nb, W, W)
            out[blks[s]] = _rho_rows(aos, dm_sub, family)
    out = out.cpu().double().numpy().transpose(1, 0, 2).reshape(rows, -1)
    return out[:, : scr.npts]


def eval_vxc_screened(ni: NumInt, scr: GridScreening, wv, family,
                      block_sel=None):
    """V_xc matrix via the bucketed sparse path (float64 accumulation).

    ``block_sel``: optional global block-id selection (incremental DFT);
    repeated pad positions are zero-weighted so the sum stays exact."""
    family = _family_arg(family)
    check_fp32_matmul(ni.device, "numint")
    deriv = 0 if family == "lda" else 1
    tables = _gather_group_tables(ni)
    nao = ni.nao
    dev = ni.device
    B = ni.block
    size = nao * nao
    rows = wv.shape[0]
    wvp = np.zeros((rows, len(scr.blocks) * B))
    wvp[:, : scr.npts] = wv[:, : scr.npts]
    wv_all = wvp.reshape(rows, len(scr.blocks), B).transpose(1, 0, 2)

    acc = torch.zeros(size + 1, dtype=torch.float64, device=dev)
    for pack in scr.packed:
        pos = _pack_positions(pack, block_sel)
        if pos is not None and len(pos) == 0:
            continue
        blks = pack["blocks"] if pos is None else pack["blocks"][pos]
        wv_blocks = wv_all[blks]
        if pos is not None:
            # zero out repeated pad positions so each selected block
            # contributes exactly once to the accumulation
            first = np.zeros(len(pos), bool)
            first[np.unique(pos, return_index=True)[1]] = True
            wv_blocks = np.where(first[:, None, None], wv_blocks, 0.0)
        wv_dev = torch.as_tensor(wv_blocks, dtype=torch.float32, device=dev)
        for s, grid, gidx, cols in _pack_chunks(ni, scr, pack, pos,
                                                _pack_width(ni, pack)):
            aos = _ao_sub(tables, gidx, grid, deriv)
            mats = _vxc_blocks(aos, wv_dev[s], family).double()
            pad = (cols[:, :, None] >= nao) | (cols[:, None, :] >= nao)
            flat = torch.where(pad, size,
                               cols[:, :, None] * nao + cols[:, None, :])
            # W*W entries are unique within a block: one add per entry
            for k in range(len(mats)):
                acc.index_add_(0, flat[k].reshape(-1), mats[k].reshape(-1))
    return acc[:size].reshape(nao, nao).cpu().numpy()


__all__ = ["GridScreening", "eval_rho_screened", "eval_vxc_screened"]
