"""Contracted-task J/K engine on the device: tables, Schwarz bounds, the
screened task plan and the tile-accumulated Fock build.

Port of ``joltqc_tpu/scf/jk_contracted.py`` (the ``accum='tile'`` path):
``_tables``, ``_q_raw``/``_ensure_q``, ``_build_plan`` (tile branch),
``_espace``/``_efold``, ``_tile_chunk``, ``_run_plan`` and ``get_jk``
for one symmetric density.

 - tasks (screened shell-quartet index quadruples) are built once on the
   host (scf/tasks.py, native/screen.cpp) and stay on the device;
 - FP32/FP64 tiers are the reference's static partition by Schwarz bound
   x shell-block density bound (cutoff_fp32, cutoff_fp64); the plan is
   rebuilt only when the density bound outgrows its 0.7 log-unit margin;
 - each plan entry runs in chunks: one ERI launch (ops/eri.py) gives the
   chunk's ERI blocks, then one contract+accumulate launch per output
   stream (2 J + 4 K, ops/accum_tile.py) adds the exact integer limbs
   into extended (E, E) accumulators, one row range per shell class;
 - the 8-fold symmetry is handled by unique tasks with power-of-two
   weights and one final P + P^T; the E-space is folded to AO space by
   the 0/1 matrix R (vj = R^T E R).

Every plan entry is tile-accumulated; the port has no compile step, so
the JAX package's autotune table, plan cache and q cache are not needed.
Tasks of an entry are ordered by supertile (W shells per center) as in
the reference, which keeps a launch's accumulator targets close; the
pad tasks the TPU needed for fixed chunk shapes are not made.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..mol.layout import BasisLayout
from ..ops.accum_tile import (
    NLIMB, StreamTables, bound_exponent, contract_tile, limbs_to_f64,
)
from ..ops.cuda import resolve_device
from ..ops.eri import contracted_eri_batch, tier_dtype
from ..ops.harmonics import cart_components
from .tasks import (
    build_pair_classes,
    build_quartet_tasks,
    build_shell_classes,
    sort_pairs_by_q,
)

# (kind, x, y, u, v, factor) of the six output blocks of one quartet's
# 8-fold orbit: stream xy contracts the (u, v) density block
# (reference: the six atomicAdd targets of JoltQC jk/1q1t.cu:423-643)
STREAMS = (
    ("j", 0, 1, 2, 3, 2.0),
    ("j", 2, 3, 0, 1, 2.0),
    ("k", 0, 2, 1, 3, 1.0),
    ("k", 0, 3, 1, 2, 1.0),
    ("k", 1, 2, 0, 3, 1.0),
    ("k", 1, 3, 0, 2, 1.0),
)


CHUNK_ELEMS = 1 << 24


def _nf(l):
    return len(cart_components(l))


def tile_entry(classes, tile_w, ls, nprims, tier, cls_idx, idx, w, bound):
    """One plan entry with its tasks (idx (4, n) class-local shell
    indices, w (n,) weights) ordered by supertile quadruple (tile_w
    shells per center), stable, as the reference's tile branch."""
    ns4 = [classes[k].nshell - 1 for k in cls_idx]
    nt4 = [max(1, -(-ns // tile_w)) for ns in ns4]
    karr = [np.minimum(a // tile_w, nt - 1) for a, nt in zip(idx, nt4)]
    key = ((karr[0].astype(np.int64) * nt4[1] + karr[1]) * nt4[2]
           + karr[2]) * nt4[3] + karr[3]
    order = np.argsort(key, kind="stable")
    return dict(
        ls=tuple(ls), nprims=tuple(nprims), tier=tier,
        ntasks=int(idx.shape[1]), cls_idx=tuple(cls_idx),
        idx=np.ascontiguousarray(idx[:, order], dtype=np.int32),
        w=np.ascontiguousarray(np.asarray(w)[order], dtype=np.float32),
        bound=float(bound), accum="tile",
    )


def stream_index_tables(ls, stream, nao):
    """Host tables (gidx, doff, roff, coff) of one stream of class ls."""
    _, xi, yi, ui, vi, _ = stream
    nfs = [_nf(l) for l in ls]
    comp = np.arange(int(np.prod(nfs))).reshape(nfs)
    gidx = comp.transpose(xi, yi, ui, vi).reshape(
        nfs[xi] * nfs[yi], nfs[ui] * nfs[vi]
    )
    o = np.arange(nfs[ui] * nfs[vi])
    doff = (o // nfs[vi]) * nao + o % nfs[vi]
    f = np.arange(nfs[xi] * nfs[yi])
    return gidx, doff, f // nfs[yi], f % nfs[yi]


class JKEngine:
    """Contracted-task mixed-precision get_jk over a BasisLayout."""

    def __init__(
        self,
        layout: BasisLayout,
        device=None,
        cutoff_fp32: float = 1e-13,
        cutoff_fp64: float = 1e-6,
        merge_nprim: bool | None = None,
        tile_w: int = 64,
    ):
        self.device = resolve_device(device)
        self.layout = layout
        self.nao = layout.nao_int
        self.cutoff_fp32 = cutoff_fp32
        self.cutoff_fp64 = cutoff_fp64
        self.tile_w = tile_w
        if merge_nprim is None:
            merge_nprim = layout.nao_int < 400
        self.merge_nprim = merge_nprim
        self.classes = build_shell_classes(layout, merge_nprim=merge_nprim)
        self.pair_classes = build_pair_classes(self.classes)
        self._tabs = {}
        self._stream_tabs = {}
        self._eoff = None
        self._efold_mat = None
        self._plans_full = {}
        self._plan = None
        self.plan_stats: dict = {}
        # host wall seconds of the last plan build and Fock build
        self.timing: dict = {}

    # ------------------------------------------------------------- espace
    def _espace(self):
        """Extended AO row space: one contiguous row range per class of
        max(ns, W)*nf rows (shell-major, component-minor).  Segments of
        split contractions occupy separate E rows; the fold matrix
        recombines them exactly."""
        if self._eoff is None:
            W = self.tile_w
            offs = []
            E = 0
            for c in self.classes:
                offs.append(E)
                E += max(c.nshell - 1, W) * _nf(c.l)
            self._eoff = (offs, E)
        return self._eoff

    def _efold(self):
        """(E, nao) 0/1 fold matrix (float64, on the device):
        vj_int = R^T @ VJ_E @ R, exact (0/1 weights)."""
        if self._efold_mat is None:
            offs, E = self._espace()
            R = np.zeros((E, self.nao))
            for c, off in zip(self.classes, offs):
                nf = _nf(c.l)
                ns = c.nshell - 1
                rows = (
                    off + np.arange(ns)[:, None] * nf + np.arange(nf)
                ).ravel()
                cols = (c.ao[:ns, None] + np.arange(nf)).ravel()
                R[rows, cols] = 1.0
            self._efold_mat = torch.as_tensor(R, device=self.device)
        return self._efold_mat

    # -------------------------------------------------------------- tables
    def _tables(self, tier):
        """Per-class shell tables on the device in the tier's dtype, plus
        the AO start and E-space row of every shell (int32)."""
        dt = tier_dtype(tier)
        if dt not in self._tabs:
            offs, _ = self._espace()
            dev = self.device
            out = []
            for c, off in zip(self.classes, offs):
                out.append(dict(
                    coord=torch.as_tensor(c.coords, dtype=dt, device=dev),
                    exps=torch.as_tensor(c.exps, dtype=dt, device=dev),
                    coefs=torch.as_tensor(c.coefs, dtype=dt, device=dev),
                    ao=torch.as_tensor(c.ao, dtype=torch.int32, device=dev),
                    # the pad shell (last row; its tasks add exact
                    # zeros) maps onto the last real shell's rows
                    erow=torch.as_tensor(
                        off + np.minimum(np.arange(c.nshell), c.nshell - 2)
                        * _nf(c.l),
                        dtype=torch.int32, device=dev,
                    ),
                ))
            self._tabs[dt] = out
        return self._tabs[dt]

    def _stream_tables(self, ls, s):
        key = (ls, s)
        tabs = self._stream_tabs.get(key)
        if tabs is None:
            gidx, doff, roff, coff = stream_index_tables(ls, STREAMS[s],
                                                         self.nao)

            def i32(a):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=torch.int32, device=self.device)

            tabs = StreamTables(i32(gidx), i32(doff), i32(roff), i32(coff),
                                STREAMS[s][5])
            self._stream_tabs[key] = tabs
        return tabs

    @staticmethod
    def _quartet(tbls):
        q = {}
        for x, t in zip("abcd", tbls):
            q[f"coord_{x}"] = t["coord"]
            q[f"exps_{x}"] = t["exps"]
            q[f"coefs_{x}"] = t["coefs"]
        return q

    @staticmethod
    def _chunk(ls):
        """Tasks per launch: CHUNK_ELEMS ERI elements (the chunk's G
        buffer, 128 MiB in fp64), at most 2^21 tasks."""
        nfel = int(np.prod([_nf(l) for l in ls]))
        return max(1, min(1 << 21, CHUNK_ELEMS // nfel))

    # ------------------------------------------------------------ schwarz
    def _q_raw(self, pc):
        """f32 Schwarz diag sqrt-log bound per pair, in CURRENT pair order
        (the ERI of the (ab|ab) diagonal, computed by ops/eri.py)."""
        c1, c2 = self.classes[pc.ci], self.classes[pc.cj]
        ls = (c1.l, c2.l, c1.l, c2.l)
        nprims = (c1.nprim, c2.nprim, c1.nprim, c2.nprim)
        t32 = self._tables("f32")
        quartet = self._quartet((t32[pc.ci], t32[pc.cj]) * 2)
        P = pc.npair
        B = self._chunk(ls)
        q = np.zeros(P, np.float32)
        for s in range(0, P, B):
            i = torch.as_tensor(pc.i_loc[s : s + B], dtype=torch.int32,
                                device=self.device)
            j = torch.as_tensor(pc.j_loc[s : s + B], dtype=torch.int32,
                                device=self.device)
            G = contracted_eri_batch("f32", ls, nprims, quartet,
                                     idx=(i, j, i, j))
            diag = torch.diagonal(G, dim1=1, dim2=2).abs().amax(dim=1)
            q[s : s + B] = diag.cpu().numpy()
        return np.log(np.maximum(q, 1e-38)) * 0.5

    def _ensure_q(self, pc):
        """Pair Schwarz bounds, pairs sorted by descending bound."""
        if pc.q_log is None:
            pc.q_log = self._q_raw(pc)
            sort_pairs_by_q(pc)
        return pc.q_log

    # --------------------------------------------------------------- plan
    def _build_plan(self, logdm, dm_cond_log=None):
        """Screened, supertile-ordered task plan.

        ``logdm``: global log max |dm| bound (candidate generation).
        ``dm_cond_log``: optional (nbas, nbas) log shell-block density
        bounds; with it each task's bound is q_ij + q_kl + max over the
        six relevant dm blocks (reference: jk/screen_jk_tasks.cu:240-262).
        Entries: dict(ls, nprims, tier, ntasks, cls_idx, idx (4, n) int32
        class-local shell indices, w (n,) float32 symmetry weights, bound)
        with tier "fp64" or "f32"."""
        log32 = np.log(self.cutoff_fp32) - logdm
        log64 = np.log(self.cutoff_fp64) - logdm
        log32_abs = float(np.log(self.cutoff_fp32))
        log64_abs = float(np.log(self.cutoff_fp64))
        refine = dm_cond_log is not None
        stats = dict(ntasks=0, n64=0, cand=0, cand64=0)
        plan = []
        for p1i in range(len(self.pair_classes)):
            p1 = self.pair_classes[p1i]
            self._ensure_q(p1)
            for p2i in range(p1i + 1):
                p2 = self.pair_classes[p2i]
                self._ensure_q(p2)
                same = p1i == p2i
                c = [self.classes[k] for k in (p1.ci, p1.cj, p2.ci, p2.cj)]
                ls = tuple(x.l for x in c)
                nprims = tuple(x.nprim for x in c)
                tier_data = None  # [(tier, t1, t2, w, dqmax)]
                if refine:
                    from ..native import screen_tasks_native

                    res = screen_tasks_native(
                        p1.q_log, p2.q_log, p1.q_log, p2.q_log,
                        c[0].shell_ids[p1.i_loc], c[1].shell_ids[p1.j_loc],
                        c[2].shell_ids[p2.i_loc], c[3].shell_ids[p2.j_loc],
                        p1.diag, p2.diag, dm_cond_log, same,
                        log32, log64, log32_abs, log64_abs,
                    )
                    if res is not None:
                        f32t, df64t, cand, cand64 = res
                        stats["cand"] += cand
                        stats["cand64"] += cand64
                        tier_data = [("fp64",) + df64t, ("f32",) + f32t]
                if tier_data is None:
                    t1, t2, w, tier64 = build_quartet_tasks(
                        p1, p2, same, log32, log64
                    )
                    if len(t1) == 0:
                        continue
                    if refine:
                        stats["cand"] += len(t1)
                        stats["cand64"] += int(tier64.sum())
                        D = dm_cond_log
                        i = c[0].shell_ids[p1.i_loc[t1]]
                        j = c[1].shell_ids[p1.j_loc[t1]]
                        k = c[2].shell_ids[p2.i_loc[t2]]
                        ll = c[3].shell_ids[p2.j_loc[t2]]
                        dmx = np.maximum.reduce(
                            [D[i, j], D[k, ll], D[i, k], D[i, ll],
                             D[j, k], D[j, ll]]
                        )
                        dq = p1.q_log[t1] + p2.q_log[t2] + dmx
                        keep = dq > log32_abs
                        t1, t2, w = t1[keep], t2[keep], w[keep]
                        dq = dq[keep]
                        tier64 = dq > log64_abs
                    else:
                        dq = p1.q_log[t1] + p2.q_log[t2] + logdm
                    tier_data = []
                    for tier, sel in (("fp64", tier64), ("f32", ~tier64)):
                        if int(sel.sum()):
                            tier_data.append(
                                (tier, t1[sel], t2[sel], w[sel],
                                 float(dq[sel].max()))
                            )
                ntot = sum(len(td[1]) for td in tier_data)
                if ntot == 0:
                    continue
                stats["ntasks"] += ntot
                stats["n64"] += sum(
                    len(td[1]) for td in tier_data if td[0] == "fp64"
                )
                # static limb-scale bound: |contribution| <= 2 * nf_sum *
                # exp(q_ij + q_kl + dm_block) (2: the vj factor; nf_sum:
                # the densest block contraction length)
                nf = [_nf(x) for x in ls]
                nf_sum = max(
                    nf[0] * nf[1], nf[2] * nf[3], nf[0] * nf[2],
                    nf[0] * nf[3], nf[1] * nf[2], nf[1] * nf[3],
                )
                for tier, s1, s2, sw, dmax in tier_data:
                    if len(s1) == 0:
                        continue
                    bound_log = dmax + np.log(2.0 * nf_sum) + 0.5
                    bound = np.float32(np.exp(min(bound_log, 80.0)))
                    idx = np.stack([p1.i_loc[s1], p1.j_loc[s1],
                                    p2.i_loc[s2], p2.j_loc[s2]])
                    plan.append(self._tile_entry(
                        ls, nprims, tier, (p1.ci, p1.cj, p2.ci, p2.cj),
                        idx, sw, float(bound),
                    ))
        self.plan_stats = stats
        return plan

    def _tile_entry(self, ls, nprims, tier, cls_idx, idx, w, bound):
        return tile_entry(self.classes, self.tile_w, ls, nprims, tier,
                          cls_idx, idx, w, bound)

    def build_plan(self, dm_mol):
        """Build the screened task plan for a density WITHOUT running the
        Fock build."""
        dm_int = self.layout.dm_to_internal(np.asarray(dm_mol, np.float64))
        D = np.log(np.maximum(self.layout.dm_cond(dm_int), 1e-30)).astype(
            np.float32)
        self._plan = self._ensure_full_plan(D, float(D.max()))
        return self._plan

    def _ensure_full_plan(self, D, logdm):
        cached = self._plans_full.get(0.0)
        if cached is None or np.any(D > cached[1]):
            t0 = time.perf_counter()
            Dm = (D + 0.7).astype(np.float32)
            cached = (self._build_plan(logdm + 0.7, Dm), Dm)
            self._plans_full[0.0] = cached
            self.timing["plan_build_s"] = (
                self.timing.get("plan_build_s", 0.0)
                + time.perf_counter() - t0
            )
            self.timing["plan_builds"] = self.timing.get("plan_builds", 0) + 1
        return cached[0]

    def _entry_dev(self, entry):
        """Device-resident task arrays of one entry (uploaded once, after
        a host check that every index lies in its class table)."""
        dev = entry.get("_dev")
        if dev is None:
            idx = entry["idx"]
            for k, ci in enumerate(entry["cls_idx"]):
                n = self.classes[ci].nshell
                if idx.shape[1] and (idx[k].min() < 0 or idx[k].max() >= n):
                    raise ValueError(f"plan entry {entry['ls']}: index out "
                                     f"of class {ci}")
            dev = (
                torch.as_tensor(idx, dtype=torch.int32, device=self.device),
                torch.as_tensor(entry["w"], dtype=torch.float32,
                                device=self.device),
            )
            entry["_dev"] = dev
        return dev

    # ---------------------------------------------------------------- jk
    def _run_plan(self, dm_int, with_j, with_k, plan=None):
        """Folded accumulators (vj, vk) as float64 (nao, nao) numpy
        partials P: the symmetric-dm result is P + P^T."""
        nao = self.nao
        if plan is None:
            cond = self.layout.dm_cond(dm_int)
            D = np.log(np.maximum(cond, 1e-30)).astype(np.float32)
            plan = self._plan = self._ensure_full_plan(D, float(D.max()))
        dev = self.device
        dm64 = torch.as_tensor(dm_int, dtype=torch.float64, device=dev)
        dms = {torch.float64: dm64.contiguous(),
               torch.float32: dm64.float().contiguous()}
        offs, E = self._espace()
        e = max((bound_exponent(x["bound"]) for x in plan), default=0)
        EJ = (torch.zeros((E, E, NLIMB), dtype=torch.int64, device=dev)
              if with_j else None)
        EK = (torch.zeros((E, E, NLIMB), dtype=torch.int64, device=dev)
              if with_k else None)
        streams = [s for s, st in enumerate(STREAMS)
                   if (st[0] == "j" and with_j) or (st[0] == "k" and with_k)]
        for entry in plan:
            tier, ls = entry["tier"], entry["ls"]
            dm_t = dms[tier_dtype(tier)]
            tbls = [self._tables(tier)[k] for k in entry["cls_idx"]]
            quartet = self._quartet(tbls)
            idx_all, w_all = self._entry_dev(entry)
            n = idx_all.shape[1]
            B = self._chunk(ls)
            for s0 in range(0, n, B):
                idx = tuple(idx_all[k, s0 : s0 + B] for k in range(4))
                w = w_all[s0 : s0 + B]
                G = contracted_eri_batch(tier, ls, entry["nprims"], quartet,
                                         0.0, idx=idx)
                for s in streams:
                    kind, xi, yi, ui, vi, _ = STREAMS[s]
                    contract_tile(
                        G, self._stream_tables(ls, s), dm_t, nao,
                        (idx[ui], tbls[ui]["ao"]), (idx[vi], tbls[vi]["ao"]),
                        (idx[xi], tbls[xi]["erow"]),
                        (idx[yi], tbls[yi]["erow"]),
                        w, EJ if kind == "j" else EK, e,
                    )
        R = self._efold()

        def fold(acc):
            if acc is None:
                return None
            return (R.T @ limbs_to_f64(acc, e) @ R).cpu().numpy()

        return fold(EJ), fold(EK)

    def get_jk(self, dm_mol, with_j=True, with_k=True, plan=None):
        """J/K matrices (mol AO basis) for one symmetric density matrix.

        ``plan``: a task plan to run instead of the engine's own screened
        plan (e.g. one carried across by convert.plan_from_numpy)."""
        dm = np.asarray(dm_mol, np.float64)
        if dm.ndim != 2:
            raise NotImplementedError("get_jk: one (nao, nao) density only")
        t0 = time.perf_counter()
        lay = self.layout
        vj, vk = self._run_plan(lay.dm_to_internal(dm), with_j, with_k,
                                plan=plan)
        out_j = lay.mat_to_mol(vj + vj.T) if with_j else None
        out_k = lay.mat_to_mol(vk + vk.T) if with_k else None
        self.timing["get_jk_s"] = time.perf_counter() - t0
        return out_j, out_k


__all__ = ["JKEngine", "STREAMS", "stream_index_tables"]
