"""Contracted-task J/K engine on the device: tables, Schwarz bounds, the
screened task plan and the Fock build in three accumulation modes.

Port of ``joltqc_tpu/scf/jk_contracted.py``: ``_tables``, ``_q_raw`` /
``_ensure_q`` (per omega), ``_contract_blocks``, ``_build_plan`` (tile,
scatter and block branches), ``_espace`` / ``_efold``, ``_tile_chunk`` and
the scatter and block branches of ``_class_scan_body`` (``_run_plan``),
``get_jk`` (one density or a stack, ``omega``, ``hermi``, ``bucketed``),
``get_jk_incr`` and ``reset_incremental``; the Schwarz-q and plan disk
caches (``_ensure_q``, ``_build_plan_cached``, utils/plancache.py),
``accum='auto'`` (utils/autotune.py), ``profile`` / ``class_time``, and
the task-sharded build of the reference's ``mesh=`` path over a
``torch.distributed`` group (``group=``).

 - tasks (screened shell-quartet index quadruples) are built once on the
   host (scf/tasks.py, native/screen.cpp) and stay on the device;
 - FP32/FP64 tiers are the reference's static partition by Schwarz bound
   x shell-block density bound (cutoff_fp32, cutoff_fp64); the plan is
   rebuilt only when the density bound outgrows its 0.7 log-unit margin;
   ``omega > 0`` re-screens and re-tiers with erf-attenuated bounds;
 - each plan entry runs in chunks: one ERI launch (ops/eri.py) gives the
   chunk's ERI blocks, which are contracted with every density of the
   call and accumulated as exact integer limbs in the entry's mode:
     * ``'tile'`` (default): one contract+accumulate launch per output
       stream (2 J + 4 K, ops/accum_tile.py) into extended (E, E)
       accumulators, one row range per shell class;
     * ``'scatter'``: the six stream contractions as batched products
       (``_contract_blocks``), then one limb scatter per stream into a
       flat (n_dm * nao * nao) accumulator (ops/accum.py);
     * ``'block'``: tasks sorted by S-shell tile quadruple; per stream the
       contracted values are first segment-summed over the chunk's
       (group slot, tile row) space by the block kernel
       (ops/accum.py::block_accumulate), and only those block rows are
       scattered.  The block limbs are made at the accumulator's exponent
       and added as integers, with no decode in between.  An entry whose
       chunks would need more than four block rows per task runs as
       scatter (``entry['accum']`` says which, the reference's rule);
     * ``'auto'``: each class takes its mode and chunk from the device's
       autotune table (utils/autotune.py); an untuned class runs as tile
       on the card and as scatter elsewhere (the reference's rule, with
       the card in place of the TPU).  Only ``'auto'`` reads the table's
       chunks: the fixed modes keep the chunks below, so their launches do
       not depend on a table;
 - the 8-fold symmetry is handled by unique tasks with power-of-two
   weights and one final P + P^T (P - P^T for the antisymmetric part of
   a non-symmetric density); the E-space is folded to AO space by the 0/1
   matrix R (vj = R^T E R).

Plans and Schwarz q persist across processes (utils/plancache.py, with
its environment variables): a plan is loaded when its key is on disk,
else built and saved if the build took at least
``JQC_PLAN_CACHE_MIN_SECS``; ``timing`` counts builds and loads apart.
The reference's ``fuse_group`` (class scans fused into one compiled
program) and its pow2 chunk padding are not carried over, since the port
has no compile step; the pad tasks the TPU needed for fixed chunk shapes
are not made (a shorter last chunk).

Sharding (``JKEngine(group=...)``, the reference's "split the within-chunk
batch", ``parallel/jk_sharded.py``): every rank builds the same plan and
runs, of each launch of b tasks, the contiguous slice r of R slices of
ceil(b / R) tasks through the same kernels (A, then B on a tile entry; A,
then the scatter or kernel D on a block entry, whose slice keeps its
chunk's ``tb4`` and its own stretch of ``gslot``); an empty slice launches
nothing.  After the last entry the four int64 limb accumulators are summed
over the group with ``all_reduce(SUM)`` and decoded as on one device.  All
ranks share one limb exponent and integer sums are associative, so J/K are
bit-identical to one device for any R; no float is ever reduced.  Before
each run the ranks compare a digest of the plan (and of the call's shape)
with ``all_gather`` and raise if they differ.  Only rank 0 writes plan and
q files; every rank may load them.
"""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import torch

from ..utils import plancache
from ..utils.autotune import tuned_accum, tuned_chunk

from ..mol.layout import BasisLayout
from ..ops.accum import (
    NLIMB, add_limbs_, block_accumulate, bound_exponent, limbs_to_f64,
)
from ..ops.accum_tile import StreamTables, contract_tile
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
# block mode: the chunk is bounded so that one stream's block buffer,
# nrows * nf * 24 bytes with nrows = G * S * S <= 4 * B rows and nf up to
# 36 for (dd| streams and 225 for l = 4, stays within this many bytes
BLOCK_BUF_BYTES = 256 << 20
MODES = ("tile", "scatter", "block")  # the modes a plan entry runs in
ACCUM_MODES = MODES + ("auto",)
_CENTER = {"a": 0, "b": 1, "c": 2, "d": 3}


def _nf(l):
    return len(cart_components(l))


def _add(counts, **kv):
    for k, v in kv.items():
        counts[k] = counts.get(k, 0) + v


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
    return flat_entry(ls, nprims, tier, cls_idx, idx[:, order],
                      np.asarray(w)[order], bound, accum="tile")


def flat_entry(ls, nprims, tier, cls_idx, idx, w, bound, accum="scatter"):
    """One scatter-mode plan entry: the tasks as they are."""
    return dict(
        ls=tuple(ls), nprims=tuple(nprims), tier=tier,
        ntasks=int(idx.shape[1]), cls_idx=tuple(cls_idx),
        idx=np.ascontiguousarray(idx, dtype=np.int32),
        w=np.ascontiguousarray(w, dtype=np.float32),
        bound=float(bound), accum=accum,
    )


def block_entry(classes, S, B, ls, nprims, tier, cls_idx, idx, w, bound):
    """One block-mode plan entry: tasks in stable order of their 4-D
    S-shell tile key, run in chunks of B tasks.  Within a chunk every run
    of one key is a group; ``gslot`` (n,) is the task's group number in
    its chunk, G the largest group count rounded up to a power of two,
    and ``tb4`` (nchunk, G, 4) the groups' tile base shells, ``1 << 28``
    for empty slots.  A task's block row is gslot*S*S + (jx % S)*S +
    (jy % S) for output stream xy, so a chunk has nrows = G*S*S rows.
    The entry is ``'block'`` only if ``G*S*S <= 4*B`` (at most four block
    rows per task); else it runs as ``'scatter'``, in the same order."""
    n = idx.shape[1]
    nt = [-(-classes[k].nshell // S) + 1 for k in cls_idx]
    t4 = [a.astype(np.int64) // S for a in idx]
    key = ((t4[0] * nt[1] + t4[1]) * nt[2] + t4[2]) * nt[3] + t4[3]
    order = np.argsort(key, kind="stable")
    idx, w, key = idx[:, order], np.asarray(w)[order], key[order]
    first = np.ones(n, bool)           # first task of its group
    first[1:] = key[1:] != key[:-1]
    first[::B] = True
    c = np.cumsum(first)
    chunk = np.arange(n) // B
    gslot = (c - c[chunk * B]).astype(np.int32)
    G = 1 << int(np.ceil(np.log2(max(int(gslot.max()) + 1, 1))))
    entry = flat_entry(ls, nprims, tier, cls_idx, idx, w, bound)
    if G * S * S <= 4 * B:
        tb4 = np.full((-(-n // B), G, 4), 1 << 28, np.int32)
        tb4[chunk[first], gslot[first]] = ((idx[:, first] // S) * S).T
        entry.update(accum="block", chunk=int(B), gslot=gslot, tb4=tb4,
                     nrows=G * S * S)
    return entry


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


def _sum_last(p):
    """Sum over the last axis in a fixed pairwise order, by elementwise
    adds of its halves: each element's bits depend on its own terms only,
    whatever the batch."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        q = p[..., :h] + p[..., h:2 * h]
        p = torch.cat([q, p[..., 2 * h:]], -1) if p.shape[-1] % 2 else q
    return p[..., 0]


def _contract_blocks(G, aos, nfs, dm_flat, nao, with_j, with_k, off=0):
    """Density contraction of an ERI block batch -> per-stream values.

    G: (T, nfa*nfb, nfc*nfd) in the tier's dtype (symmetry weight folded
    in); aos: the four (T,) int64 AO starts; nfs: (nfa, nfb, nfc, nfd);
    dm_flat: the flattened density (or stack of densities) in G's dtype.
    Returns (jstreams, kstreams): lists of ("xy", vals2d, idx2d) with
    vals2d (T, nfx*nfy) contribution blocks and idx2d the matching flat
    nao*nao indices (int64): J has streams ab/cd, K has ac/ad/bc/bd, the
    six output blocks of one quartet's 8-fold orbit.

    ``off``: flat element offset d*nao*nao of one density of a stack (the
    density gathers and the output indices both shift by it); the ERI
    block is computed once and contracted with every density.  The
    contraction is elementwise PyTorch in the tier's dtype, as the
    reference leaves it to XLA outside any kernel: one product, then
    ``_sum_last``, so that a task's values do not depend on the batch it
    came in (a batched library product picks its algorithm, and its order
    of terms, by the batch size, and a task split across ranks must give
    the same bits)."""
    T = G.shape[0]
    G5 = G.reshape(T, *nfs)
    ar = [torch.arange(n, device=G.device) for n in nfs]

    def blk_idx(x, y):
        return ((aos[x][:, None, None] + ar[x][None, :, None]) * nao
                + aos[y][:, None, None] + ar[y][None, None, :]
                ).reshape(T, nfs[x] * nfs[y]) + off

    idx = {}

    def blk(xy):
        if xy not in idx:
            idx[xy] = blk_idx(_CENTER[xy[0]], _CENTER[xy[1]])
        return idx[xy]

    def stream(xy, uv, fac):
        x, y, u, v = (_CENTER[c] for c in xy + uv)
        g = G5.permute(0, x + 1, y + 1, u + 1, v + 1).reshape(
            T, nfs[x] * nfs[y], nfs[u] * nfs[v])
        val = _sum_last(g * dm_flat[blk(uv)][:, None, :])
        return xy, (val * fac if fac != 1.0 else val), blk(xy)

    jstreams = kstreams = ()
    if with_j:
        jstreams = [stream("ab", "cd", 2.0), stream("cd", "ab", 2.0)]
    if with_k:
        kstreams = [stream("ac", "bd", 1.0), stream("ad", "bc", 1.0),
                    stream("bc", "ad", 1.0), stream("bd", "ac", 1.0)]
    return list(jstreams), list(kstreams)


class JKEngine:
    """Contracted-task mixed-precision get_jk over a BasisLayout.

    ``group``: a torch.distributed process group over which every launch's
    tasks are split (module docstring); every rank calls ``get_jk`` with
    the same arguments and gets the same, one-device J/K.  The engine runs
    on ``device`` as without a group: ``parallel.rank_device`` picks a
    rank's card."""

    def __init__(
        self,
        layout: BasisLayout,
        device=None,
        cutoff_fp32: float = 1e-13,
        cutoff_fp64: float = 1e-6,
        merge_nprim: bool | None = None,
        accum: str = "tile",
        tile: int = 8,
        tile_w: int = 64,
        group=None,
    ):
        self.device = resolve_device(device)
        self.layout = layout
        self.nao = layout.nao_int
        self.cutoff_fp32 = cutoff_fp32
        self.cutoff_fp64 = cutoff_fp64
        # Fock accumulation mode (module docstring); ``tile`` = shell-tile
        # edge S of the block mode (S*S rows per block), ``tile_w`` =
        # supertile shell width W of the tile mode
        if accum not in ACCUM_MODES:
            raise ValueError(f"JKEngine: accum {accum!r} not in "
                             f"{ACCUM_MODES}")
        self.accum = accum
        self.tile = int(tile)
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
        self._plans_full = {}   # omega -> (plan, Dm): full-density plans
        self._plans = {}        # (bucket, omega) -> (plan, Dm): delta-dm
        self._incr = {}
        self._plan = None
        self.plan_stats: dict = {}
        # host wall seconds of the plan builds and the last Fock build,
        # the limb reduction's seconds and bytes (with a group), and plan
        # builds per cache key (("full" | bucket, omega))
        self.timing: dict = {}
        self.plan_builds: dict = {}
        # profile=True: the card is synchronised after each entry, and the
        # entry's wall seconds add to class_time[(ls, nprims, tier)]
        self.profile = False
        self.class_time: dict = {}
        # task sharding (module docstring): this process runs slice
        # ``rank`` of ``world`` of every launch; ``group`` is a
        # torch.distributed process group, None for one process (then
        # torch.distributed is never touched)
        self.group = group
        self.rank, self.world = 0, 1
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        # in-process hooks of the tests: ``_split`` = (rank, world) runs
        # that slice with nothing reduced; ``_limbs``, a list, receives
        # each ``_run_plan``'s limb accumulators and exponent (after the
        # reduction, before the decode)
        self._split = None
        self._limbs = None

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

    def _tuned_chunk(self, ls, nprims, tier, ntasks):
        """An ``'auto'`` engine's chunk from the autotune table, clamped
        as the reference clamps it (at most the task count rounded up to a
        power of two, at least 64); None when the engine is not ``'auto'``
        or the class is untuned."""
        if self.accum != "auto":
            return None
        b = tuned_chunk(ls, nprims, tier, self.device)
        if b is None:
            return None
        return int(min(b, 1 << int(np.ceil(np.log2(max(ntasks, 64))))))

    def _block_chunk(self, ls, ntasks, nprims=None, tier=None):
        """Tasks per launch of a block entry: the tuned chunk or
        ``_chunk``, bounded by the block buffer (4 * B rows of the widest
        stream's nf, 24 bytes per element, within BLOCK_BUF_BYTES), and,
        as in the reference, by the task count rounded up to a power of
        two (at least 64), so that ``G*S*S <= 4*B`` compares block rows
        with real tasks."""
        nf = sorted(_nf(l) for l in ls)
        b = min(self._tuned_chunk(ls, nprims, tier, ntasks)
                or self._chunk(ls),
                BLOCK_BUF_BYTES // (4 * 24 * nf[-1] * nf[-2]))
        return max(1, min(b, 1 << int(np.ceil(np.log2(max(ntasks, 64))))))

    # ------------------------------------------------------------ schwarz
    def _q_raw(self, pc, omega=0.0):
        """f32 Schwarz diag sqrt-log bound per pair, in CURRENT pair order
        (the ERI of the (ab|ab)_omega diagonal, computed by ops/eri.py)."""
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
                                     float(omega), idx=(i, j, i, j))
            diag = torch.diagonal(G, dim1=1, dim2=2).abs().amax(dim=1)
            q[s : s + B] = diag.cpu().numpy()
        return np.log(np.maximum(q, 1e-38)) * 0.5

    def _ensure_q(self, pc, omega=0.0):
        """Pair Schwarz bounds, pairs sorted by descending bound.  The
        per-omega variants share the omega = 0 sort order: the
        erf-attenuated (ab|ab)_omega is bounded by the full Coulomb value,
        so the omega = 0 candidate generation is a superset.

        Disk cache (utils/plancache.py::q_path): q is saved with the
        stable ``argsort(-q)`` order, which a load re-applies to i_loc,
        j_loc and diag, so the pairs end in ``sort_pairs_by_q``'s order;
        the omega variants are stored aligned to that sorted order."""
        omega = float(omega or 0.0)
        if pc.q_log is None:
            path = plancache.q_path(self, pc, 0.0)
            got = plancache.load_arrays(path, ("q", "order"), pc.npair)
            if got is not None:
                q, order = got
                pc.i_loc, pc.j_loc = pc.i_loc[order], pc.j_loc[order]
                pc.diag = pc.diag[order]
                pc.q_log = q
            else:
                pc.q_log = self._q_raw(pc)
                order = np.argsort(-pc.q_log, kind="stable")
                sort_pairs_by_q(pc)
                if self.rank == 0:
                    plancache.save_arrays(path, q=pc.q_log, order=order)
        if omega == 0.0:
            return pc.q_log
        if omega not in pc.q_omega:
            path = plancache.q_path(self, pc, omega)
            got = plancache.load_arrays(path, ("q",), pc.npair)
            if got is not None:
                pc.q_omega[omega] = got[0]
            else:
                pc.q_omega[omega] = self._q_raw(pc, omega)
                if self.rank == 0:
                    plancache.save_arrays(path, q=pc.q_omega[omega])
        return pc.q_omega[omega]

    # --------------------------------------------------------------- plan
    def _build_plan(self, logdm, dm_cond_log=None, omega=0.0):
        """Screened task plan, each entry laid out for its accumulation
        mode.

        ``logdm``: global log max |dm| bound (candidate generation).
        ``dm_cond_log``: optional (nbas, nbas) log shell-block density
        bounds; with it each task's bound is q_ij + q_kl + max over the
        six relevant dm blocks (reference: jk/screen_jk_tasks.cu:240-262).
        ``omega > 0`` re-screens and re-tiers with the erf-attenuated
        per-omega Schwarz bounds.
        Entries: dict(ls, nprims, tier, ntasks, cls_idx, idx (4, n) int32
        class-local shell indices, w (n,) float32 symmetry weights, bound,
        accum) with tier "fp64" or "f32"; a block entry adds chunk, gslot,
        tb4 and nrows (``block_entry``).  ``plan_stats`` counts tasks,
        candidates and tasks per mode."""
        omega = float(omega or 0.0)
        log32 = np.log(self.cutoff_fp32) - logdm
        log64 = np.log(self.cutoff_fp64) - logdm
        log32_abs = float(np.log(self.cutoff_fp32))
        log64_abs = float(np.log(self.cutoff_fp64))
        refine = dm_cond_log is not None or omega != 0.0
        stats = dict(ntasks=0, n64=0, cand=0, cand64=0,
                     by_accum=dict.fromkeys(MODES, 0))
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
                if dm_cond_log is not None:
                    from ..native import screen_tasks_native

                    res = screen_tasks_native(
                        p1.q_log, p2.q_log,
                        self._ensure_q(p1, omega), self._ensure_q(p2, omega),
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
                        qsum = (self._ensure_q(p1, omega)[t1]
                                + self._ensure_q(p2, omega)[t2])
                        if dm_cond_log is not None:
                            D = dm_cond_log
                            i = c[0].shell_ids[p1.i_loc[t1]]
                            j = c[1].shell_ids[p1.j_loc[t1]]
                            k = c[2].shell_ids[p2.i_loc[t2]]
                            ll = c[3].shell_ids[p2.j_loc[t2]]
                            dmx = np.maximum.reduce(
                                [D[i, j], D[k, ll], D[i, k], D[i, ll],
                                 D[j, k], D[j, ll]]
                            )
                        else:
                            dmx = np.full(len(t1), logdm, np.float32)
                        dq = qsum + dmx
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
                    entry = self._entry(
                        ls, nprims, tier, (p1.ci, p1.cj, p2.ci, p2.cj),
                        idx, sw, float(bound),
                    )
                    stats["by_accum"][entry["accum"]] += entry["ntasks"]
                    plan.append(entry)
        self.plan_stats = stats
        return plan

    def _entry_mode(self, ls, nprims, tier):
        """The accumulation mode of one class: the engine's, or for
        ``'auto'`` the autotune table's, else tile on the card and scatter
        elsewhere."""
        if self.accum != "auto":
            return self.accum
        tuned = tuned_accum(ls, nprims, tier, self.device)
        if tuned in MODES:
            return tuned
        return "tile" if self.device.type == "cuda" else "scatter"

    def _entry(self, ls, nprims, tier, cls_idx, idx, w, bound):
        """One plan entry in its class's accumulation mode."""
        mode = self._entry_mode(ls, nprims, tier)
        if mode == "tile":
            return tile_entry(self.classes, self.tile_w, ls, nprims, tier,
                              cls_idx, idx, w, bound)
        if mode == "block":
            return block_entry(self.classes, self.tile,
                               self._block_chunk(ls, idx.shape[1], nprims,
                                                 tier),
                               ls, nprims, tier, cls_idx, idx, w, bound)
        return flat_entry(ls, nprims, tier, cls_idx, idx, w, bound)

    def build_plan(self, dm_mol, omega=0.0):
        """Build the screened task plan for a density (or a stack) WITHOUT
        running the Fock build."""
        dm = np.asarray(dm_mol, np.float64)
        lay = self.layout
        cond = np.maximum.reduce(
            [lay.dm_cond(lay.dm_to_internal(d))
             for d in dm.reshape(-1, *dm.shape[-2:])])
        D = np.log(np.maximum(cond, 1e-30)).astype(np.float32)
        self._plan = self._ensure_full_plan(D, float(D.max()),
                                            float(omega or 0.0))
        return self._plan

    def _timed_build(self, key, logdm, Dm, okey):
        """``_build_plan_cached`` with its counts in ``timing``:
        plan_builds / plan_build_s count builds only, plan_loads /
        plan_load_s loads from disk (the upload to the device included);
        ``plan_builds`` counts builds per cache key."""
        t0 = time.perf_counter()
        plan, build_s = self._build_plan_cached(logdm, Dm, okey)
        if build_s is None:
            _add(self.timing, plan_load_s=time.perf_counter() - t0,
                 plan_loads=1)
        else:
            _add(self.timing, plan_build_s=build_s, plan_builds=1)
            self.plan_builds[key] = self.plan_builds.get(key, 0) + 1
        return plan

    def _build_plan_cached(self, logdm, Dm, okey):
        """(plan, seconds of its build, None when loaded): the plan from
        disk when its key is there (every entry uploaded to the device
        here), else ``_build_plan``, saved when the build took at least
        ``JQC_PLAN_CACHE_MIN_SECS`` (plan_saves / plan_save_s /
        plan_save_bytes in ``timing``), by rank 0 only.  The environment is
        read at each call, so a caller can switch the cache between calls.
        The key holds no rank count: the plan is the same for every R (a
        launch is split across ranks only when it runs), so one file
        serves any R."""
        key = plancache.plan_key(self, logdm, Dm, okey)
        loaded = plancache.load_plan(key)
        if loaded is not None:
            plan, self.plan_stats = loaded
            for entry in plan:
                self._entry_dev(entry)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return plan, None
        t0 = time.perf_counter()
        plan = self._build_plan(logdm, Dm, okey)
        secs = time.perf_counter() - t0
        if (key is not None and secs >= plancache.min_secs()
                and self.rank == 0):
            t1 = time.perf_counter()
            nbytes = plancache.save_plan(key, plan, self.plan_stats)
            _add(self.timing, plan_save_s=time.perf_counter() - t1,
                 plan_saves=int(nbytes > 0), plan_save_bytes=nbytes)
        return plan, secs

    def _ensure_full_plan(self, D, logdm, okey=0.0):
        """The full-density plan of this omega, rebuilt only when some
        shell block outgrows its 0.7 log-unit margin."""
        cached = self._plans_full.get(okey)
        if cached is None or np.any(D > cached[1]):
            Dm = (D + 0.7).astype(np.float32)
            cached = (self._timed_build(("full", okey), logdm + 0.7, Dm,
                                        okey), Dm)
            self._plans_full[okey] = cached
        return cached[0]

    def _ensure_bucket_plan(self, D, logdm, okey=0.0):
        """Incremental path: delta-dm norms decay over the SCF, and
        rescreening at each smaller bound drops most tasks.  Plans are
        cached per density-bound bucket (4 log units).  The selected plan
        stays local: the full-density plans are not touched."""
        b = int(np.floor(logdm / 4.0))
        bound = (b + 1) * 4.0 + 0.7
        cached = self._plans.get((b, okey))
        if cached is None or np.any(D > cached[1]):
            Dm = np.minimum(D + 0.7, bound).astype(np.float32)
            cached = (self._timed_build((b, okey), bound, Dm, okey), Dm)
            self._plans[(b, okey)] = cached
        return cached[0]

    def _entry_dev(self, entry):
        """Device-resident task arrays of one entry (uploaded once, after
        a host check that every index lies in its class table): idx (4, n)
        int32, w (n,) float32 and, for a block entry, gslot (n,) and tb4
        (nchunk, G, 4) int32; arrays a plan file narrowed
        (plancache._narrow) are widened back on the way."""
        dev = entry.get("_dev")
        if dev is None:
            idx = entry["idx"]
            for k, ci in enumerate(entry["cls_idx"]):
                n = self.classes[ci].nshell
                if idx.shape[1] and (idx[k].min() < 0 or idx[k].max() >= n):
                    raise ValueError(f"plan entry {entry['ls']}: index out "
                                     f"of class {ci}")

            def up(a, dt):
                # a writable C-ordered copy of a read-only or narrowed
                # array (a memory-mapped plan file), else the array itself
                a = np.require(a, dt, ("C", "W"))
                return torch.from_numpy(a).to(self.device)

            dev = (up(idx, np.int32), up(entry["w"], np.float32))
            if entry["accum"] == "block":
                nchunk = -(-idx.shape[1] // entry["chunk"])
                if (entry["tb4"].shape[0] != nchunk
                        or entry["gslot"].shape != (idx.shape[1],)):
                    raise ValueError(f"plan entry {entry['ls']}: gslot/tb4 "
                                     "do not match its chunks")
                dev += (up(entry["gslot"], np.int32),
                        up(entry["tb4"], np.int32))
            entry["_dev"] = dev
        return dev

    # ---------------------------------------------------------------- jk
    def _entry_chunk(self, entry):
        """Tasks per launch of an entry: a block entry's own, else the
        tuned chunk of an ``'auto'`` engine, else ``_chunk``."""
        return (entry.get("chunk")
                or self._tuned_chunk(entry["ls"], entry["nprims"],
                                     entry["tier"], entry["ntasks"])
                or self._chunk(entry["ls"]))

    def _chunk_eri(self, entry, s0, omega=0.0, chunk=None):
        """One launch of an entry, tasks s0 .. s0 + chunk (the entry's
        own chunk when None): the class tables, the four index rows, the
        weights and the ERI blocks (kernel A on the card)."""
        tbls = [self._tables(entry["tier"])[k] for k in entry["cls_idx"]]
        idx_all, w_all = self._entry_dev(entry)[:2]
        s1 = s0 + (chunk or self._entry_chunk(entry))
        idx = tuple(idx_all[k, s0:s1] for k in range(4))
        G = contracted_eri_batch(entry["tier"], entry["ls"], entry["nprims"],
                                 self._quartet(tbls), omega, idx=idx)
        return tbls, idx, w_all[s0:s1], G

    def _chunk_streams(self, entry, tbls, idx, w, G, dm_flat, with_j=True,
                       with_k=True, off=0):
        """``_contract_blocks`` of one launch: the symmetry weight folded
        into G (exact: powers of two), then the six stream contractions
        with the density at flat offset ``off`` of ``dm_flat``."""
        aos = tuple(t["ao"].long()[i.long()] for t, i in zip(tbls, idx))
        return _contract_blocks(
            G * w.to(G.dtype)[:, None, None], aos,
            tuple(_nf(l) for l in entry["ls"]), dm_flat, self.nao, with_j,
            with_k, off)

    def _block_keys(self, entry, s0, idx, xy):
        """Block row key (T,) int32 of every task of the launch (or of a
        rank's slice of it) that starts at task s0, for output stream xy,
        and the (G, 4) tile bases of the chunk it lies in."""
        S, B = self.tile, entry["chunk"]
        gslot, tb4 = self._entry_dev(entry)[2:]
        x, y = _CENTER[xy[0]], _CENTER[xy[1]]
        T = idx[x].shape[0]
        rowkey = gslot[s0 : s0 + T] * (S * S) + (idx[x] % S) * S + idx[y] % S
        return rowkey, tb4[s0 // B]

    def _block_rows_index(self, tb4c, tbls, ls, xy):
        """Flat nao*nao index of every element of a chunk's block rows for
        output stream xy: (G*S*S*nfx*nfy,) int64 aligned with the
        (nrows, nfx*nfy) blocks; empty group slots and shells beyond the
        class go to the spill row nao*nao."""
        S, nao = self.tile, self.nao
        x, y = _CENTER[xy[0]], _CENTER[xy[1]]
        r = torch.arange(S, device=self.device)
        sh, ao, ns = [], [], []
        for k in (x, y):
            n_real = tbls[k]["ao"].shape[0] - 1  # last row = pad shell
            shk = tb4c[:, k].long()[:, None] + r[None, :]        # (G, S)
            sh.append(shk)
            ao.append(tbls[k]["ao"].long()[shk.clamp(max=n_real)])
            ns.append(n_real)
        ok = (sh[0][:, :, None] < ns[0]) & (sh[1][:, None, :] < ns[1])
        base = torch.where(ok, ao[0][:, :, None] * nao + ao[1][:, None, :],
                           nao * nao)                            # (G, S, S)
        fx = torch.arange(_nf(ls[x]), device=self.device)
        fy = torch.arange(_nf(ls[y]), device=self.device)
        idx = (base[..., None, None] + fx[:, None] * nao + fy[None, :])
        # keep the spill row out of real AO space after the f offsets
        return torch.where(base[..., None, None] >= nao * nao, nao * nao,
                           idx).reshape(-1)

    def _accumulators(self, n_dm, with_j, with_k, has_tile, has_flat):
        """(EJ, EK, AJ, AK) int64 limb accumulators: extended (n_dm, E, E,
        NLIMB) ones for tile entries, flat (n_dm*nao*nao + 1, NLIMB) ones
        with a spill row for the others; None where unused."""
        _, E = self._espace()
        flat = n_dm * self.nao * self.nao + 1

        def zeros(shape, on):
            return (torch.zeros(shape, dtype=torch.int64, device=self.device)
                    if on else None)

        return (zeros((n_dm, E, E, NLIMB), with_j and has_tile),
                zeros((n_dm, E, E, NLIMB), with_k and has_tile),
                zeros((flat, NLIMB), with_j and has_flat),
                zeros((flat, NLIMB), with_k and has_flat))

    def _run_entry(self, entry, mode, dm_t, acc, e, with_j=True,
                   with_k=True, omega=0.0, chunk=None, stop=None):
        """Accumulate one plan entry into acc = (EJ, EK, AJ, AK) in mode
        ``mode`` at limb exponent e: its tasks up to ``stop`` (all when
        None) in launches of ``chunk`` tasks (the entry's own when None;
        a block entry always runs at its own).  dm_t: (n_dm, nao, nao) in
        the entry's tier dtype.  Of each launch only this rank's slice runs
        (module docstring); returns the number of tasks run."""
        EJ, EK, AJ, AK = acc
        nao, ls = self.nao, entry["ls"]
        n_dm = dm_t.shape[0]
        streams = [s for s, st in enumerate(STREAMS)
                   if (st[0] == "j" and with_j) or (st[0] == "k" and with_k)]
        B = chunk or self._entry_chunk(entry)
        n = entry["ntasks"] if stop is None else stop
        r, R = self._shard()
        ran = 0
        for c0 in range(0, n, B):
            # this rank's contiguous slice s0 .. s1 of the launch at c0
            b = min(B, n - c0)
            q = -(-b // R)
            s0, s1 = c0 + r * q, min(c0 + b, c0 + (r + 1) * q)
            if s1 <= s0:
                continue
            ran += s1 - s0
            tbls, idx, w, G = self._chunk_eri(entry, s0, omega, s1 - s0)
            if mode == "tile":
                for s in streams:
                    kind, xi, yi, ui, vi, _ = STREAMS[s]
                    tgt = EJ if kind == "j" else EK
                    for d in range(n_dm):
                        contract_tile(
                            G, self._stream_tables(ls, s), dm_t[d], nao,
                            (idx[ui], tbls[ui]["ao"]),
                            (idx[vi], tbls[vi]["ao"]),
                            (idx[xi], tbls[xi]["erow"]),
                            (idx[yi], tbls[yi]["erow"]),
                            w, tgt[d], e,
                        )
                continue
            # one ERI evaluation, n_dm contractions
            for d in range(n_dm):
                js, ks = self._chunk_streams(
                    entry, tbls, idx, w, G, dm_t.reshape(-1), with_j,
                    with_k, off=d * nao * nao)
                for a, strs in ((AJ, js), (AK, ks)):
                    for xy, vals, vidx in strs:
                        if mode == "scatter":
                            add_limbs_(a, vals, vidx, e)
                            continue
                        # block: segment-sum over the chunk's block
                        # rows, then scatter those rows only
                        rowkey, tb4c = self._block_keys(entry, s0, idx, xy)
                        rows, _ = block_accumulate(
                            vals, rowkey, entry["nrows"], entry["bound"],
                            e=e)
                        a.index_add_(
                            0, self._block_rows_index(tb4c, tbls, ls, xy),
                            rows.view(-1, NLIMB))
        return ran

    def _shard(self):
        """(rank, world) of the slices this engine runs: the test hook
        ``_split`` when set, else the group's ((0, 1) without one)."""
        return self._split or (self.rank, self.world)

    def _check_plan(self, plan, *call):
        """Raise unless every rank of the group runs the same plan with the
        same call shape and cuts its launches at the same tasks: a digest
        of each entry's ls, nprims, tier, accum, bound, idx and w, and of a
        block entry's chunk, gslot and tb4 (hashed once per entry, widened
        as built, so a plan loaded from disk hashes as the one built), of
        every entry's launch size this call (at most its task count; an
        ``'auto'`` engine's comes from the autotune tables, which may
        differ between hosts) and of ``call``, compared with one all_gather of 32 bytes."""
        import torch.distributed as dist

        h = hashlib.sha256(json.dumps(
            [call, [int(min(self._entry_chunk(x), x["ntasks"]))
                    for x in plan]]).encode())
        for x in plan:
            d = x.get("_digest")
            if d is None:
                hx = hashlib.sha256(json.dumps(
                    [[int(v) for v in x["ls"]], [int(v) for v in x["nprims"]],
                     x["tier"], x["accum"], float(x["bound"]),
                     int(x.get("chunk") or 0)]).encode())
                hx.update(np.ascontiguousarray(x["idx"], np.int32).data)
                hx.update(np.ascontiguousarray(x["w"], np.float32).data)
                for f in ("gslot", "tb4"):
                    if f in x:
                        hx.update(np.ascontiguousarray(x[f], np.int32).data)
                d = x["_digest"] = hx.digest()
            h.update(d)
        dev = (torch.device("cpu") if dist.get_backend(self.group) == "gloo"
               else self.device)
        mine = torch.frombuffer(bytearray(h.digest()),
                                dtype=torch.uint8).to(dev)
        got = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(got, mine, group=self.group)
        bad = [r for r, g in enumerate(got) if not torch.equal(g, mine)]
        if bad:
            raise RuntimeError(f"JKEngine rank {self.rank}: the plan or call "
                               f"differs from that of rank(s) {bad}")

    def _reduce(self, acc):
        """Sum the int64 limb accumulators over the group (all_reduce SUM,
        exact), so that every rank holds the one-device limbs.  Under gloo
        a CUDA accumulator goes through host memory, copied explicitly;
        ``timing`` adds reduce_s and reduce_bytes (the accumulators'
        bytes)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        host = dist.get_backend(self.group) == "gloo"
        nbytes = 0
        for a in acc:
            if a is None:
                continue
            if host and a.device.type != "cpu":
                h = a.cpu()
                dist.all_reduce(h, group=self.group)
                a.copy_(h)
            else:
                dist.all_reduce(a, group=self.group)
            nbytes += a.numel() * a.element_size()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        _add(self.timing, reduce_s=time.perf_counter() - t0,
             reduce_bytes=nbytes)

    def _run_plan(self, dm_int, with_j, with_k, omega=0.0, bucketed=False,
                  cond=None, plan=None):
        """Folded accumulators (vj, vk) as float64 numpy partials P of
        shape (nao, nao), or (n_dm, nao, nao) for a stack: the
        symmetric-dm result is P + P^T (8-fold orbit unfolding).  With a
        group, this rank's slices are summed with the others' in limb form
        before the decode; ``plan_stats['rank_tasks']`` is the tasks this
        rank ran of the plan, and with ``profile`` ``class_time`` is this
        rank's own."""
        nao = self.nao
        stacked = dm_int.ndim == 3
        n_dm = int(dm_int.shape[0]) if stacked else 1
        okey = float(omega or 0.0)
        if plan is None:
            if cond is None:
                cond = np.maximum.reduce(
                    [self.layout.dm_cond(d)
                     for d in dm_int.reshape(n_dm, nao, nao)])
            D = np.log(np.maximum(cond, 1e-30)).astype(np.float32)
            if bucketed:
                plan = self._ensure_bucket_plan(D, float(D.max()), okey)
            else:
                plan = self._plan = self._ensure_full_plan(
                    D, float(D.max()), okey)
        dev = self.device
        dm64 = torch.as_tensor(dm_int, dtype=torch.float64,
                               device=dev).reshape(n_dm, nao, nao)
        dms = {torch.float64: dm64.contiguous(),
               torch.float32: dm64.float().contiguous()}
        # one exponent for the whole build: every limb sum adds as integers
        e = max((bound_exponent(x["bound"]) for x in plan), default=0)
        # block reductions are single-dm: a stack runs them as scatter
        modes = ["scatter" if n_dm > 1 and x["accum"] == "block"
                 else x["accum"] for x in plan]
        acc = self._accumulators(n_dm, with_j, with_k, "tile" in modes,
                                 any(m != "tile" for m in modes))
        sharded = self.group is not None and self._split is None
        if sharded:
            self._check_plan(plan, n_dm, bool(with_j), bool(with_k), okey, e)
        rank_tasks = 0
        for entry, mode in zip(plan, modes):
            t0 = time.perf_counter()
            rank_tasks += self._run_entry(
                entry, mode, dms[tier_dtype(entry["tier"])], acc, e, with_j,
                with_k, okey)
            if self.profile:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                key = (entry["ls"], entry["nprims"], entry["tier"])
                self.class_time[key] = (self.class_time.get(key, 0.0)
                                        + time.perf_counter() - t0)
        self.plan_stats["rank_tasks"] = rank_tasks
        if sharded:
            self._reduce(acc)
        if self._limbs is not None:
            self._limbs.append(
                (tuple(None if a is None else a.clone() for a in acc), e))
        EJ, EK, AJ, AK = acc
        R = self._efold()
        shape = (n_dm, nao, nao) if stacked else (nao, nao)

        def total(on, flat, ext):
            if not on:
                return None
            out = None
            if flat is not None:
                out = limbs_to_f64(flat[:-1], e).view(n_dm, nao, nao)
            if ext is not None:
                fold = R.T @ limbs_to_f64(ext, e) @ R
                out = fold if out is None else out + fold
            if out is None:  # an empty plan
                return np.zeros(shape)
            return out.reshape(shape).cpu().numpy()

        return total(with_j, AJ, EJ), total(with_k, AK, EK)

    def get_jk(self, dm_mol, with_j=True, with_k=True, omega=0.0, hermi=1,
               bucketed=False, plan=None):
        """J/K matrices (mol AO basis) for one density (nao, nao) or a
        stack (n, nao, nao).

        ``omega > 0``: the long-range erf(omega*r)/r kernel, with its own
        re-screened plan.  ``hermi=0``: a non-symmetric density; J sees
        only its symmetric part, exactly ((ij|kl) is k<->l symmetric), and
        K splits as K(dm_s) + K(dm_a), the antisymmetric part unfolding as
        P - P^T.  ``bucketed``: take the plan from the per-density-bound
        buckets of the incremental path.  ``plan``: a task plan to run
        instead of the engine's own screened plan (e.g. one carried
        across by convert.plan_from_numpy)."""
        t0 = time.perf_counter()
        out = self._get_jk(np.asarray(dm_mol, np.float64), with_j, with_k,
                           float(omega or 0.0), hermi, bucketed, plan)
        self.timing["get_jk_s"] = time.perf_counter() - t0
        return out

    def _get_jk(self, dm, with_j, with_k, omega, hermi, bucketed, plan):
        lay = self.layout

        def is_sym(d):
            return hermi == 1 or (np.abs(d - d.T).max()
                                  < 1e-14 * max(np.abs(d).max(), 1.0))

        def unfold(p, sign=1.0):
            return lay.mat_to_mol(p + sign * p.T)

        if dm.ndim == 3:
            if self.accum != "block" and all(is_sym(d) for d in dm):
                # batched: the ERIs of every chunk are computed once and
                # contracted with all n_dm densities
                dms_int = np.stack([lay.dm_to_internal(d) for d in dm])
                pj, pk = self._run_plan(dms_int, with_j, with_k, omega,
                                        bucketed, plan=plan)
                vj = np.stack([unfold(p) for p in pj]) if with_j else None
                vk = np.stack([unfold(p) for p in pk]) if with_k else None
                return vj, vk
            outs = [self._get_jk(d, with_j, with_k, omega, hermi, bucketed,
                                 plan) for d in dm]
            vj = np.stack([o[0] for o in outs]) if with_j else None
            vk = np.stack([o[1] for o in outs]) if with_k else None
            return vj, vk

        sym = is_sym(dm)
        dms_int = lay.dm_to_internal(dm if sym else 0.5 * (dm + dm.T))
        cond = lay.dm_cond(dms_int)
        dma_int = None
        if not sym and with_k:
            dma_int = lay.dm_to_internal(0.5 * (dm - dm.T))
            # one shared density bound for both passes, so the plan is
            # not rebuilt twice per call
            cond = np.maximum(cond, lay.dm_cond(dma_int))
        if dma_int is not None and self.accum != "block":
            # the symmetric and antisymmetric passes as one stack
            pj, pk = self._run_plan(np.stack([dms_int, dma_int]), with_j,
                                    True, omega, bucketed, cond, plan)
            return (unfold(pj[0]) if with_j else None,
                    unfold(pk[0]) + unfold(pk[1], -1.0))
        vj, vk = self._run_plan(dms_int, with_j, with_k, omega, bucketed,
                                cond, plan)
        out_j = unfold(vj) if with_j else None
        out_k = unfold(vk) if with_k else None
        if dma_int is not None:
            _, pka = self._run_plan(dma_int, False, True, omega, bucketed,
                                    cond, plan)
            out_k = out_k + unfold(pka, -1.0)
        return out_j, out_k

    # ----------------------------------------------------- incremental
    def reset_incremental(self):
        """Drop cached J/K state (call when starting a new SCF)."""
        self._incr = {}

    def get_jk_incr(self, dm_mol, with_j=True, with_k=True, omega=0.0):
        """Incremental direct-SCF J/K: evaluate only on dm - dm_prev.

        J and K are linear in dm, so J(dm) = J(dm_prev) + J(ddm) exactly;
        as the SCF converges ||ddm|| decays and the density-weighted
        Schwarz screen of the bucketed plans drops most tasks."""
        key = (bool(with_j), bool(with_k), float(omega or 0.0))
        st = self._incr.get(key)
        dm = np.asarray(dm_mol, np.float64)
        if st is None:
            vj, vk = self.get_jk(dm, with_j, with_k, omega, bucketed=True)
        else:
            dvj, dvk = self.get_jk(dm - st["dm"], with_j, with_k, omega,
                                   bucketed=True)
            vj = st["vj"] + dvj if with_j else None
            vk = st["vk"] + dvk if with_k else None
        self._incr[key] = dict(dm=dm.copy(), vj=vj, vk=vk)
        return vj, vk


__all__ = ["JKEngine", "STREAMS", "stream_index_tables", "tile_entry",
           "flat_entry", "block_entry"]
