"""Host-side task construction for the contracted J/K engine.

Copy of ``joltqc_tpu/scf/tasks.py`` (numpy only).  The reference screens
shell-pair tiles on the GPU per SCF iteration with an atomic two-sided
queue (JoltQC jqc/backend/jk/screen_jk_tasks.cu).  Here screening is a
one-time HOST precomputation -- shell pairs are Schwarz-bounded, sorted,
and expanded into per-class task index arrays that stay resident on the
device for the whole SCF:

 - shells are grouped into classes (l, nprim); a task class is a quartet
   of shell classes;
 - tasks are (pair1, pair2) index pairs into per-class shell tables (the
   kernels gather geometry from small tables -- no per-iteration
   host->device geometry traffic);
 - the FP32/FP64 tier split uses the Schwarz product with a density
   bound (reference: per-element dq > cutoff_fp64 routing,
   screen_jk_tasks.cu:258-271).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..mol.layout import BasisLayout


@dataclass
class ShellClass:
    l: int
    nprim: int
    coords: np.ndarray  # (S, 3) f64
    exps: np.ndarray  # (S, nprim)
    coefs: np.ndarray  # (S, nprim)
    ao: np.ndarray  # (S,) int32 internal AO start
    shell_ids: np.ndarray  # (S,) int32

    @property
    def nshell(self):
        return len(self.ao)


@dataclass
class PairClass:
    ci: int  # index into the class list
    cj: int
    i_loc: np.ndarray  # (P,) int32, class-local shell index (center a)
    j_loc: np.ndarray  # (P,) int32 (center b)
    diag: np.ndarray  # (P,) bool, same shell twice
    q_log: np.ndarray = None  # (P,) f32 log sqrt(max |(ab|ab)|)
    # per-omega Schwarz bounds (erf-attenuated), aligned to the q-sorted
    # pair order; populated lazily by the engine for omega > 0 plans
    q_omega: dict = field(default_factory=dict)

    @property
    def npair(self):
        return len(self.i_loc)


NPRIM_MAX = 3  # segment length cap (reference: jqc/constants.py NPRIM_MAX=3)


def _segments(nprim: int):
    """Split a contraction of nprim primitives into <=NPRIM_MAX segments,
    each bucketed to length 1 or NPRIM_MAX (zero-padded)."""
    segs = []
    s = 0
    while s < nprim:
        n = min(NPRIM_MAX, nprim - s)
        segs.append((s, n, 1 if n == 1 else NPRIM_MAX))
        s += n
    return segs


def build_shell_classes(
    layout: BasisLayout, merge_nprim: bool = False
) -> list[ShellClass]:
    """Group shell *segments* by (l, nprim bucket) + one pad shell each.

    Deep contractions are split into <=3-primitive segments sharing the
    parent's AO columns (the engine's fold recombines them exactly) --
    the analogue of the reference's split_basis
    (JoltQC jqc/pyscf/basis.py:678), keeping the class count
    independent of contraction depth.

    ``merge_nprim=True`` collapses the 1-prim and 3-prim buckets of each
    l into ONE class (1-prim segments zero-padded to the group's max
    bucket).  This cuts the number of classes and launches per Fock
    build by up to 16x (2^4 bucket combos per l-quartet); the ERI
    kernel skips the zero-coefficient padded primitives.
    """
    mol = layout.mol
    if merge_nprim:
        # one bucket per l: the max segment length present in that group
        lmax_bucket: dict[int, int] = {}
        for sh in mol.shells:
            for s0, n, bucket in _segments(sh.nprim):
                lmax_bucket[sh.l] = max(lmax_bucket.get(sh.l, 1), bucket)
    groups: dict[tuple[int, int], list] = {}
    for i, sh in enumerate(mol.shells):
        for s0, n, bucket in _segments(sh.nprim):
            if merge_nprim:
                bucket = lmax_bucket[sh.l]
            groups.setdefault((sh.l, bucket), []).append((i, s0, n))
    out = []
    for (l, bucket), segs in sorted(groups.items()):
        S = len(segs)
        coords = np.zeros((S + 1, 3))
        exps = np.ones((S + 1, bucket))
        coefs = np.zeros((S + 1, bucket))  # pad shell & pad prims: coef 0
        ao = np.zeros(S + 1, np.int32)
        ids = np.full(S + 1, -1, np.int32)
        for k, (i, s0, n) in enumerate(segs):
            sh = mol.shells[i]
            coords[k] = sh.coord
            exps[k, :n] = sh.exps[s0 : s0 + n]
            coefs[k, :n] = sh.coeffs[s0 : s0 + n]
            ao[k] = layout.ao_loc_int[i]
            ids[k] = i
        out.append(ShellClass(l, bucket, coords, exps, coefs, ao, ids))
    return out


def build_pair_classes(classes: list[ShellClass]) -> list[PairClass]:
    """All unordered shell pairs, grouped by (class_i, class_j), ci >= cj."""
    out = []
    for ci in range(len(classes)):
        for cj in range(ci + 1):
            Si = classes[ci].nshell
            Sj = classes[cj].nshell
            if ci == cj:
                iu, ju = np.triu_indices(Si)  # i <= j; use (j, i) for i >= j
                i_loc, j_loc = ju.astype(np.int32), iu.astype(np.int32)
            else:
                i_loc = np.repeat(np.arange(Si, dtype=np.int32), Sj)
                j_loc = np.tile(np.arange(Sj, dtype=np.int32), Si)
            diag = (ci == cj) & (i_loc == j_loc)
            out.append(PairClass(ci, cj, i_loc, j_loc, np.asarray(diag)))
    return out


def sort_pairs_by_q(pc: PairClass):
    """Sort pair lists by descending Schwarz bound (prefix screening)."""
    order = np.argsort(-pc.q_log, kind="stable")
    pc.i_loc = pc.i_loc[order]
    pc.j_loc = pc.j_loc[order]
    pc.diag = pc.diag[order]
    pc.q_log = pc.q_log[order]


def build_quartet_tasks(
    p1: PairClass,
    p2: PairClass,
    same: bool,
    log_cut: float,
    log_cut64: float,
):
    """Screened tasks for a bra-pair-class x ket-pair-class combination.

    Returns (t1, t2, w, tier64): index arrays into the (q-sorted) pair
    lists, symmetry weights, and the DF64-tier mask.  Requires q-sorted
    pairs; exploits sortedness so cost is O(kept + P1 log P2).
    """
    q1, q2 = p1.q_log, p2.q_log
    # for each bra pair, the number of ket pairs with q1 + q2 > log_cut:
    # q2 is descending, so count = #{j : -q2[j] < q1 - log_cut}
    counts = np.searchsorted(-q2, q1 - log_cut, side="left")
    if same:
        counts = np.minimum(counts, np.arange(1, len(q1) + 1))
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0), np.zeros(0, bool)
    t1 = np.repeat(np.arange(len(q1), dtype=np.int32), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t2 = (np.arange(total, dtype=np.int64) - np.repeat(starts, counts)).astype(
        np.int32
    )
    w = np.where(p1.diag[t1], 0.5, 1.0) * np.where(p2.diag[t2], 0.5, 1.0)
    if same:
        w = w * np.where(t1 == t2, 0.5, 1.0)
    tier64 = (q1[t1] + q2[t2]) > log_cut64
    return t1, t2, w, tier64


__all__ = [
    "ShellClass",
    "PairClass",
    "build_shell_classes",
    "build_pair_classes",
    "sort_pairs_by_q",
    "build_quartet_tasks",
]
