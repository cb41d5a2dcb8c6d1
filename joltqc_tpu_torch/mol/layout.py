"""BasisLayout: molecule -> internal cartesian AO space + AO transforms.

Copy of ``joltqc_tpu/mol/layout.py``: the transforms, the l groups, the
density pooling and the primitive-pair blocks (``PrimPairBlock``,
``pair_block``, ``lpairs``; host numpy, the reference's arrays exactly).
Reference counterpart: JoltQC jqc/pyscf/basis.py (BasisLayout: dm
transforms).  The internal AO basis is cartesian in molecular shell
order; a single rectangular transform matrix P (internal x mol) folds
cart->sph and normalization, applied as dense f64 matmuls on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import nf_cart
from ..ops.harmonics import cart_norm_factors, cart_to_sph_factors
from .molecule import Molecule


@dataclass
class PrimPairBlock:
    """All primitive pairs for one angular-momentum group pair (li, lj)."""

    li: int
    lj: int
    # per primitive pair arrays, length n:
    A: np.ndarray  # (n, 3)
    B: np.ndarray  # (n, 3)
    ea: np.ndarray  # (n,)
    eb: np.ndarray  # (n,)
    cab: np.ndarray  # (n,) coefficient product
    ao_i: np.ndarray  # (n,) int32 internal AO start of shell i
    ao_j: np.ndarray  # (n,) int32
    ish: np.ndarray  # (n,) int32 shell index (for dm_cond screening)
    jsh: np.ndarray  # (n,) int32
    diag: np.ndarray  # (n,) bool, ish == jsh (shell-level symmetry weight)
    pair_id: np.ndarray  # (n,) int32 shell-pair id (i*(i+1)/2 + j for i>=j)
    q_log: np.ndarray = None  # (n,) f32 log sqrt(max (ab|ab)), set lazily

    @property
    def n(self):
        return len(self.ea)


class BasisLayout:
    def __init__(self, mol: Molecule):
        self.mol = mol
        shells = mol.shells
        self.nbas = len(shells)
        # internal = cartesian AOs in shell order
        sizes = [nf_cart(sh.l) for sh in shells]
        self.ao_loc_int = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        self.nao_int = int(self.ao_loc_int[-1])
        self.nao_mol = mol.nao
        self._build_transform()
        self._build_groups()
        self._pair_blocks: dict = {}

    # ------------------------------------------------------------ transform
    def _build_transform(self):
        mol = self.mol
        P = np.zeros((self.nao_int, self.nao_mol))
        ao_mol = mol.ao_loc
        for i, sh in enumerate(mol.shells):
            r0, r1 = self.ao_loc_int[i], self.ao_loc_int[i + 1]
            c0, c1 = ao_mol[i], ao_mol[i + 1]
            if mol.cart:
                P[r0:r1, c0:c1] = np.diag(1.0 / cart_norm_factors(sh.l))
            else:
                P[r0:r1, c0:c1] = cart_to_sph_factors(sh.l).T
        self.P = P

    def dm_to_internal(self, dm: np.ndarray) -> np.ndarray:
        """Density matrix mol AO -> internal cartesian AO (host f64)."""
        return self.P @ dm @ self.P.T

    def mat_to_mol(self, mat: np.ndarray) -> np.ndarray:
        """Operator matrix internal -> mol AO (host f64)."""
        return self.P.T @ mat @ self.P

    # ------------------------------------------------------------ groups
    def _build_groups(self):
        groups: dict[int, list[int]] = {}
        for i, sh in enumerate(self.mol.shells):
            groups.setdefault(sh.l, []).append(i)
        self.groups = {l: np.array(idx, np.int32) for l, idx in sorted(groups.items())}
        self.ls = sorted(self.groups)

    # ------------------------------------------------------------ prim pairs
    def pair_block(self, li: int, lj: int) -> PrimPairBlock:
        """Primitive pairs for group pair (li >= lj ordering of shells).

        For li == lj only shell pairs ish >= jsh are enumerated (with ALL
        ordered primitive combinations); symmetry weights are shell-level.
        """
        key = (li, lj)
        if key in self._pair_blocks:
            return self._pair_blocks[key]
        shells = self.mol.shells
        gi, gj = self.groups[li], self.groups[lj]
        rows = {k: [] for k in ("A", "B", "ea", "eb", "cab", "ao_i", "ao_j",
                                "ish", "jsh", "diag", "pair_id")}
        for ish in gi:
            si = shells[ish]
            for jsh in gj:
                if li == lj and jsh > ish:
                    continue
                sj = shells[jsh]
                hi, lo = max(ish, jsh), min(ish, jsh)
                for eai, cai in zip(si.exps, si.coeffs):
                    for ebj, cbj in zip(sj.exps, sj.coeffs):
                        rows["A"].append(si.coord)
                        rows["B"].append(sj.coord)
                        rows["ea"].append(eai)
                        rows["eb"].append(ebj)
                        rows["cab"].append(cai * cbj)
                        rows["ao_i"].append(self.ao_loc_int[ish])
                        rows["ao_j"].append(self.ao_loc_int[jsh])
                        rows["ish"].append(ish)
                        rows["jsh"].append(jsh)
                        rows["diag"].append(ish == jsh)
                        rows["pair_id"].append(hi * (hi + 1) // 2 + lo)
        f64 = {k: np.array(rows[k], np.float64) for k in ("ea", "eb", "cab")}
        i32 = {k: np.array(rows[k], np.int32)
               for k in ("ao_i", "ao_j", "ish", "jsh", "pair_id")}
        blk = PrimPairBlock(
            li, lj,
            A=np.array(rows["A"], np.float64).reshape(-1, 3),
            B=np.array(rows["B"], np.float64).reshape(-1, 3),
            diag=np.array(rows["diag"], bool), **f64, **i32,
        )
        self._pair_blocks[key] = blk
        return blk

    def lpairs(self):
        """All (li, lj) with li >= lj present in the molecule."""
        return [(a, b) for a in self.ls for b in self.ls if a >= b]

    # ------------------------------------------------------------ dm_cond
    def dm_cond(self, dm_int: np.ndarray) -> np.ndarray:
        """Shell-block max |dm| pooling (nbas, nbas), vectorized host-side.

        Reference: max_block_pooling
        (JoltQC jqc/backend/linalg_helper.py:125)."""
        ad = np.abs(np.asarray(dm_int, np.float64))
        starts = self.ao_loc_int[:-1]
        rows = np.maximum.reduceat(ad, starts, axis=0)
        return np.maximum.reduceat(rows, starts, axis=1)

    def dm_cond_l2(self, dm_int: np.ndarray) -> np.ndarray:
        """Shell-block L2-norm pooling (nbas, nbas).

        Reference: l2_block_pooling
        (JoltQC jqc/backend/linalg_helper.py:214 -- unused by the
        reference main path; kept for inventory/screening-research
        parity).  sqrt(sum_{block} dm^2) per shell block."""
        sq = np.square(np.asarray(dm_int, np.float64))
        starts = self.ao_loc_int[:-1]
        rows = np.add.reduceat(sq, starts, axis=0)
        return np.sqrt(np.add.reduceat(rows, starts, axis=1))


__all__ = ["BasisLayout", "PrimPairBlock"]
