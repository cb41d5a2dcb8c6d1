"""BasisLayout: molecule -> internal cartesian AO space + AO transforms.

Copy of ``joltqc_tpu/mol/layout.py`` (the parts the RHF and RKS paths
use; ``pair_block`` is not needed).
Reference counterpart: JoltQC jqc/pyscf/basis.py (BasisLayout: dm
transforms).  The internal AO basis is cartesian in molecular shell
order; a single rectangular transform matrix P (internal x mol) folds
cart->sph and normalization, applied as dense f64 matmuls on the host.
"""

from __future__ import annotations

import numpy as np

from ..constants import nf_cart
from ..ops.harmonics import cart_norm_factors, cart_to_sph_factors
from .molecule import Molecule


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


__all__ = ["BasisLayout"]
