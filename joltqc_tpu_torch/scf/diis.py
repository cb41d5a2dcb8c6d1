"""Pulay DIIS (commutator form) for SCF convergence acceleration.

The reference delegates the SCF loop (incl. DIIS) to PySCF/GPU4PySCF
(SURVEY.md section 1: 'The SCF loop itself stays in PySCF'); since this
framework is standalone, it carries its own host-side implementation.
"""

from __future__ import annotations

import numpy as np


class DIIS:
    def __init__(self, space: int = 8):
        self.space = space
        self.errs: list[np.ndarray] = []
        self.focks: list[np.ndarray] = []

    def update(self, s, dm, f) -> np.ndarray:
        err = f @ dm @ s - s @ dm @ f
        self.errs.append(err.ravel())
        self.focks.append(f.copy())
        if len(self.errs) > self.space:
            self.errs.pop(0)
            self.focks.pop(0)
        n = len(self.errs)
        if n < 2:
            return f
        B = np.empty((n + 1, n + 1))
        B[-1, :] = -1.0
        B[:, -1] = -1.0
        B[-1, -1] = 0.0
        for i in range(n):
            for j in range(i, n):
                B[i, j] = B[j, i] = self.errs[i] @ self.errs[j]
        rhs = np.zeros(n + 1)
        rhs[-1] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            c = np.linalg.lstsq(B, rhs, rcond=None)[0][:n]
        return sum(ci * fi for ci, fi in zip(c, self.focks))
