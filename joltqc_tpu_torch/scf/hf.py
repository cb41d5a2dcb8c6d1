"""Restricted Hartree-Fock driver: host SCF loop + device J/K Fock builds.

Port of ``joltqc_tpu/scf/hf.py``.  The O(N^4) Fock build runs on the
device through JKEngine; diagonalization, DIIS and the SCF loop stay on
the host in float64.  One-electron matrices come from the numpy oracle
below 60 shells and from scf/int1e.py (PyTorch float64) above.
"""

from __future__ import annotations

import time

import numpy as np
from scipy.linalg import eigh

from ..mol import intor_np
from ..mol.layout import BasisLayout
from ..mol.molecule import Molecule
from ..ops.cuda import resolve_device
from .diis import DIIS
from .jk_contracted import JKEngine


class RHF:
    # one-electron route: the Python-loop numpy oracle is O(minutes) at
    # ~500 AOs; from this shell count S/T/V run on the device
    _INT1E_DEVICE_MIN_SHELLS = 60

    def __init__(
        self,
        mol: Molecule,
        device=None,
        conv_tol: float = 1e-10,
        max_cycle: int = 60,
        cutoff_fp32: float = 1e-13,
        cutoff_fp64: float = 1e-6,
        verbose: int = 0,
        incremental: bool = False,
    ):
        if mol.nelectron % 2:
            raise ValueError("RHF needs an even electron count")
        self.device = resolve_device(device)
        self.mol = mol
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.verbose = verbose
        # incremental direct SCF (opt-in): Fock builds run on dm - dm_prev
        # (exact by linearity); the converged tail screens far fewer
        # tasks, at the cost of one task plan per density-bound bucket
        self.incremental = incremental
        self.cutoff_fp32 = cutoff_fp32
        self.cutoff_fp64 = cutoff_fp64
        self._setup()
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.converged = False
        self.scf_summary: dict = {}

    def _setup(self):
        self.layout = BasisLayout(self.mol)
        self.jk = JKEngine(self.layout, device=self.device,
                           cutoff_fp32=self.cutoff_fp32,
                           cutoff_fp64=self.cutoff_fp64)
        self._stv = None

    # ---------------------------------------------------------------- core
    def _int1e_stv(self):
        """Cached (S, T, V) from the device engine, one pass."""
        if self._stv is None:
            from .int1e import Int1eEngine

            self._stv = Int1eEngine(self.layout, device=self.device).stv()
        return self._stv

    def get_hcore(self):
        if len(self.mol.shells) >= self._INT1E_DEVICE_MIN_SHELLS:
            _, t, v = self._int1e_stv()
            return t + v
        return intor_np.kinetic(self.mol) + intor_np.nuclear(self.mol)

    def get_ovlp(self):
        if len(self.mol.shells) >= self._INT1E_DEVICE_MIN_SHELLS:
            return self._int1e_stv()[0]
        return intor_np.overlap(self.mol)

    def get_veff(self, dm):
        if self.incremental:
            vj, vk = self.jk.get_jk_incr(dm)
        else:
            vj, vk = self.jk.get_jk(dm)
        return vj - 0.5 * vk

    def energy_elec(self, dm, h, veff):
        return float(
            np.einsum("ij,ij->", dm, h) + 0.5 * np.einsum("ij,ij->", dm, veff)
        )

    def init_guess(self, s, h):
        # core hamiltonian guess
        _, c = eigh(h, s)
        nocc = self.mol.nelectron // 2
        return 2.0 * c[:, :nocc] @ c[:, :nocc].T

    # ------------------------------------------------------------ scanner
    def reset(self, mol: Molecule | None = None):
        """Point the driver at a new geometry, keeping settings; the
        kernels are geometry-independent, so only the host-side tables
        and task plan are rebuilt."""
        if mol is not None:
            self.mol = mol
        self._setup()
        self.converged = False
        return self

    def as_scanner(self):
        """Callable(mol) -> total energy; reuses the previous density as
        the initial guess when the basis dimension is unchanged."""

        def scan(mol: Molecule) -> float:
            nao_prev = self.mol.nao
            dm0 = getattr(self, "dm", None)
            self.reset(mol)
            if dm0 is not None and mol.nao == nao_prev:
                return self.kernel(dm0=dm0)
            return self.kernel()

        return scan

    def reset_incremental(self):
        """Drop incremental-SCF caches (start of a fresh SCF run)."""
        self.jk.reset_incremental()

    def kernel(self, dm0=None) -> float:
        t0 = time.time()
        self.reset_incremental()
        mol = self.mol
        s = self.get_ovlp()
        h = self.get_hcore()
        t_int1e = time.time() - t0
        e_nuc = mol.energy_nuc()
        dm = self.init_guess(s, h) if dm0 is None else np.asarray(dm0)
        diis = DIIS()
        nocc = mol.nelectron // 2
        e_last = 0.0
        jk_times = []
        for cycle in range(self.max_cycle):
            t1 = time.time()
            veff = self.get_veff(dm)
            jk_times.append(time.time() - t1)
            f = h + veff
            e_tot = self.energy_elec(dm, h, veff) + e_nuc
            f_diis = diis.update(s, dm, f)
            mo_e, mo_c = eigh(f_diis, s)
            dm = 2.0 * mo_c[:, :nocc] @ mo_c[:, :nocc].T
            de = e_tot - e_last
            if self.verbose:
                print(f"cycle {cycle:2d}  E = {e_tot:.12f}  dE = {de:.2e}  "
                      f"jk {jk_times[-1]:.3f} s", flush=True)
            if abs(de) < self.conv_tol and cycle > 0:
                self.converged = True
                break
            e_last = e_tot
        self.e_tot = e_tot
        self.mo_energy = mo_e
        self.mo_coeff = mo_c
        self.dm = dm
        self.scf_summary = {
            "cycles": cycle + 1,
            "wall_time": time.time() - t0,
            "int1e_time": t_int1e,
            "jk_time": float(sum(jk_times)),
            "jk_times": jk_times,
        }
        return e_tot


__all__ = ["RHF"]
