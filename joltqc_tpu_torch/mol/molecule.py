"""Standalone molecular structure: atoms + basis -> shells.

Copy of ``joltqc_tpu/mol/molecule.py`` without ECPs and without the
generated fallback basis: an element missing from the basis data raises.
The API is Mole-like (``atom`` strings, ``nao``, ``ao_loc``,
``energy_nuc``), as for the reference (JoltQC jqc/pyscf/basis.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .basis import load_basis, normalize_contraction
from .elements import BOHR, charge_of
from ..constants import nf_cart, nf_sph


@dataclass
class Shell:
    """One contracted shell: unnormalized-cartesian-primitive coefficients."""

    l: int
    exps: np.ndarray  # (nprim,)
    coeffs: np.ndarray  # (nprim,) includes all normalization
    coord: np.ndarray  # (3,) Bohr
    atom_idx: int

    @property
    def nprim(self) -> int:
        return len(self.exps)


@dataclass
class Molecule:
    atom_symbols: list[str] = field(default_factory=list)
    coords: np.ndarray = None  # (natm, 3) Bohr
    charge: int = 0
    spin: int = 0  # 2S (n_alpha - n_beta)
    cart: bool = False
    basis: str = "sto-3g"
    shells: list[Shell] = field(default_factory=list)

    # ------------------------------------------------------------ build
    @classmethod
    def from_atom_string(
        cls,
        atom: str,
        basis: str = "sto-3g",
        unit: str = "angstrom",
        charge: int = 0,
        spin: int = 0,
        cart: bool = False,
    ) -> "Molecule":
        """PySCF-style atom string: 'O 0 0 0; H 0 0 1' or newline-separated."""
        symbols, coords = [], []
        for entry in atom.replace(";", "\n").splitlines():
            parts = entry.split()
            if not parts:
                continue
            symbols.append(parts[0])
            coords.append([float(x) for x in parts[1:4]])
        coords = np.asarray(coords, np.float64)
        if unit.lower().startswith("a"):
            coords = coords / BOHR
        m = cls(
            atom_symbols=symbols,
            coords=coords,
            charge=charge,
            spin=spin,
            cart=cart,
            basis=basis,
        )
        m.build()
        return m

    @classmethod
    def from_xyz_file(cls, path: str, **kw) -> "Molecule":
        with open(path) as f:
            lines = f.read().splitlines()
        natm = int(lines[0].split()[0])
        body = "\n".join(lines[2 : 2 + natm])
        return cls.from_atom_string(body, **kw)

    def build(self) -> "Molecule":
        basis_tab = load_basis(self.basis)
        self.shells = []
        for ia, (sym, xyz) in enumerate(zip(self.atom_symbols, self.coords)):
            key = sym.capitalize()
            shells = basis_tab.get(key)
            if shells is None:
                raise KeyError(
                    f"element {key!r} has no data in basis {self.basis!r}"
                )
            for raw in shells:
                coeffs = normalize_contraction(raw.l, raw.exps, raw.coeffs)
                self.shells.append(
                    Shell(raw.l, raw.exps.copy(), coeffs, np.asarray(xyz), ia)
                )
        return self

    # ------------------------------------------------------------ queries
    @property
    def natm(self) -> int:
        return len(self.atom_symbols)

    @property
    def atom_charges(self) -> np.ndarray:
        return np.array([charge_of(s) for s in self.atom_symbols])

    @property
    def atom_charges_eff(self) -> np.ndarray:
        """Nuclear charges as float64 (no ECP in the port yet)."""
        return self.atom_charges.astype(np.float64)

    @property
    def nelectron(self) -> int:
        return int(round(self.atom_charges_eff.sum())) - self.charge

    def nf(self, l: int) -> int:
        return nf_cart(l) if self.cart else nf_sph(l)

    @property
    def nao(self) -> int:
        return sum(self.nf(sh.l) for sh in self.shells)

    @property
    def ao_loc(self) -> np.ndarray:
        sizes = [self.nf(sh.l) for sh in self.shells]
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)

    def energy_nuc(self) -> float:
        z = self.atom_charges_eff
        r = self.coords
        e = 0.0
        for i in range(self.natm):
            for j in range(i):
                e += z[i] * z[j] / np.linalg.norm(r[i] - r[j])
        return e

    def ao_labels(self) -> list[str]:
        from ..ops.harmonics import cart_components

        out = []
        for sh in self.shells:
            lsym = "spdfghi"[sh.l]
            if self.cart:
                for (a, b, c) in cart_components(sh.l):
                    out.append(
                        f"{sh.atom_idx}{self.atom_symbols[sh.atom_idx]} "
                        f"{lsym}{'x'*a}{'y'*b}{'z'*c}"
                    )
            else:
                for m in range(-sh.l, sh.l + 1):
                    out.append(
                        f"{sh.atom_idx}{self.atom_symbols[sh.atom_idx]} {lsym}({m:+d})"
                    )
        return out


__all__ = ["Molecule", "Shell"]
