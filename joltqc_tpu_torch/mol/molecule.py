"""Standalone molecular structure: atoms + basis -> shells.

Copy of ``joltqc_tpu/mol/molecule.py``, effective core potentials and
the generated fallback basis included: an element missing from the basis
data gets the warned, generated basis of ``mol/basis_gen.py``.  The API
is Mole-like (``atom`` strings, ``nao``, ``ao_loc``, ``energy_nuc``), as
for the reference (JoltQC jqc/pyscf/basis.py).
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
    # effective core potential: {element symbol: ECPData} (mol/ecp.py);
    # replaces core electrons -- nelectron / energy_nuc / the nuclear
    # attraction integrals all use the effective charge Z - ncore
    ecp: dict = None

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
        ecp=None,
    ) -> "Molecule":
        """PySCF-style atom string: 'O 0 0 0; H 0 0 1' or newline-separated.

        ``ecp``: NWChem-format ECP text block, a path to such a file, the
        name of a shipped set (``mol/ecp_data/``), or a pre-parsed
        {symbol: ECPData} dict.
        """
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
        if isinstance(ecp, str):
            from .ecp import load_ecp

            ecp = load_ecp(ecp)
        m = cls(
            atom_symbols=symbols,
            coords=coords,
            charge=charge,
            spin=spin,
            cart=cart,
            basis=basis,
            ecp=ecp,
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
        generated = {}  # per-BUILD fallback cache (one warning per build)
        self.shells = []
        for ia, (sym, xyz) in enumerate(zip(self.atom_symbols, self.coords)):
            key = sym.capitalize()
            shells = basis_tab.get(key) or generated.get(key)
            if shells is None:
                # elements beyond the embedded data get a generated
                # (warned, reproducible) even-tempered fallback; see
                # mol/basis_gen.py.  Kept OUT of the shared load_basis
                # cache so the substitution warning fires for every
                # molecule that uses it, not only the first per process.
                from .basis_gen import fallback_shells

                shells = generated[key] = fallback_shells(key, self.basis)
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

    def atom_ncore(self, ia: int) -> int:
        """Core electrons replaced by an ECP on atom ia (0 if none)."""
        if not self.ecp:
            return 0
        data = self.ecp.get(self.atom_symbols[ia].capitalize())
        return data.ncore if data is not None else 0

    @property
    def atom_charges_eff(self) -> np.ndarray:
        """Nuclear charges minus ECP core electrons (what electrons see)."""
        z = self.atom_charges.astype(np.float64)
        if self.ecp:
            z = z - np.array([self.atom_ncore(i) for i in range(self.natm)])
        return z

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
