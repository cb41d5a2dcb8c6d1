"""Basis sets, shells and the cartesian-to-spherical transform of the
reference.

The conventions are those of the program's AO basis, fixed here as data
and arithmetic: NWChem-format basis files with radially normalised
primitives, each contracted shell renormalised to unit self-overlap of
its (l,0,0) cartesian component, cartesian components ordered (lx
descending, then ly descending), spherical components m = -l..l (real
solid harmonics, Schlegel and Frisch, IJQC 54, 83 (1995)).  The
functions below are frozen copies of ``joltqc_tpu_torch/mol/basis.py``
and ``ops/harmonics.py``; the basis file is a copy of the program's.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from functools import lru_cache
from math import comb, factorial

import numpy as np

BASIS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "basis_data")
L_OF = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4}
# Bohr radius in Angstrom (CODATA 2010)
BOHR = 0.52917721092
ELEMENTS = ["X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
            "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar"]
Z_OF = {s.upper(): z for z, s in enumerate(ELEMENTS)}


@dataclass
class Shell:
    """One contracted shell: coefficients of unnormalised cartesian
    primitives, centre in Bohr."""

    l: int
    exps: np.ndarray
    coeffs: np.ndarray
    coord: np.ndarray
    atom: int

    @property
    def nprim(self):
        return len(self.exps)


def cart_components(l):
    return [(lx, ly, l - lx - ly) for lx in range(l, -1, -1)
            for ly in range(l - lx, -1, -1)]


def nf_cart(l):
    return (l + 1) * (l + 2) // 2


def double_factorial(n):
    out = 1
    while n > 0:
        out *= n
        n -= 2
    return out


def parse_nwchem(text):
    """{element: [(l, exps, coeffs), ...]} of NWChem-format basis text;
    an SP block gives an s and a p shell."""
    out = {}
    elem, ls, rows = None, None, []

    def flush():
        if elem is not None and ls is not None and rows:
            arr = np.array(rows)
            for col, l in enumerate(ls):
                c = arr[:, 1 + col]
                keep = c != 0.0
                out.setdefault(elem, []).append((l, arr[keep, 0].copy(),
                                                 c[keep].copy()))
        rows.clear()

    for ln in text.splitlines():
        s = ln.strip()
        if not s or s.startswith("#"):
            continue
        if s.upper().startswith("BASIS") or s.upper() == "END":
            flush()
            ls = None
            continue
        m = re.match(r"^([A-Za-z]{1,2})\s+([SPDFG]+)$", s)
        if m:
            flush()
            elem = m.group(1).capitalize()
            ls = [L_OF[c] for c in m.group(2).upper()]
            continue
        rows.append([float(x.replace("D", "E").replace("d", "e"))
                     for x in s.split()])
    flush()
    return out


@lru_cache(maxsize=None)
def load_basis(name):
    """The basis ``name`` from basis_data/ ('6-31g*' is 6-31gs.dat)."""
    fname = name.lower().replace("*", "s") + ".dat"
    with open(os.path.join(BASIS_DIR, fname)) as f:
        return parse_nwchem(f.read())


def normalize_contraction(l, exps, coeffs):
    """Coefficients of unnormalised cartesian primitives that give the
    contracted (l,0,0) component unit self-overlap."""
    norm = ((2 * exps / np.pi) ** 0.75 * (4 * exps) ** (l / 2.0)
            / np.sqrt(double_factorial(2 * l - 1)))
    c = coeffs * norm
    ab = exps[:, None] + exps[None, :]
    s = double_factorial(2 * l - 1) / (2 * ab) ** l * (np.pi / ab) ** 1.5
    return c / np.sqrt(c @ s @ c)


# ------------------------------------------------------ spherical harmonics
@lru_cache(maxsize=None)
def _sph_coef_table(l):
    comps = cart_components(l)
    idx = {c: i for i, c in enumerate(comps)}
    out = np.zeros((2 * l + 1, len(comps)))
    for m in range(-l, l + 1):
        ma = abs(m)
        norm = (1.0 / (2 ** ma * factorial(l))
                * np.sqrt(2.0 * factorial(l + ma) * factorial(l - ma)
                          / (2.0 if m == 0 else 1.0)))
        for j in range((l - ma) // 2 + 1):
            c1 = ((-1) ** j * comb(l, j) * comb(2 * l - 2 * j, l)
                  * factorial(l - 2 * j) // factorial(l - 2 * j - ma))
            for k1 in range(j + 1):
                for k2 in range(j - k1 + 1):
                    k3 = j - k1 - k2
                    tri = factorial(j) // (factorial(k1) * factorial(k2)
                                           * factorial(k3))
                    for t in range(ma + 1):
                        lx = 2 * k1 + ma - t
                        ly = 2 * k2 + t
                        lz = l - lx - ly
                        if lx < 0 or ly < 0 or lz < 0:
                            continue
                        if m >= 0:
                            if t % 2:
                                continue
                            ang = (-1) ** (t // 2)
                        else:
                            if t % 2 != 1:
                                continue
                            ang = (-1) ** ((t - 1) // 2)
                        out[m + l, idx[(lx, ly, lz)]] += (
                            norm * c1 * tri * comb(ma, t) * ang)
    return out


def _sphere_integral(p, q, r):
    if p % 2 or q % 2 or r % 2:
        return 0.0
    return (4.0 * np.pi * double_factorial(p - 1) * double_factorial(q - 1)
            * double_factorial(r - 1) / double_factorial(p + q + r + 1))


@lru_cache(maxsize=None)
def cart_to_sph(l):
    """C[m, cart]: unit-norm spherical functions from cartesian components
    normalised with the (l,0,0) convention."""
    raw = _sph_coef_table(l)
    comps = cart_components(l)
    g = np.array([[_sphere_integral(a + d, b + e, c + f)
                   for (d, e, f) in comps] for (a, b, c) in comps])
    out = np.zeros_like(raw)
    nx = np.sqrt(_sphere_integral(2 * l, 0, 0))
    for i in range(2 * l + 1):
        out[i] = raw[i] / np.sqrt(raw[i] @ g @ raw[i]) * nx
    return out


# ---------------------------------------------------------------- molecule
class RefMolecule:
    """Atoms (symbols, Bohr coordinates) with their basis: shells, the
    cartesian AO offsets and the (nao_cart, nao_sph) transform P, so that
    a spherical density D gives the cartesian P D P^T and a cartesian
    operator M the spherical P^T M P."""

    def __init__(self, symbols, coords_bohr, basis):
        self.symbols = list(symbols)
        self.coords = np.asarray(coords_bohr, np.float64)
        self.charges = np.array([Z_OF[s.upper()] for s in self.symbols],
                                np.float64)
        tab = load_basis(basis)
        self.shells = [Shell(l, e.copy(), normalize_contraction(l, e, c),
                             self.coords[ia].copy(), ia)
                       for ia, s in enumerate(self.symbols)
                       for (l, e, c) in tab[s.capitalize()]]
        nfc = [nf_cart(sh.l) for sh in self.shells]
        nfs = [2 * sh.l + 1 for sh in self.shells]
        self.ao_cart = np.concatenate([[0], np.cumsum(nfc)]).astype(np.int64)
        self.ao_sph = np.concatenate([[0], np.cumsum(nfs)]).astype(np.int64)
        self.nao_cart = int(self.ao_cart[-1])
        self.nao = int(self.ao_sph[-1])
        P = np.zeros((self.nao_cart, self.nao))
        for i, sh in enumerate(self.shells):
            P[self.ao_cart[i]:self.ao_cart[i + 1],
              self.ao_sph[i]:self.ao_sph[i + 1]] = cart_to_sph(sh.l).T
        self.P = P

    @property
    def nelectron(self):
        return int(round(self.charges.sum()))

    def energy_nuc(self):
        d = self.coords[:, None] - self.coords[None]
        r = np.sqrt((d * d).sum(-1))
        zz = self.charges[:, None] * self.charges[None]
        iu = np.triu_indices(len(self.symbols), 1)
        return float((zz[iu] / r[iu]).sum())
