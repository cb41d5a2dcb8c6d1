"""Basis set parsing and GTO normalization.

Standalone equivalent of the basis handling the reference gets from PySCF
(`gto.Mole` construction feeding JoltQC jqc/pyscf/basis.py).
Reads NWChem-format basis files (the de-facto interchange format, so users
can drop in any basis from the Basis Set Exchange); a few common sets are
embedded under ``basis_data/``.

Normalization convention (matches standard Gaussian-basis practice):
 - file coefficients refer to radially-normalized primitives,
 - each contracted shell is renormalized to unit self-overlap of its
   (l,0,0) cartesian component,
 - spherical AOs then have exactly unit norm (see ops/harmonics.py).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from ..ops.harmonics import double_factorial

_BASIS_DIR = os.path.join(os.path.dirname(__file__), "basis_data")

L_OF = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4, "H": 5, "I": 6}


@dataclass
class RawShell:
    """One contracted shell as read from a basis file (un-normalized)."""

    l: int
    exps: np.ndarray  # (nprim,)
    coeffs: np.ndarray  # (nprim,) raw contraction coefficients


def available_basis_sets():
    return sorted(
        f[:-4] for f in os.listdir(_BASIS_DIR) if f.endswith(".dat")
    )


_NAME_ALIASES = {"6-31g*": "6-31gs", "6-31g(d)": "6-31gs"}


def _basis_path(name: str) -> str:
    key = _NAME_ALIASES.get(name.lower(), name.lower())
    fname = key.replace("*", "_st_").replace("/", "_") + ".dat"
    path = os.path.join(_BASIS_DIR, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"basis set {name!r} not found; embedded sets: "
            f"{available_basis_sets()}; or pass a path to an NWChem-format file"
        )
    return path


def parse_nwchem(text: str) -> dict[str, list[RawShell]]:
    """Parse NWChem-format basis text -> {element: [RawShell, ...]}."""
    out: dict[str, list[RawShell]] = {}
    lines = [
        ln
        for ln in text.splitlines()
        if ln.strip() and not ln.strip().startswith("#")
    ]
    i = 0
    cur_elem = None
    cur_ls: list[int] | None = None
    rows: list[list[float]] = []

    def flush():
        nonlocal rows, cur_ls, cur_elem
        if cur_elem is None or cur_ls is None or not rows:
            rows, cur_ls = [], None
            return
        arr = np.array(rows)
        exps = arr[:, 0]
        for col, l in enumerate(cur_ls):
            coeffs = arr[:, 1 + col]
            keep = coeffs != 0.0
            out.setdefault(cur_elem, []).append(
                RawShell(l, exps[keep].copy(), coeffs[keep].copy())
            )
        rows, cur_ls = [], None

    for ln in lines:
        s = ln.strip()
        up = s.upper()
        if up.startswith("BASIS") or up == "END":
            flush()
            continue
        m = re.match(r"^([A-Za-z]{1,2})\s+([SPDFGHI]+)$", s)
        if m:
            flush()
            cur_elem = m.group(1).capitalize()
            block = m.group(2).upper()
            cur_ls = [L_OF[c] for c in block]  # e.g. "SP" -> [0, 1]
            continue
        nums = [float(x.replace("D", "E").replace("d", "e")) for x in s.split()]
        rows.append(nums)
    flush()
    return out


_basis_cache: dict[str, dict[str, list[RawShell]]] = {}


def load_basis(name: str) -> dict[str, list[RawShell]]:
    key = name.lower()
    if key not in _basis_cache:
        path = name if os.path.exists(name) else _basis_path(name)
        with open(path) as f:
            _basis_cache[key] = parse_nwchem(f.read())
    return _basis_cache[key]


def gto_norm(l: int, alpha) -> np.ndarray:
    """Norm of the (l,0,0) cartesian primitive x^l exp(-alpha r^2)."""
    alpha = np.asarray(alpha, np.float64)
    return (
        (2 * alpha / np.pi) ** 0.75
        * (4 * alpha) ** (l / 2.0)
        / np.sqrt(double_factorial(2 * l - 1))
    )


def normalize_contraction(l: int, exps: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Return coefficients for unnormalized cartesian primitives such that
    the contracted (l,0,0) component has unit self-overlap."""
    c = np.asarray(coeffs, np.float64) * gto_norm(l, exps)
    # <x^l e^{-a r^2} | x^l e^{-b r^2}> = (2l-1)!! / (2(a+b))^l * (pi/(a+b))^{3/2}
    ab = exps[:, None] + exps[None, :]
    s_prim = (
        double_factorial(2 * l - 1)
        / (2 * ab) ** l
        * (np.pi / ab) ** 1.5
    )
    s = c @ s_prim @ c
    return c / np.sqrt(s)


__all__ = [
    "RawShell",
    "parse_nwchem",
    "load_basis",
    "available_basis_sets",
    "gto_norm",
    "normalize_contraction",
]
