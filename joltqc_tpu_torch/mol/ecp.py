"""Effective core potential data model + NWChem-format parser.

Copy of ``joltqc_tpu/mol/ecp.py`` (numpy only); ``load_ecp`` reads this
package's own ``mol/ecp_data/``.  Reference counterpart: PySCF's
``mol._ecpbas`` consumed by JoltQC jqc/backend/ecp.py.  Standalone
equivalent: a Molecule
carries ``ecp`` = {element: ECPData}; the SCF classes add the ECP matrix to
hcore and subtract core electrons.

Semi-local ansatz:
  U(r) = U_L(r) + sum_{l=0}^{L-1} sum_m |lm> [U_l(r) - U_L(r)] <lm|
  U_l(r) = sum_k d_k r^(n_k - 2) exp(-zeta_k r^2),   n_k in {0, 1, 2}

Channel l = -1 denotes the local part U_L (PySCF convention).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ECPChannel:
    l: int  # -1 = local channel U_L
    powers: np.ndarray  # (k,) int, the r exponent n_k (0, 1 or 2)
    exps: np.ndarray  # (k,) zeta
    coefs: np.ndarray  # (k,) d


@dataclass
class ECPData:
    ncore: int
    channels: list[ECPChannel] = field(default_factory=list)

    @property
    def lmax_semilocal(self) -> int:
        ls = [c.l for c in self.channels if c.l >= 0]
        return max(ls) if ls else -1

    def local(self) -> ECPChannel | None:
        for c in self.channels:
            if c.l == -1:
                return c
        return None


_L_NAMES = {"ul": -1, "s": 0, "p": 1, "d": 2, "f": 3, "g": 4, "h": 5}


def parse_nwchem_ecp(text: str) -> dict[str, ECPData]:
    """Parse NWChem-format ECP blocks.

    Format:
        ECP
        Na nelec 10
        Na ul
              2     175.55   -10.0
        Na S
              2      243.36    3.0
        END
    """
    out: dict[str, ECPData] = {}
    cur: ECPData | None = None
    cur_chan: ECPChannel | None = None
    rows: list[tuple[int, float, float]] = []

    def flush_chan():
        nonlocal cur_chan, rows
        if cur_chan is not None and rows:
            cur_chan.powers = np.array([r[0] for r in rows], int)
            cur_chan.exps = np.array([r[1] for r in rows])
            cur_chan.coefs = np.array([r[2] for r in rows])
            cur.channels.append(cur_chan)
        cur_chan, rows = None, []

    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if not line or line.upper() in ("ECP", "END"):
            continue
        parts = line.split()
        if parts[0][0].isalpha():
            sym = parts[0].capitalize()
            if len(parts) >= 3 and parts[1].lower() == "nelec":
                flush_chan()
                cur = out.setdefault(sym, ECPData(ncore=int(parts[2])))
            else:
                flush_chan()
                if cur is None or sym not in out:
                    cur = out.setdefault(sym, ECPData(ncore=0))
                lname = parts[1].lower()
                if lname not in _L_NAMES:
                    raise ValueError(f"unknown ECP channel '{parts[1]}'")
                cur_chan = ECPChannel(
                    _L_NAMES[lname], np.zeros(0, int), np.zeros(0), np.zeros(0)
                )
        else:
            rows.append((int(parts[0]), float(parts[1]), float(parts[2])))
    flush_chan()
    return out


_ECP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ecp_data")


def available_ecps() -> list[str]:
    if not os.path.isdir(_ECP_DIR):
        return []
    return sorted(
        f[:-4] for f in os.listdir(_ECP_DIR) if f.endswith(".dat")
    )


def load_ecp(spec: str) -> dict[str, ECPData]:
    """Resolve an ECP spec: raw NWChem text | file path | shipped name.

    The reference resolves names like ``ecp="def2-tzvpp"`` through
    PySCF's bundled ECP library; this standalone build embeds data files
    under ``mol/ecp_data/`` instead.  Literature ECP parameter tables
    (def2-ECP etc.) could not be sourced in this zero-network build
    environment with auditable digits, so the shipped files are
    documented MODEL potentials (see ecp_data/README) -- pass a path to
    an NWChem-format file for production data.
    """
    if "\n" in spec:
        return parse_nwchem_ecp(spec)
    if os.path.exists(spec):
        with open(spec) as f:
            return parse_nwchem_ecp(f.read())
    path = os.path.join(_ECP_DIR, spec.lower() + ".dat")
    if os.path.exists(path):
        with open(path) as f:
            return parse_nwchem_ecp(f.read())
    raise FileNotFoundError(
        f"ECP {spec!r} not found; shipped sets: {available_ecps()}; or "
        f"pass NWChem-format ECP text / a path to an NWChem file"
    )


__all__ = [
    "ECPChannel", "ECPData", "parse_nwchem_ecp", "load_ecp",
    "available_ecps",
]
