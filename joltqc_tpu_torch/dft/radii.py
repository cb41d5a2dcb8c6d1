"""Atomic size parameters for Becke partitioning (Bohr).

Copy of ``joltqc_tpu/dft/radii.py`` (numpy).

Bragg-Slater covalent radii (Slater 1964), the conventional choice for
Becke fuzzy-cell weights.  NOTE: Becke weights form a partition of unity
for ANY positive radii -- the quadrature stays exact in the dense-grid
limit regardless of these values; they only tune efficiency -- so small
transcription deviations are harmless (cf. the reference delegating this
to PySCF's ``gen_grid`` tables).
"""

import numpy as np

from ..mol.elements import BOHR

# Angstrom, index = atomic number (0 unused).  H uses Slater's 0.25 -> the
# commonly adopted 0.35 adjustment (Becke 1988 recommends scaling H).
_BRAGG_ANG = [
    0.0,
    0.35, 1.40,                                                  # H  He
    1.45, 1.05, 0.85, 0.70, 0.65, 0.60, 0.50, 1.50,              # Li..Ne
    1.80, 1.50, 1.25, 1.10, 1.00, 1.00, 1.00, 1.88,              # Na..Ar
    2.20, 1.80,                                                  # K  Ca
    1.60, 1.40, 1.35, 1.40, 1.40, 1.40, 1.35, 1.35, 1.35, 1.35,  # Sc..Zn
    1.30, 1.25, 1.15, 1.15, 1.15, 2.02,                          # Ga..Kr
    2.35, 2.00,                                                  # Rb Sr
    1.80, 1.55, 1.45, 1.45, 1.35, 1.30, 1.35, 1.40, 1.60, 1.55,  # Y..Cd
    1.55, 1.45, 1.45, 1.40, 1.40, 2.20,                          # In..Xe
    2.60, 2.15,                                                  # Cs Ba
    1.95, 1.85, 1.85, 1.85, 1.85, 1.85, 1.85, 1.80, 1.75, 1.75,  # La..Dy
    1.75, 1.75, 1.75, 1.75, 1.75,                                # Ho..Lu
    1.55, 1.45, 1.35, 1.35, 1.30, 1.35, 1.35, 1.35, 1.50,        # Hf..Hg
    1.90, 1.80, 1.60, 1.90, 1.85, 2.30,                          # Tl..Rn
]

BRAGG_BOHR = np.array(_BRAGG_ANG) / BOHR


def bragg_radius(z: int) -> float:
    """Bragg-Slater radius in Bohr for atomic number z."""
    if z < len(BRAGG_BOHR) and BRAGG_BOHR[z] > 0:
        return float(BRAGG_BOHR[z])
    return float(1.5 / BOHR)  # fallback for exotic elements


__all__ = ["BRAGG_BOHR", "bragg_radius"]
