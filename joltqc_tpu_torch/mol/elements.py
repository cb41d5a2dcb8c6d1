"""Element tables: symbols, atomic numbers."""

ELEMENTS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn",
]

SYMBOL_TO_Z = {s: z for z, s in enumerate(ELEMENTS)}
# case-insensitive lookup helper
_UPPER_TO_Z = {s.upper(): z for z, s in enumerate(ELEMENTS)}


def charge_of(symbol: str) -> int:
    s = symbol.strip()
    if s.upper() in _UPPER_TO_Z:
        return _UPPER_TO_Z[s.upper()]
    raise KeyError(f"unknown element symbol: {symbol!r}")


# Bohr radius in Angstrom (CODATA 2010, matching common QC packages)
BOHR = 0.52917721092
