from .molecule import Molecule, Shell  # noqa: F401
