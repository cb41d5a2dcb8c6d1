"""Stand-ins for PySCF mean-field objects, on which the adapter's patches
(``_apply_patches``) run where pyscf is not installed.

``standin_mf`` carries what the patches read and replace on a PySCF RHF
or RKS object: ``mol`` (a port ``Molecule``, which the adapter takes as
it is), ``direct_scf``, ``reset`` (counting its calls in
``_reset_calls``) and ``as_scanner``, and for RKS ``xc``, ``grids``
(whose ``build`` fills ``coords`` and ``weights``) and ``_numint``.
tests/test_torch_pyscf_patches.py and phase ``api`` of chip_smoke.py use
them.
"""

from __future__ import annotations

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
# a one-term O ECP of 2 core electrons, NWChem format
O_ECP = """
ECP
O nelec 2
O ul
2 1.24 -2.30
END
"""


def standin_mf(basis="sto-3g", xc=None, ecp=False, direct_scf=False,
               n_rad=20, n_theta=6):
    """A stand-in RHF (RKS with ``xc``) on H2O in ``basis``, with
    ``O_ECP`` when ``ecp``; its grid is the port's at ``n_rad`` x
    ``n_theta``.  With an ECP, ``mol.intor`` stands for PySCF's own
    integrals and returns None."""
    from ..dft.grids import Grids
    from ..mol import Molecule

    mol = Molecule.from_atom_string(H2O, basis=basis,
                                    ecp=O_ECP if ecp else None)
    if ecp:
        mol.intor = lambda key, *a, **k: None

    class StandinGrids:
        coords = weights = None

        def build(self):
            g = Grids(mol, n_rad=n_rad, n_theta=n_theta)
            g.build()
            self.coords, self.weights = g.coords, g.weights
            return self

    class StandinNumInt:
        pass

    class StandinMF:
        def __init__(self):
            self.mol = mol
            self.direct_scf = direct_scf
            self._reset_calls = 0
            if xc is not None:
                self.xc = xc
                self.grids = StandinGrids()
                self._numint = StandinNumInt()

        def reset(self, mol_new=None):
            self._reset_calls += 1
            return self

        def as_scanner(self):
            return lambda m: 0.0

    return StandinMF()


__all__ = ["H2O", "O_ECP", "standin_mf"]
