"""Port RHF on the elements of 0029-elongated-halogenated that the H2O
anchors lack (F, Cl), against the dense float64 oracle SCF.

``_oracle_rhf`` of tests/test_basis_elements.py runs the SCF on dense
``intor_np`` ERIs; the port runs its own J/K engine on the CPU (plain
versions of its kernels).  They must agree to 1e-9 Eh.
"""

import pytest
import torch

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu_torch.mol import Molecule as TMolecule
from joltqc_tpu_torch.scf import RHF

from test_basis_elements import _oracle_rhf

torch.set_num_threads(1)


@pytest.mark.parametrize("atoms", ["F 0 0 0; H 0 0 0.917",
                                   "Cl 0 0 0; H 0 0 1.275"],
                         ids=["HF", "HCl"])
def test_rhf_631gs_matches_oracle(atoms):
    e_ref = _oracle_rhf(JMolecule.from_atom_string(atoms, basis="6-31g*"),
                        conv=1e-11)
    mf = RHF(TMolecule.from_atom_string(atoms, basis="6-31g*"), device="cpu",
             conv_tol=1e-11)
    e = mf.kernel()
    assert mf.converged
    assert abs(e - e_ref) < 1e-9, (e, e_ref, e - e_ref)
