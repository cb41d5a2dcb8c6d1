"""Port ECP engine against the JAX package's numpy oracle: Na2 with the
full-channel Na ECP (ul + S..G, lc <= 4) over an s/p/d valence basis.

Beyond H2 the JAX ``ECPEngine`` compiles for minutes, so the port
(``device="cpu"``) is held to the JAX package's float64 oracle
``mol/ecp_np.py::ecp_matrix_np`` at 5e-11 abs, where the JAX engine
itself sits at 6.0e-13.  tests/test_torch_ecp_scf.py holds O-H and the
ECP SCF.  The ECP data are those of tests/test_ecp.py.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.ecp import parse_nwchem_ecp
from joltqc_tpu.mol.ecp_np import ecp_matrix_np
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu_torch.convert import ecp_from_numpy
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import ECPEngine
from test_ecp import NA_BASIS_TXT, NA_ECP_TXT

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for this module: tier-1 runs six workers on eight
    cores, where the numpy oracle's small LAPACK calls (``leggauss`` per
    primitive pair) spin eight-thread pools against each other and run
    tens of times slower."""
    with threadpool_limits(limits=1):
        yield


NA2 = "Na 0.5 0.5 0; Na 0 1.0 1.0"


def _pair(atoms, basis, ecp, **kw):
    """The same molecule in both packages, one parsed ECP for both."""
    data = parse_nwchem_ecp(ecp)
    jm = JMolecule.from_atom_string(atoms, basis=basis, ecp=data, **kw)
    tm = Molecule.from_atom_string(atoms, basis=basis,
                                   ecp=ecp_from_numpy(data), **kw)
    return jm, tm


@pytest.fixture(scope="module")
def na_basis(tmp_path_factory):
    path = tmp_path_factory.mktemp("basis") / "na_valence.dat"
    path.write_text(NA_BASIS_TXT)
    return str(path)


def test_build_matches_oracle_na2_full_channels(na_basis):
    """ul + S..G channels (lc <= 4) over an s/p/d basis."""
    jm, tm = _pair(NA2, na_basis, NA_ECP_TXT)
    lay = JLayout(jm)
    ref = lay.mat_to_mol(ecp_matrix_np(jm, lay))
    eng = ECPEngine(BasisLayout(tm), device="cpu")
    V = eng.build()
    assert np.abs(V - ref).max() < 5e-11, np.abs(V - ref).max()
