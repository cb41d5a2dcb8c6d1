"""Port ECP engine on O-H and the port's RHF with an ECP, against the
JAX package's numpy oracles.

O-H/sto-3g with the model O ECP of tests/test_ecp.py (ul, S, P): the
port (``device="cpu"``) against ``mol/ecp_np.py::ecp_matrix_np`` at
5e-11 abs (the JAX engine sits at 4.6e-12), and its RHF against the
dense float64 oracle SCF of tests/test_ecp.py at 1e-7 Eh.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol import intor_np as jintor
from joltqc_tpu.mol.ecp import parse_nwchem_ecp
from joltqc_tpu.mol.ecp_np import ecp_matrix_np
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu.scf.diis import DIIS
from joltqc_tpu_torch.convert import ecp_from_numpy
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import RHF, RKS, ECPEngine
from test_ecp import ECP_TXT

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for this module: tier-1 runs six workers on eight
    cores, where the numpy oracle's small LAPACK calls (``leggauss`` per
    primitive pair) spin eight-thread pools against each other and run
    tens of times slower."""
    with threadpool_limits(limits=1):
        yield


OH = "O 0 0 0; H 0 0 1.9"


def _pair(atoms, basis, ecp, **kw):
    """The same molecule in both packages, one parsed ECP for both."""
    data = parse_nwchem_ecp(ecp)
    jm = JMolecule.from_atom_string(atoms, basis=basis, ecp=data, **kw)
    tm = Molecule.from_atom_string(atoms, basis=basis,
                                   ecp=ecp_from_numpy(data), **kw)
    return jm, tm


@pytest.fixture(scope="module")
def oh_oracle():
    """The JAX package's oracle ECP matrix of O-H/sto-3g (mol basis)."""
    jm, _ = _pair(OH, "sto-3g", ECP_TXT, charge=1)
    lay = JLayout(jm)
    return lay.mat_to_mol(ecp_matrix_np(jm, lay))


def test_build_matches_oracle_oh(oh_oracle):
    _, tm = _pair(OH, "sto-3g", ECP_TXT, charge=1)
    eng = ECPEngine(BasisLayout(tm), device="cpu")
    V = eng.build()
    assert np.abs(V - oh_oracle).max() < 5e-11, np.abs(V - oh_oracle).max()
    # a second build is bit-identical (fixed-order host scatter)
    assert np.array_equal(V, eng.build())
    assert eng.last_run["tasks"] == sum(len(t[3]) for t in eng._tasks())


def test_rhf_with_ecp_matches_dense_oracle(oh_oracle):
    """O-H+/sto-3g with ECP_TXT: the port's RHF against the dense float64
    oracle SCF of tests/test_ecp.py (the JAX package's intor_np and
    ecp_matrix_np), to 1e-7 Eh; RKS.get_hcore carries the same ECP."""
    from scipy.linalg import eigh

    jm, tm = _pair(OH, "sto-3g", ECP_TXT, charge=1)
    assert tm.nelectron == 6
    s = jintor.overlap(jm)
    h = jintor.kinetic(jm) + jintor.nuclear(jm) + oh_oracle
    eri = jintor.eri(jm)
    e_nuc = jm.energy_nuc()
    nocc = jm.nelectron // 2
    _, c = eigh(h, s)
    dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
    diis = DIIS()
    e_last = 0.0
    for cycle in range(60):
        vj = np.einsum("ijkl,kl->ij", eri, dm)
        vk = np.einsum("ikjl,kl->ij", eri, dm)
        f = h + vj - 0.5 * vk
        e_ref = float(np.einsum("ij,ij->", dm, h)
                      + 0.5 * np.einsum("ij,ij->", dm, vj - 0.5 * vk)) + e_nuc
        _, c = eigh(diis.update(s, dm, f), s)
        dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
        if abs(e_ref - e_last) < 1e-11 and cycle > 0:
            break
        e_last = e_ref

    mf = RHF(tm, device="cpu", conv_tol=1e-11)
    e = mf.kernel()
    assert mf.converged
    assert abs(e - e_ref) < 1e-7, (e, e_ref)
    assert np.abs(mf.get_hcore() - h).max() < 5e-11
    ks = RKS(tm, xc="lda,vwn", device="cpu")
    assert np.abs(ks.get_hcore() - h).max() < 5e-11
    # reset drops the cached ECP matrix with the geometry
    mf.reset(tm)
    assert mf._ecp_mat is None
