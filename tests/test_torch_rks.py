"""Port RKS against the JAX package's RKS and the float64 oracle SCF.

 (a) one get_veff on H2O/6-31g b3lyp at a seeded density: the port and
     the JAX RKS, both with a dense float64 J/K in place of their J/K
     engines, agree on Exc and veff to 1e-8;
 (b) the port's RKS SCF (its own J/K engine, device="cpu") against
     ``oracle_rks`` of tests/test_dft_oracle_scf.py on the same grid, to
     1e-8 Eh (tests/test_dft_oracle_scf.py:104);
 (c) the incremental path's rho and V_xc at a second density against the
     full path, to 1e-10, with screening and the float64 tier engaged.
"""

import numpy as np
import pytest
import torch
from scipy.linalg import eigh

from joltqc_tpu.dft.grids import Grids as JGrids
from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.scf import RKS as JRKS
from joltqc_tpu_torch.dft.grids import Grids as TGrids
from joltqc_tpu_torch.mol import Molecule as TMolecule
from joltqc_tpu_torch.mol import intor_np
from joltqc_tpu_torch.scf import RKS as TRKS

from test_dft_oracle_scf import oracle_rks

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
WATERS = """O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696;
O 8 0 0.1174; H 7.243 0 -0.4696; H 8.757 0 -0.4696"""


class DenseJK:
    """Dense float64 J/K from intor_np (erf-attenuated for omega), with
    the get_jk / get_jk_incr interface RKS calls."""

    def __init__(self, mol):
        self.mol = mol
        self._eri = {}

    def _g(self, omega):
        if omega not in self._eri:
            self._eri[omega] = intor_np.eri(self.mol, omega=omega)
        return self._eri[omega]

    def get_jk(self, dm, with_j=True, with_k=True, omega=0.0):
        g = self._g(omega)
        vj = np.einsum("ijkl,kl->ij", g, dm) if with_j else None
        vk = np.einsum("ikjl,kl->ij", g, dm) if with_k else None
        return vj, vk

    get_jk_incr = get_jk

    def reset_incremental(self):
        pass


class ZeroJK(DenseJK):
    """J = K = 0: for checks of the grid path alone."""

    def _g(self, omega):
        return np.zeros((self.mol.nao,) * 4)


def _density(mol, seed):
    """2 C C^T of nocc random S-orthonormal orbitals."""
    s = intor_np.overlap(mol)
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((mol.nao, mol.nelectron // 2))
    w, v = eigh(c.T @ s @ c)
    c = c @ v @ np.diag(w ** -0.5) @ v.T
    return 2.0 * c @ c.T


def test_get_veff_matches_jax():
    """(a) H2O/6-31g b3lyp: Exc and veff at one seeded density."""
    kw = dict(n_rad=30, n_ang=110)
    jmol = JMolecule.from_atom_string(H2O, basis="6-31g")
    tmol = TMolecule.from_atom_string(H2O, basis="6-31g")
    jmf = JRKS(jmol, xc="b3lyp", grids=JGrids(jmol, **kw))
    tmf = TRKS(tmol, xc="b3lyp", grids=TGrids(tmol, **kw), device="cpu")
    jmf.jk = tmf.jk = DenseJK(tmol)
    dm = _density(tmol, 3)
    v_ref = jmf.get_veff(dm)
    v = tmf.get_veff(dm)
    assert np.array_equal(tmf.grids.coords, jmf.grids.coords)
    assert tmf._screening() is None and jmf._screening() is None
    assert abs(tmf._exc - jmf._exc) < 1e-8, (tmf._exc, jmf._exc)
    assert np.abs(v - v_ref).max() < 1e-8
    assert abs(tmf._ecoul - jmf._ecoul) < 1e-12
    assert abs(tmf._nelec_grid - jmf._nelec_grid) < 1e-8


@pytest.mark.parametrize("xc", ["lda,vwn", "pbe", "b3lyp", "wb97x-v"])
def test_scf_matches_oracle(xc):
    """(b) the port's SCF, its J/K engine on the CPU, vs the float64
    oracle SCF on the same grid (VV10 off, as in the oracle)."""
    jmol, tmol = JMolecule.from_atom_string(H2O), TMolecule.from_atom_string(H2O)
    jg = JGrids(jmol, n_rad=50, n_theta=12).build()
    tg = TGrids(tmol, n_rad=50, n_theta=12).build()
    e_ref = oracle_rks(jmol, xc, jg)
    mf = TRKS(tmol, xc=xc, grids=tg, nlc=False, conv_tol=1e-9, max_cycle=40,
              device="cpu")
    e = mf.kernel()
    assert mf.converged
    assert abs(e - e_ref) < 1e-8, (e, e_ref)


def test_incremental_matches_full():
    """(c) rho and V_xc of the incremental path (delta density over the
    selected blocks, screened bulk + float64 tier) at a second density
    against a full evaluation there."""
    mol = TMolecule.from_atom_string(WATERS, basis="6-31g")
    grids = TGrids(mol, n_rad=30, n_theta=8, block=256).build()
    mf = TRKS(mol, xc="pbe", grids=grids, incremental=True, device="cpu")
    from joltqc_tpu_torch.dft.numint import NumInt

    mf.ni = NumInt(mf.layout, block=256, device="cpu")
    mf.jk = ZeroJK(mol)
    dm1 = _density(mol, 1)
    dm2 = 0.999 * dm1 + 0.001 * _density(mol, 2)
    mf.get_veff(dm1)
    mf.get_veff(dm2)
    assert mf._screening() is not None, "screening must engage"
    nblk = len(mf._block_bounds())
    assert mf.dft_block_evals < 4 * nblk  # the second density skipped some
    cache = mf._dft_cache
    dm2_int = mf.layout.dm_to_internal(dm2)
    rho_full = mf._rho_eval(dm2_int, "gga")
    assert np.abs(cache["rho"] - rho_full).max() < 1e-10
    vxc_full = mf._vxc_eval(cache["wv"], "gga")
    assert np.abs(cache["vxc"] - vxc_full).max() < 1e-10


def test_defaults_match_jax():
    """The constructor's defaults and the functional's VV10 default."""
    jmol, tmol = JMolecule.from_atom_string(H2O), TMolecule.from_atom_string(H2O)
    for xc in ("lda,vwn", "wb97x-v"):
        j = JRKS(jmol, xc=xc)
        t = TRKS(tmol, xc=xc, device="cpu")
        for k in ("family", "omega", "alpha", "hyb", "nlc", "dft_cutoff_fp64",
                  "dft_cutoff_fp32", "incr_dft_thresh", "screen_thresh",
                  "incremental", "conv_tol", "max_cycle", "nlcgrids"):
            assert getattr(t, k) == getattr(j, k), k
        for k in ("n_rad", "n_ang", "n_theta", "n_phi", "block", "prune",
                  "angular"):
            assert getattr(t.grids, k) == getattr(j.grids, k), k
        assert t.ni.block == j.ni.block
    t = TRKS(tmol, xc="pbe", nlc=True, nlcgrids=True, device="cpu")
    assert t.nlc == (5.9, 0.0093) and t.nlcgrids.n_ang == 194
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TRKS(tmol)


def test_reset_keeps_grid_spec():
    tmol = TMolecule.from_atom_string(H2O)
    mf = TRKS(tmol, xc="pbe", grids=TGrids(tmol, n_rad=20, n_ang=50,
                                           prune=False), device="cpu")
    moved = TMolecule.from_atom_string(H2O.replace("0.1174", "0.1274"))
    mf.reset(moved)
    assert mf.mol is moved and mf.grids.mol is moved
    assert (mf.grids.n_rad, mf.grids.n_ang, mf.grids.prune) == (20, 50, False)
    assert mf.ni.layout is mf.layout and mf._scr is None
