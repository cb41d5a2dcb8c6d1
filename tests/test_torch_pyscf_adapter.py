"""Port PySCF adapter (``joltqc_tpu_torch.pyscf``) against the JAX
package's (``joltqc_tpu.pyscf``); pyscf itself is on neither machine.

 - host functions: ``get_default_config``, ``merge_config`` and
   ``molecule_from_pyscf`` on a fake ``Mole`` (the public accessors and
   ``_ecp``, built from the Na 10-core ECP case of tests/test_ecp.py with
   a general contraction), shells and ECPData field by field;
 - ``nr_rks`` of the port's adapter against the JAX adapter's, pbe on the
   same stub and grid (``n_rad=20, n_theta=6``), 1e-10: the bound
   tests/test_torch_dft_numint.py holds the mixed path to at H2O/sto-3g;
 - the two reference defects (ROADMAP queue 3): the port's veff follows
   the correct behaviour, the JAX adapter's does not, each shown on stub
   engines that cost nothing.

The stub-MF tests of tests/test_pyscf_adapter.py on the port, with
``device="cpu"``, are in tests/test_torch_pyscf_patches.py.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu import pyscf as jpyscf
from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu_torch import pyscf as tpyscf
from joltqc_tpu_torch.dft.grids import Grids
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.ecp import parse_nwchem_ecp
from joltqc_tpu_torch.mol.layout import BasisLayout

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
# tests/test_ecp.py::NA_ECP_TXT (the reference suite's Na ECP)
NA_ECP_TXT = """
ECP
Na nelec 10
Na ul
2       1.0                   0.5
Na S
2      13.652203             732.2692
2       6.826101              26.484721
Na P
2      10.279868             299.489474
2       5.139934              26.466234
Na D
2       7.349859             124.457595
2       3.674929              14.035995
Na F
2       3.034072              21.531031
Na G
2       4.808857             -21.607597
END
"""


class FakeMole:
    """The public gto.Mole accessors that molecule_from_pyscf reads, from
    NaH+ (Na on the generated basis) with the Na ECP in PySCF's ``_ecp``
    layout, and one general contraction of two columns."""

    def __init__(self):
        with pytest.warns(UserWarning, match="GENERATED"):
            mol = Molecule.from_atom_string("Na 0.5 0.5 0; H 0 1.0 1.0",
                                            basis="sto-3g")
        self._mol = mol
        self.natm = len(mol.atom_symbols)
        self.charge, self.spin, self.cart = 1, 0, True
        self.basis = "sto-3g"
        self._bas = [(s.l, s.atom_idx, np.asarray(s.exps),
                      np.asarray(s.coeffs)[:, None]) for s in mol.shells]
        s0 = mol.shells[0]
        self._bas.append((s0.l, s0.atom_idx, np.asarray(s0.exps),
                          np.stack([s0.coeffs, -0.5 * s0.coeffs], 1)))
        self.nbas = len(self._bas)
        ecp = parse_nwchem_ecp(NA_ECP_TXT)["Na"]
        chans = []
        for ch in ecp.channels:
            prims = [[] for _ in range(int(max(ch.powers)) + 1)]
            for n, e, c in zip(ch.powers, ch.exps, ch.coefs):
                prims[int(n)].append([float(e), [float(c)]])
            chans.append([int(ch.l), prims])
        self._ecp = {"Na": (ecp.ncore, chans)}

    def atom_symbol(self, i):
        return self._mol.atom_symbols[i]

    def atom_coords(self):
        return np.asarray(self._mol.coords)

    def bas_angl(self, ib):
        return self._bas[ib][0]

    def bas_atom(self, ib):
        return self._bas[ib][1]

    def bas_exp(self, ib):
        return self._bas[ib][2]

    def bas_ctr_coeff(self, ib):
        return self._bas[ib][3]


def test_host_functions_match_jax():
    assert tpyscf.get_default_config() == jpyscf.get_default_config()
    for cfg in (None, {"jk": {"cutoff_fp64": 1e-8}}, {"ecp": {"x": 1}},
                {"dft": {"cutoff_fp32": 1e-12}, "jk": {"cutoff_fp32": 0}}):
        assert tpyscf.merge_config(cfg) == jpyscf.merge_config(cfg)
    fake = FakeMole()
    got, want = tpyscf.molecule_from_pyscf(fake), jpyscf.molecule_from_pyscf(
        fake)
    for f in ("atom_symbols", "charge", "spin", "cart", "basis"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.coords, want.coords)
    assert len(got.shells) == len(want.shells) == fake.nbas + 1
    for a, b in zip(got.shells, want.shells):
        assert (a.l, a.atom_idx) == (b.l, b.atom_idx)
        for f in ("exps", "coeffs", "coord"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert got.nao == want.nao
    assert set(got.ecp) == set(want.ecp) == {"Na"}
    ea, eb = got.ecp["Na"], want.ecp["Na"]
    assert ea.ncore == eb.ncore == 10
    assert len(ea.channels) == len(eb.channels) == 6
    for a, b in zip(ea.channels, eb.channels):
        assert a.l == b.l
        for f in ("powers", "exps", "coefs"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ImportError, match="standalone"):
        tpyscf.apply(object(), device="cpu")


class _NumInt:
    pass


class _GridStub:
    def __init__(self, coords, weights):
        self.coords, self.weights = coords, weights

    def build(self):
        return self


def _rks_stub(mol, grid):
    class MF:
        xc = "pbe"

    mf = MF()
    mf.mol = mol
    mf.grids = _GridStub(*grid)
    mf._numint = _NumInt()
    return mf


def test_nr_rks_matches_jax_adapter():
    """pbe, H2O/sto-3g on one (n_rad=20, n_theta=6) grid: nelec, Exc and
    V_xc of the two adapters' nr_rks within 1e-10."""
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    jmol = JMolecule.from_atom_string(H2O, basis="sto-3g")
    g = Grids(mol, n_rad=20, n_theta=6)
    g.build()
    grid = (g.coords, g.weights)
    cfg = tpyscf.merge_config(None)
    mf_t, mf_j = _rks_stub(mol, grid), _rks_stub(jmol, grid)
    tpyscf._patch_rks(mf_t, mol, BasisLayout(mol), cfg, "cpu")
    jpyscf._patch_rks(mf_j, jmol, JLayout(jmol), cfg)
    rng = np.random.default_rng(0)
    dm = rng.standard_normal((mol.nao, mol.nao)) * 0.1
    dm = dm + dm.T + np.eye(mol.nao)
    nt, et, vt = mf_t._numint.nr_rks(mol, mf_t.grids, "pbe", dm)
    nj, ej, vj = mf_j._numint.nr_rks(jmol, mf_j.grids, "pbe", dm)
    assert abs(nt - nj) < 1e-10 and abs(et - ej) < 1e-10, (nt - nj, et - ej)
    assert np.abs(vt - vj).max() < 1e-10, np.abs(vt - vj).max()
    assert vt.shape == (mol.nao, mol.nao) and np.isfinite(et)


def test_rhf_veff_adds_vhf_last_only_on_delta():
    """Reference defect (pyscf/__init__.py:260-272): with direct_scf off
    J/K run on the full density, yet the JAX adapter adds vhf_last; the
    port does not.  With direct_scf on both run on the delta density and
    add it."""
    n = 3
    rng = np.random.default_rng(1)
    dm, dm_last = rng.standard_normal((2, n, n))
    vhf_last = np.full((n, n), 7.0)

    def fake_jk(mol, dm, hermi):  # vhf = J - K/2 = dm
        return 2.0 * np.asarray(dm), 2.0 * np.asarray(dm)

    class MF:
        direct_scf = False

    for direct in (False, True):
        mf = MF()
        mf.direct_scf = direct
        port = tpyscf._make_rhf_get_veff(mf, fake_jk)
        ref = jpyscf._make_rhf_get_veff(mf, fake_jk)
        got = port(None, dm, dm_last, vhf_last)
        want_ref = ref(None, dm, dm_last, vhf_last)
        if direct:
            np.testing.assert_allclose(got, dm - dm_last + vhf_last)
            np.testing.assert_array_equal(got, want_ref)
        else:
            np.testing.assert_allclose(got, dm)           # the full build
            np.testing.assert_allclose(want_ref, dm + vhf_last)  # defect


def test_rks_veff_runs_nlc_for_mf_nlc():
    """Reference defect (pyscf/__init__.py:295): an xc string without VV10
    and ``mf.nlc = 'vv10'``: the port runs nr_nlc_vxc on nlcgrids with
    the nonlocal code, the JAX adapter skips it.  With an xc string that
    carries VV10 both run it with that string."""
    n = 2
    calls = []

    class NumInt:
        def nr_rks(self, mol, grids, xc, dm):
            return 1.0, -1.0, np.zeros((n, n))

        def nr_nlc_vxc(self, mol, grids, xc, dm):
            calls.append((grids, xc))
            return 1.0, 0.25, np.ones((n, n))

    class MF:
        direct_scf = False
        grids, nlcgrids = "grid", "nlcgrid"

    def jk(mol, dm, hermi, **kw):
        return np.zeros((n, n)), np.zeros((n, n))

    def j(mol, dm, hermi, **kw):  # also get_k
        return np.zeros((n, n))

    dm = np.eye(n)
    out = {}
    for name, mod in (("port", tpyscf), ("jax", jpyscf)):
        for xc, nlc in (("pbe", "vv10"), ("pbe", ""), ("wb97x-v", "")):
            mf = MF()
            mf.xc, mf.nlc, mf._numint = xc, nlc, NumInt()
            calls.clear()
            v = mod._make_rks_get_veff(mf, jk, j, j)(None, dm)
            out[name, xc, nlc] = (v.exc, list(calls))
    assert out["port", "pbe", "vv10"] == (-0.75, [("nlcgrid", "vv10")])
    assert out["jax", "pbe", "vv10"] == (-1.0, [])  # the defect
    for name in ("port", "jax"):
        assert out[name, "pbe", ""] == (-1.0, [])
        exc, c = out[name, "wb97x-v", ""]
        assert c == [("nlcgrid", "wb97x-v")] and exc == pytest.approx(-0.75)
    assert tpyscf._nlc_params("vv10") == tpyscf.VV10_PARAMS
