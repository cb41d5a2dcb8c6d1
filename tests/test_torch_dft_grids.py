"""Port grids, radii and the numpy grid oracle against the JAX package.

The port copies ``joltqc_tpu/dft/grids.py``, ``dft/radii.py`` and
``mol/numint_np.py`` (host numpy and scipy), so every result must be
bit-identical to the JAX package's on the same molecule.
"""

import numpy as np
import pytest

from joltqc_tpu.dft import grids as jgrids
from joltqc_tpu.dft import radii as jradii
from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol import numint_np as jnp_oracle
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu_torch.dft import grids as tgrids
from joltqc_tpu_torch.dft import radii as tradii
from joltqc_tpu_torch.mol import Molecule as TMolecule
from joltqc_tpu_torch.mol import numint_np as tnp_oracle
from joltqc_tpu_torch.mol.layout import BasisLayout as TLayout

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
WATERS = """O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696;
O 8 0 0.1174; H 7.243 0 -0.4696; H 8.757 0 -0.4696"""


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("atoms", [H2O, WATERS], ids=["h2o", "two_waters"])
@pytest.mark.parametrize("angular", ["lebedev", "product"])
@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "unpruned"])
def test_grids_bit_identical(atoms, angular, prune):
    kw = dict(n_rad=24, block=256, prune=prune)
    if angular == "lebedev":
        kw["n_ang"] = 110
    else:
        kw["n_theta"] = 8
    jg = jgrids.Grids(JMolecule.from_atom_string(atoms, basis="6-31g"),
                      **kw).build()
    tg = tgrids.Grids(TMolecule.from_atom_string(atoms, basis="6-31g"),
                      **kw).build()
    assert tg.angular == jg.angular == angular
    assert tg.size == jg.size
    assert _same(tg.coords, jg.coords)
    assert _same(tg.weights, jg.weights)


def test_default_grid_bit_identical():
    """The RKS default: Lebedev 302, per-element radial orders, pruned,
    block 1024."""
    jg = jgrids.Grids(JMolecule.from_atom_string(H2O)).build()
    tg = tgrids.Grids(TMolecule.from_atom_string(H2O)).build()
    assert (tg.angular, tg.n_ang, tg.block, tg.prune) == ("lebedev", 302,
                                                          1024, True)
    assert _same(tg.coords, jg.coords) and _same(tg.weights, jg.weights)


def test_grid_pieces_bit_identical():
    for n in (6, 110, 302, 590):
        for a, b in zip(tgrids.lebedev_grid(n), jgrids.lebedev_grid(n)):
            assert _same(a, b)
    for a, b in zip(tgrids.gauss_chebyshev_becke(40, 0.7),
                    jgrids.gauss_chebyshev_becke(40, 0.7)):
        assert _same(a, b)
    for a, b in zip(tgrids.angular_product_grid(7, 12),
                    jgrids.angular_product_grid(7, 12)):
        assert _same(a, b)
    rng = np.random.default_rng(3)
    atoms = rng.uniform(-2, 2, (4, 3))
    radii = rng.uniform(0.5, 2.0, 4)
    pts = rng.uniform(-3, 3, (500, 3))
    owner = rng.integers(0, 4, 500)
    assert _same(tgrids.becke_weights(atoms, radii, pts, owner),
                 jgrids.becke_weights(atoms, radii, pts, owner))


def test_radii_identical():
    assert _same(tradii.BRAGG_BOHR, jradii.BRAGG_BOHR)
    for z in range(0, 120):
        assert tradii.bragg_radius(z) == jradii.bragg_radius(z)


@pytest.mark.parametrize("family", ["lda", "gga", "mgga"])
def test_numint_np_bit_identical(family):
    """The copied float64 oracle: AO values, rho rows and V_xc."""
    jmol = JMolecule.from_atom_string(H2O, basis="6-31g*")
    tmol = TMolecule.from_atom_string(H2O, basis="6-31g*")
    jl, tl = JLayout(jmol), TLayout(tmol)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-3, 3, (300, 3))
    n = jl.nao_int
    dm = rng.standard_normal((n, n))
    dm = dm + dm.T
    for a, b in zip(tnp_oracle.eval_ao_np(tl, pts, deriv=1),
                    jnp_oracle.eval_ao_np(jl, pts, deriv=1)):
        assert _same(a, b)
    assert _same(tnp_oracle.eval_rho_np(tl, pts, dm, family),
                 jnp_oracle.eval_rho_np(jl, pts, dm, family))
    rows = {"lda": 1, "gga": 4, "mgga": 5}[family]
    wv = rng.standard_normal((rows, len(pts)))
    assert _same(tnp_oracle.eval_vxc_np(tl, pts, wv, family),
                 jnp_oracle.eval_vxc_np(jl, pts, wv, family))


def test_layout_groups_and_l2_pooling():
    """The layout pieces the DFT path adds: l groups and L2 pooling."""
    jl = JLayout(JMolecule.from_atom_string(WATERS, basis="6-31g*"))
    tl = TLayout(TMolecule.from_atom_string(WATERS, basis="6-31g*"))
    assert tl.ls == jl.ls
    assert all(_same(tl.groups[l], jl.groups[l]) for l in jl.ls)
    rng = np.random.default_rng(2)
    dm = rng.standard_normal((jl.nao_int, jl.nao_int))
    assert _same(tl.dm_cond_l2(dm), jl.dm_cond_l2(dm))
    assert _same(tl.dm_cond(dm), jl.dm_cond(dm))
