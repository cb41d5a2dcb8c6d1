"""Port AO-value screening against the JAX package.

Setup of tests/test_screening.py: two waters 8 Bohr apart in 6-31g, a
30 x (8 x 16) product grid in blocks of 256.  The packs are host numpy on
both sides and must be equal; the screened float32 rho and V_xc agree
with the JAX package's to 1e-5 of their scale (tests/test_screening.py:45).
"""

import numpy as np
import pytest
import torch

from joltqc_tpu.dft import numint as jnumint
from joltqc_tpu.dft import screening as jscr
from joltqc_tpu.dft.grids import Grids as JGrids
from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu_torch.dft import numint as tnumint
from joltqc_tpu_torch.dft import screening as tscr
from joltqc_tpu_torch.dft.grids import Grids as TGrids
from joltqc_tpu_torch.mol import Molecule as TMolecule
from joltqc_tpu_torch.mol.layout import BasisLayout as TLayout

torch.set_num_threads(1)

ATOMS = """O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696;
O 8 0 0.1174; H 7.243 0 -0.4696; H 8.757 0 -0.4696"""
ROWS = {"lda": 1, "gga": 4, "mgga": 5}


@pytest.fixture(scope="module")
def setup():
    jmol = JMolecule.from_atom_string(ATOMS, basis="6-31g")
    tmol = TMolecule.from_atom_string(ATOMS, basis="6-31g")
    jl, tl = JLayout(jmol), TLayout(tmol)
    jg = JGrids(jmol, n_rad=30, n_theta=8, block=256).build()
    tg = TGrids(tmol, n_rad=30, n_theta=8, block=256).build()
    jni = jnumint.NumInt(jl, block=256)
    tni = tnumint.NumInt(tl, block=256, device="cpu")
    rng = np.random.default_rng(9)
    d = rng.standard_normal((tl.nao_int, tl.nao_int)) * 0.1
    dm = d + d.T + np.eye(tl.nao_int)
    jscreen = jscr.GridScreening(jni, jg, thresh=1e-13)
    tscreen = tscr.GridScreening(tni, tg, thresh=1e-13)
    sel = np.arange(0, len(tscreen.blocks), 2)
    return dict(jg=jg, tg=tg, jni=jni, tni=tni, dm=dm, js=jscreen,
                ts=tscreen, sel=sel)


def _scaled(got, ref):
    """max |diff| / scale, row by row for rho rows."""
    if got.ndim == 2 and got.shape[0] <= 5:
        return max(np.abs(g - r).max() / max(np.abs(r).max(), 1e-10)
                   for g, r in zip(got, ref))
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("thresh", [1e-13, 1e-12])
def test_packs_equal(setup, thresh):
    s = setup
    js = jscr.GridScreening(s["jni"], s["jg"], thresh=thresh)
    ts = tscr.GridScreening(s["tni"], s["tg"], thresh=thresh)
    assert np.array_equal(ts.blocks, js.blocks) and ts.npts == js.npts
    assert ts.buckets == js.buckets
    assert ts.fill_fraction == js.fill_fraction < 0.9
    assert len(ts.packed) == len(js.packed)
    for tp, jp in zip(ts.packed, js.packed):
        assert tp["W"] == jp["W"] and tp["gmax"] == jp["gmax"]
        for k in ("blocks", "cols"):
            assert tp[k].dtype == jp[k].dtype
            assert np.array_equal(tp[k], jp[k])
        assert all(np.array_equal(a, b) for a, b in zip(tp["gidx"], jp["gidx"]))
    for (tg, tl_, tnf, tpb), (jg, jl_, jnf, jpb) in zip(ts.group_sig,
                                                       js.group_sig):
        assert (tg, tl_, tnf) == (jg, jl_, jnf)
        assert all(np.array_equal(a, b) for a, b in zip(tpb, jpb))


@pytest.mark.parametrize("sel", [False, True], ids=["full", "block_sel"])
@pytest.mark.parametrize("fam", ["lda", "gga", "mgga"])
def test_screened_rho_matches_jax(setup, fam, sel):
    s = setup
    bs = s["sel"] if sel else None
    got = tscr.eval_rho_screened(s["tni"], s["ts"], s["dm"], fam, bs)
    ref = jscr.eval_rho_screened(s["jni"], s["js"], s["dm"], fam, bs)
    assert got.shape == ref.shape
    assert _scaled(got, ref) < 1e-5
    if sel:
        B = 256
        for b in range(len(s["ts"].blocks)):
            if b not in s["sel"]:
                assert np.all(got[:, b * B:(b + 1) * B] == 0.0)


@pytest.mark.parametrize("sel", [False, True], ids=["full", "block_sel"])
@pytest.mark.parametrize("fam", ["lda", "gga", "mgga"])
def test_screened_vxc_matches_jax(setup, fam, sel):
    s = setup
    bs = s["sel"] if sel else None
    rng = np.random.default_rng(4)
    wv = rng.standard_normal((ROWS[fam], len(s["tg"].coords))) * s["tg"].weights
    got = tscr.eval_vxc_screened(s["tni"], s["ts"], wv, fam, bs)
    ref = jscr.eval_vxc_screened(s["jni"], s["js"], wv, fam, bs)
    assert got.shape == ref.shape
    assert _scaled(got, ref) < 1e-5


def test_screened_matches_dense_port(setup):
    """The port's screened and dense paths agree as the JAX package's do
    (tests/test_screening.py bounds)."""
    s = setup
    got = tscr.eval_rho_screened(s["tni"], s["ts"], s["dm"], "mgga")
    ref = tnumint.eval_rho_all(s["tni"], s["tg"], s["dm"], "mgga")
    assert _scaled(got, ref) < 1e-5
    rng = np.random.default_rng(4)
    wv = rng.standard_normal((5, len(s["tg"].coords))) * s["tg"].weights
    got = tscr.eval_vxc_screened(s["tni"], s["ts"], wv, "mgga")
    ref = tnumint.eval_vxc_mat(s["tni"], s["tg"], wv, "mgga")
    assert _scaled(got, ref) < 2e-6
