"""Port numint (float32 bulk) and mixed numint (float64 tier) against the
JAX package and the float64 numpy oracle.

Setup of tests/test_mixed_numint.py: H2O/sto-3g, a 20 x (6 x 12) product
grid in blocks of 256, a seeded symmetric density.  The bulk is float32 on
both sides (max |diff| <= 1e-5 max |ref|); the mixed result must agree
with the JAX package's to 1e-10 and with the numpy oracle to < 1e-9, the
bound of tests/test_mixed_numint.py.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu.dft import mixed as jmixed
from joltqc_tpu.dft import numint as jnumint
from joltqc_tpu.dft.grids import Grids as JGrids
from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu_torch.dft import mixed as tmixed
from joltqc_tpu_torch.dft import numint as tnumint
from joltqc_tpu_torch.dft.grids import Grids as TGrids
from joltqc_tpu_torch.mol import Molecule as TMolecule
from joltqc_tpu_torch.mol.layout import BasisLayout as TLayout
from joltqc_tpu_torch.mol.numint_np import eval_rho_np, eval_vxc_np

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
ROWS = {"lda": 1, "gga": 4, "mgga": 5}


@pytest.fixture(scope="module")
def setup():
    jmol, tmol = JMolecule.from_atom_string(H2O), TMolecule.from_atom_string(H2O)
    jl, tl = JLayout(jmol), TLayout(tmol)
    jg = JGrids(jmol, n_rad=20, n_theta=6, block=256).build()
    tg = TGrids(tmol, n_rad=20, n_theta=6, block=256).build()
    assert np.array_equal(jg.coords, tg.coords)
    rng = np.random.default_rng(7)
    n = tl.nao_int
    dm = rng.standard_normal((n, n)) * 0.3
    dm = dm + dm.T
    jni = jnumint.NumInt(jl, block=256)
    tni = tnumint.NumInt(tl, block=256, device="cpu")
    nblk = len(tg.coords) // 256
    return dict(jl=jl, tl=tl, jg=jg, tg=tg, dm=dm, jni=jni, tni=tni,
                sel=np.arange(0, nblk, 2))


def _wv(s, fam, seed=8):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ROWS[fam], len(s["tg"].coords))) * 0.01


def _f32_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float64
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("sel", [False, True], ids=["full", "block_sel"])
@pytest.mark.parametrize("fam", ["lda", "gga", "mgga"])
def test_bulk_rho_and_vxc_match_jax(setup, fam, sel):
    s = setup
    bs = s["sel"] if sel else None
    _f32_close(tnumint.eval_rho_all(s["tni"], s["tg"], s["dm"], fam, bs),
               jnumint.eval_rho_all(s["jni"], s["jg"], s["dm"], fam, bs))
    wv = _wv(s, fam)
    _f32_close(tnumint.eval_vxc_mat(s["tni"], s["tg"], wv, fam, bs),
               jnumint.eval_vxc_mat(s["jni"], s["jg"], wv, fam, bs))


def test_bulk_block_sel_zeroes_the_rest(setup):
    s = setup
    full = tnumint.eval_rho_all(s["tni"], s["tg"], s["dm"], "gga")
    part = tnumint.eval_rho_all(s["tni"], s["tg"], s["dm"], "gga", s["sel"])
    B = 256
    for b in range(len(s["tg"].coords) // B):
        blk = slice(b * B, (b + 1) * B)
        if b in s["sel"]:
            assert np.array_equal(part[:, blk], full[:, blk])
        else:
            assert np.all(part[:, blk] == 0.0)


def test_ao_block_matches_jax(setup):
    s = setup
    pts = s["tg"].coords[:256]
    got = s["tni"].eval_ao_block(pts, deriv=1)
    ref = s["jni"].eval_ao_block(pts, deriv=1)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _f32_close(g.double().numpy(), np.asarray(r, np.float64))


@pytest.mark.parametrize("cutoff", [1e-6, 1e-2])
@pytest.mark.parametrize("fam", ["lda", "gga", "mgga"])
def test_mixed_matches_jax_and_oracle(setup, fam, cutoff):
    """cutoff 1e-6 (the RKS default) and 1e-2 (few heavy pairs: the bulk
    carries more of the sum)."""
    s = setup
    args_t = (s["tni"], s["tg"])
    args_j = (s["jni"], s["jg"])
    got = tmixed.eval_rho_mixed(*args_t, s["dm"], fam, s["tl"], cutoff)
    ref = jmixed.eval_rho_mixed(*args_j, s["dm"], fam, s["jl"], cutoff)
    oracle = eval_rho_np(s["tl"], s["tg"].coords, s["dm"], fam)
    assert np.abs(got - ref).max() <= 1e-10
    if cutoff == 1e-6:
        assert np.abs(got - oracle).max() < 1e-9
    wv = _wv(s, fam)
    got = tmixed.eval_vxc_mixed(*args_t, wv, fam, s["tl"], cutoff)
    ref = jmixed.eval_vxc_mixed(*args_j, wv, fam, s["jl"], cutoff)
    oracle = eval_vxc_np(s["tl"], s["tg"].coords, wv, fam)
    assert np.abs(got - ref).max() <= 1e-10
    if cutoff == 1e-6:
        assert np.abs(got - oracle).max() < 1e-9


@pytest.mark.parametrize("fam", ["gga", "mgga"])
def test_mixed_block_sel_matches_jax(setup, fam):
    s = setup
    got = tmixed.eval_rho_mixed(s["tni"], s["tg"], s["dm"], fam, s["tl"],
                                1e-6, block_sel=s["sel"])
    ref = jmixed.eval_rho_mixed(s["jni"], s["jg"], s["dm"], fam, s["jl"],
                                1e-6, block_sel=s["sel"])
    assert np.abs(got - ref).max() <= 1e-10
    wv = _wv(s, fam)
    got = tmixed.eval_vxc_mixed(s["tni"], s["tg"], wv, fam, s["tl"], 1e-6,
                                block_sel=s["sel"])
    ref = jmixed.eval_vxc_mixed(s["jni"], s["jg"], wv, fam, s["jl"], 1e-6,
                                block_sel=s["sel"])
    assert np.abs(got - ref).max() <= 1e-10


def test_heavy_pairs_match_jax(setup):
    s = setup
    for fam_l, D in (("rho", s["tl"].dm_cond(s["dm"])),
                     ("vxc", np.full((s["tl"].nbas,) * 2, 3.0))):
        wlog = np.log(np.maximum(D, 1e-300))
        got = tmixed.heavy_shell_pairs(s["tl"], wlog, 1e-6)
        ref = jmixed.heavy_shell_pairs(s["jl"], wlog, 1e-6)
        assert len(got[0]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)), fam_l
    for sh in s["tl"].mol.shells:
        assert tmixed.shell_value_bound(sh.l, sh.exps, sh.coeffs) == \
            jmixed.shell_value_bound(sh.l, sh.exps, sh.coeffs)


def test_empty_block_sel(setup):
    """An empty selection with heavy pairs present: the port returns zero
    rows and a zero matrix.  The JAX package returns the same for an
    integer-typed empty selection, and raises IndexError for a
    float-typed one (``np.array([])``) where it indexes the blocks; the
    port takes both."""
    s = setup
    wv = _wv(s, "gga")
    for sel in (np.array([], np.int64), np.array([])):
        rho = tmixed.eval_rho_mixed(s["tni"], s["tg"], s["dm"], "gga",
                                    s["tl"], 1e-6, block_sel=sel)
        vxc = tmixed.eval_vxc_mixed(s["tni"], s["tg"], wv, "gga", s["tl"],
                                    1e-6, block_sel=sel)
        assert rho.shape == (4, len(s["tg"].coords)) and np.all(rho == 0.0)
        assert vxc.shape == (s["tl"].nao_int,) * 2 and np.all(vxc == 0.0)
    ref = jmixed.eval_rho_mixed(s["jni"], s["jg"], s["dm"], "gga", s["jl"],
                                1e-6, block_sel=np.array([], np.int64))
    assert np.all(ref == 0.0)
    with pytest.raises(IndexError):
        jmixed.eval_rho_mixed(s["jni"], s["jg"], s["dm"], "gga", s["jl"],
                              1e-6, block_sel=np.array([]))
    with pytest.raises(IndexError):
        jmixed.eval_vxc_mixed(s["jni"], s["jg"], wv, "gga", s["jl"], 1e-6,
                              block_sel=np.array([]))


def test_numint_needs_a_device(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnumint.NumInt(setup["tl"])
