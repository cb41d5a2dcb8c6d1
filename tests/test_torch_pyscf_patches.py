"""Port PySCF adapter: the stub-MF tests of tests/test_pyscf_adapter.py
on ``joltqc_tpu_torch.pyscf._apply_patches`` with ``device="cpu"``
(pyscf is on neither machine): the full RHF/RKS patch surface with
PySCF's positional calling conventions, the incremental RHF and tagged
RKS veff against the direct builds, and the ECPscalar routing.  The
engines behind the patches are the port's, which the other
tests/test_torch_*.py files hold against the JAX package.
"""

import numpy as np
import torch

from joltqc_tpu_torch import pyscf as tpyscf
from joltqc_tpu_torch.pyscf import _apply_patches
from joltqc_tpu_torch.pyscf.standin import standin_mf

torch.set_num_threads(1)


def _stub_mf(xc=None, with_ecp=False):
    """A stand-in mean-field object shaped like a PySCF RHF/RKS on
    H2O/sto-3g (joltqc_tpu_torch/pyscf/standin.py)."""
    return standin_mf(xc=xc, ecp=with_ecp)


def _density(n, seed):
    rng = np.random.default_rng(seed)
    dm = rng.standard_normal((n, n)) * 0.1
    return dm + dm.T, rng


def test_apply_patches_full_rks_surface(monkeypatch):
    """get_jk/get_j/get_k, numint nr_rks/get_rho/nr_nlc_vxc, grids.build
    and the reset/as_scanner wrapping, called as PySCF calls them."""
    monkeypatch.setenv("JQC_PLAN_CACHE", "0")
    mf = _stub_mf(xc="pbe")
    _apply_patches(mf, device="cpu")
    for name in ("get_jk", "get_j", "get_k"):
        assert callable(getattr(mf, name))
    for name in ("nr_rks", "get_rho", "nr_nlc_vxc"):
        assert callable(getattr(mf._numint, name))
    assert mf._joltqc_wrapped
    assert mf._joltqc_torch["device"] == torch.device("cpu")

    n = mf.mol.nao
    dm, rng = _density(n, 0)
    vj = mf.get_j(mf.mol, dm, 1)
    vk = mf.get_k(mf.mol, dm, 1)
    vj2, vk2 = mf.get_jk(mf.mol, dm, 1)
    np.testing.assert_allclose(vj, vj2, atol=1e-12)
    np.testing.assert_allclose(vk, vk2, atol=1e-12)

    # hermi=0 with a non-symmetric dm takes the engine's non-symmetric path
    dm_ns = rng.standard_normal((n, n)) * 0.1
    _, vk_ns = mf.get_jk(mf.mol, dm_ns, 0)
    _, vk_sym = mf.get_jk(mf.mol, 0.5 * (dm_ns + dm_ns.T), 1)
    assert not np.allclose(vk_ns, vk_sym)

    g = mf.grids.build()  # the port's box-sorted grid builder
    assert g.coords is not None and len(g.weights) == len(g.coords)

    nelec, excsum, vmat = mf._numint.nr_rks(mf.mol, mf.grids, "pbe", dm)
    assert vmat.shape == (n, n)
    assert np.isfinite(excsum) and np.isfinite(nelec)
    rho = mf._numint.get_rho(mf.mol, dm, mf.grids)
    assert rho.shape == (len(g.weights),)
    # VV10 on the stub's small grid (a fresh one: mf.grids.build is
    # patched on the instance only)
    small = type(mf.grids)()
    _, e_nlc, v_nlc = mf._numint.nr_nlc_vxc(mf.mol, small, "vv10", dm)
    assert v_nlc.shape == (n, n) and np.isfinite(e_nlc) and e_nlc != 0.0

    # each reset re-applies the patches once (geometry-optimizer
    # workflow), through the object's own reset: the JAX adapter wraps its
    # own wrapper on every reset, so its re-applications grow per step
    applied = []

    def counting(mf_, *a, **k):
        applied.append(mf_)
        return apply_patches(mf_, *a, **k)

    apply_patches = tpyscf._apply_patches
    monkeypatch.setattr(tpyscf, "_apply_patches", counting)
    # the engines are kept alive, so that a freed one's id cannot come back
    engines = [mf._joltqc_torch["engine"]]
    for step in (1, 2, 3):
        mf.reset()
        assert mf._reset_calls == step and len(applied) == step
        engines.append(mf._joltqc_torch["engine"])
    assert len({id(e) for e in engines}) == 4 and applied == [mf] * 3
    assert mf._joltqc_wrapped


def test_get_veff_rhf_incremental_semantics(monkeypatch):
    """PySCF's direct-SCF loop calls mf.get_veff(mol, dm, dm_last,
    vhf_last) positionally; with direct_scf J/K run on the delta density
    and vhf_last is added back."""
    monkeypatch.setenv("JQC_PLAN_CACHE", "0")
    mf = _stub_mf()
    mf.direct_scf = True
    _apply_patches(mf, device="cpu")
    n = mf.mol.nao
    dm0, _ = _density(n, 1)
    dm1 = dm0 + 0.02 * np.eye(n)

    vhf0 = mf.get_veff(mf.mol, dm0)
    vj1, vk1 = mf.get_jk(mf.mol, dm1, 1)
    direct = vj1 - 0.5 * vk1
    incr = mf.get_veff(mf.mol, dm1, dm0, vhf0, 1)
    np.testing.assert_allclose(incr, direct, atol=1e-10)
    # PySCF's defaults are dm_last=0, vhf_last=0
    base = mf.get_veff(mf.mol, dm1, 0, 0, 1)
    np.testing.assert_allclose(base, direct, atol=1e-10)


def test_get_veff_rks_tags_and_increment(monkeypatch):
    """RKS veff carries PySCF's tags (ecoul/exc/vj/vk), and the tagged
    vhf_last incremental path reproduces the direct build."""
    monkeypatch.setenv("JQC_PLAN_CACHE", "0")
    mf = _stub_mf(xc="b3lyp")
    mf.direct_scf = True
    _apply_patches(mf, device="cpu")
    n = mf.mol.nao
    dm0, _ = _density(n, 2)
    dm1 = dm0 + 0.02 * np.eye(n)

    v0 = mf.get_veff(mf.mol, dm0)
    for tag in ("ecoul", "exc", "vj", "vk"):
        assert hasattr(v0, tag), tag
    assert np.isfinite(v0.ecoul)
    v1_incr = mf.get_veff(mf.mol, dm1, dm0, v0, 1)
    v1_direct = mf.get_veff(mf.mol, dm1)
    np.testing.assert_allclose(np.asarray(v1_incr), np.asarray(v1_direct),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(v1_incr.vj),
                               np.asarray(v1_direct.vj), atol=1e-8)


def test_apply_patches_ecp_intor_routing(monkeypatch):
    """mol.intor('ECPscalar') returns the port's ECP matrix; other keys go
    to the original intor."""
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.scf import ECPEngine

    monkeypatch.setenv("JQC_PLAN_CACHE", "0")
    mf = _stub_mf(with_ecp=True)
    calls = []
    mf.mol.intor = lambda key, *a, **k: calls.append(key) or None
    _apply_patches(mf, device="cpu")
    mf.reset()  # re-routes the molecule's own intor, not the routed one
    mat = mf.mol.intor("ECPscalar")
    assert mat.shape == (mf.mol.nao, mf.mol.nao)
    assert np.isfinite(mat).all() and np.abs(mat).max() > 0
    np.testing.assert_array_equal(
        mat, ECPEngine(BasisLayout(mf.mol), device="cpu").build())
    assert mf.mol.intor("ECPscalar_sph") is mat  # built once, cached
    mf.mol.intor("int1e_ovlp")
    assert calls == ["int1e_ovlp"]
