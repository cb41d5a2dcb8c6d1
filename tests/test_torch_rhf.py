"""Port RHF, one-electron integrals and import purity.

The port runs with ``device="cpu"`` (its plain versions); the anchors are
the reference's (tests/test_jk_engine.py), the one-electron integrals
are held to the numpy oracle (mol/intor_np.py), as tests/test_int1e.py
holds the JAX engine.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from joltqc_tpu_torch.mol import Molecule, intor_np
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import RHF
from joltqc_tpu_torch.scf.int1e import Int1eEngine

torch.set_num_threads(1)

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rhf_h2o_sto3g_anchor():
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    mf = RHF(mol, device="cpu", conv_tol=1e-11)
    e = mf.kernel()
    assert mf.converged
    assert abs(e - (-74.9630631297)) < 1e-7, e


def test_rhf_incremental_matches_direct():
    """Incremental direct SCF (delta-dm Fock builds through the bucketed
    plans, exact by linearity) reproduces the direct energy to 1e-9
    (tests/test_jk_engine.py::test_rhf_incremental_matches_direct)."""
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    e_ref = RHF(mol, device="cpu", conv_tol=1e-11).kernel()
    mf = RHF(mol, device="cpu", conv_tol=1e-11, incremental=True)
    e = mf.kernel()
    assert mf.converged
    assert abs(e - e_ref) < 1e-9, (e, e_ref)
    # every Fock build went through a density-bound bucket's plan
    assert mf.jk._plans and not mf.jk._plans_full
    assert sum(mf.jk.plan_builds.values()) == mf.jk.timing["plan_builds"]
    mf.reset_incremental()
    assert mf.jk._incr == {}


def test_rhf_scanner_reuses_density():
    """as_scanner: a second geometry starts from the previous density."""
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    mf = RHF(mol, device="cpu", conv_tol=1e-10)
    scan = mf.as_scanner()
    e0 = scan(mol)
    moved = Molecule.from_atom_string(H2O.replace("0.1174", "0.1274"),
                                      basis="sto-3g")
    e1 = scan(moved)
    assert mf.converged and np.isfinite(e1) and e1 != e0
    assert mf.mol is moved and mf.jk.layout.mol is moved


@pytest.mark.parametrize("basis", ["sto-3g", "6-31g*"])
def test_int1e_matches_oracle(basis):
    """fp64 S/T/V against intor_np to 1e-12 (relative to the largest
    element); 6-31g* has the split 1s contraction and d shells."""
    mol = Molecule.from_atom_string(H2O, basis=basis)
    s, t, v = Int1eEngine(BasisLayout(mol), device="cpu").stv()
    for got, ref in ((s, intor_np.overlap(mol)), (t, intor_np.kinetic(mol)),
                     (v, intor_np.nuclear(mol))):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-12 * max(np.abs(ref).max(), 1.0)


def test_rhf_device_int1e_route():
    """From 60 shells RHF takes S/T/V from Int1eEngine; below, the oracle.
    Both routes give the same hcore on a small molecule."""
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    mf = RHF(mol, device="cpu")
    h_oracle = mf.get_hcore()
    mf._INT1E_DEVICE_MIN_SHELLS = 0
    h_dev = mf.get_hcore()
    assert np.abs(h_dev - h_oracle).max() < 1e-12


def test_entry_points_raise_without_cuda():
    """No card and no device='cpu': the entry points raise (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RHF(mol)


def test_import_leaves_no_jax():
    """import joltqc_tpu_torch and every submodule (parallel, pyscf and
    entry among them): no jax, no joltqc_tpu, no pyscf, no process
    group."""
    code = (
        "import pkgutil, importlib, sys, joltqc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['parallel', 'parallel.jk_sharded', 'pyscf', 'entry']\n"
        "assert all(p.__name__ + '.' + n in sys.modules for n in need)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'joltqc_tpu', 'pyscf')"
        " or m.startswith(('jax.', 'joltqc_tpu.', 'pyscf.'))]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('joltqc_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 16


def test_scripts_import_no_jax():
    """chip_smoke.py and examples/torch_*.py import neither jax nor the
    JAX package (read from their source: they need a card to run)."""
    import ast
    import glob

    paths = [os.path.join(ROOT, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
    assert len(paths) >= 3
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "joltqc_tpu"), (path, n)
