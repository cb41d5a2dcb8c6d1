"""Port ECP engine (joltqc_tpu_torch/scf/ecp.py) against the JAX package.

The port runs with ``device="cpu"`` (the same PyTorch code that runs on
the card).  The JAX ``ECPEngine`` compiles for seconds per kernel class,
so it is called on H2 with an s-only ECP alone (all five methods, held
to 1e-12 abs); tests/test_torch_ecp_oracle.py and test_torch_ecp_scf.py
hold larger cases and the ECP SCF to the JAX package's float64 numpy
oracles.  The task lists (host side, no compile) are compared for
equality up to the 351-AO 0029-Na+ molecule of ``chip_smoke.py``; the
closed forms of tests/test_ecp_closed_form.py go through the port's
engine at that file's bounds.  The ECP data are those of
tests/test_ecp.py.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.ecp import ECPChannel, parse_nwchem_ecp
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu.mol.molecule import Shell as JShell
from joltqc_tpu.scf.ecp import ECPEngine as JECPEngine
from joltqc_tpu_torch.convert import ecp_from_numpy
from joltqc_tpu_torch.mol import Molecule, Shell
from joltqc_tpu_torch.mol.ecp import ECPChannel as TChannel
from joltqc_tpu_torch.mol.ecp import ECPData as TData
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import ECPEngine
from test_ecp import ECP_TXT, H_ECP_TXT, NA_BASIS_TXT, NA_ECP_TXT

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for this module: tier-1 runs six workers on eight
    cores, where the numpy oracle's small LAPACK calls (``leggauss`` per
    primitive pair) spin eight-thread pools against each other and run
    tens of times slower."""
    with threadpool_limits(limits=1):
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H2 = "H 0 0 0; H 0 0 1.2"
OH = "O 0 0 0; H 0 0 1.9"
NA2 = "Na 0.5 0.5 0; Na 0 1.0 1.0"
# 0029-elongated-halogenated with Na+ 2.25 A beyond O15 on the C14=O15
# axis (atoms 0-based), as chip_smoke.py builds it
NA_0029 = "Na 4.1338 -3.1001 1.6996"


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


def _atoms_0029():
    with open(os.path.join(ROOT, "benchmarks", "molecules",
                           "0029-elongated-halogenated.xyz")) as f:
        lines = f.read().splitlines()
    return "\n".join(lines[2:2 + int(lines[0])] + [NA_0029])


# ------------------------------------------------------------ (b) tasks
@pytest.mark.parametrize("case", ["h2", "oh", "na2", "0029na"])
def test_task_lists_equal_jax(case, na_basis):
    """Shell classes, ECP centres and channels, the class pairs and the
    (si, sj) task order of every (class, class, channel) block equal the
    JAX engine's (host side only)."""
    if case == "0029na":
        with pytest.warns(UserWarning, match="GENERATED"):
            jm, tm = _pair(_atoms_0029(), "6-31g*", NA_ECP_TXT, charge=1)
        assert tm.nao == 351 and tm.nelectron == 152
    else:
        atoms, basis, ecp = {"h2": (H2, "sto-3g", H_ECP_TXT),
                             "oh": (OH, "sto-3g", ECP_TXT),
                             "na2": (NA2, na_basis, NA_ECP_TXT)}[case]
        jm, tm = _pair(atoms, basis, ecp)
    je, te = JECPEngine(JLayout(jm)), ECPEngine(BasisLayout(tm), device="cpu")
    assert len(je.classes) == len(te.classes)
    for a, b in zip(je.classes, te.classes):
        assert (a.l, a.nprim) == (b.l, b.nprim)
        for f in ("coords", "exps", "coefs", "ao", "shell_ids"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert len(je._centers) == len(te._centers)
    for a, b in zip(je._centers, te._centers):
        assert np.array_equal(a[0], b[0]) and a[1] == b[1] and a[5] == b[5]
        for k in (2, 3, 4):
            assert np.array_equal(a[k], b[k])
    tj, tt = list(je._tasks()), list(te._tasks())
    assert tj == tt
    assert sum(len(t[3]) for t in tt) > 0
    if case == "0029na":
        assert sum(len(t[3]) for t in tt) == 16779
        chunks = te._chunks()
        assert len(chunks) == 184
        assert max(len(c[3]) for c in chunks) == 128


# ------------------------------------------------ (c) JAX engine on H2
@pytest.fixture(scope="module")
def h2_engines():
    jm, tm = _pair(H2, "sto-3g", H_ECP_TXT)
    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, (tm.nao, tm.nao))
    return (JECPEngine(JLayout(jm)), ECPEngine(BasisLayout(tm), device="cpu"),
            a + a.T)


@pytest.mark.parametrize("method", ["build", "gradient", "build_ip",
                                    "ipipv", "ipvip"])
def test_engine_matches_jax_h2(method, h2_engines):
    je, te, dm = h2_engines
    call = {"build": lambda e: e.build(),
            "gradient": lambda e: e.gradient(dm),
            "build_ip": lambda e: e.build_ip(),
            "ipipv": lambda e: e.build_ipip("ipipv"),
            "ipvip": lambda e: e.build_ipip("ipvip")}[method]
    ref, got = call(je), call(te)
    assert ref.shape == got.shape
    assert np.abs(ref).max() > 1e-2
    assert np.abs(got - ref).max() < 1e-12, np.abs(got - ref).max()


# ------------------------------------------------- (e) closed forms
A = np.array([0.3, -0.2, 0.5])
B = np.array([-0.4, 0.1, -0.6])
C = np.array([0.15, 0.55, -0.2])


def _s_shell(coord, a, cls=Shell):
    return cls(0, np.array([a]), np.array([1.0]), np.asarray(coord, float), 0)


def _p_shell(coord, a, cls=Shell):
    return cls(1, np.array([a]), np.array([1.0]), np.asarray(coord, float), 0)


def _one_block(sh_a, sh_b, ch):
    """<sh_a | channel ch at C | sh_b>, internal cartesian, through the
    port's engine: a molecule whose third atom carries only the ECP."""
    ecp = {"He": TData(ncore=0, channels=[ch])}
    bohr = 0.52917721092
    mol = Molecule.from_atom_string(
        "; ".join(f"H {x * bohr} {y * bohr} {z * bohr}" for x, y, z in
                  (sh_a.coord, sh_b.coord))
        + f"; He {C[0] * bohr} {C[1] * bohr} {C[2] * bohr}",
        basis="sto-3g", ecp=ecp)
    mol.shells = [sh_a, sh_b]
    V = ECPEngine(BasisLayout(mol), device="cpu").build_int()
    na = 1 if sh_a.l == 0 else 3
    return V[:na, na:]


def _three_gauss(a, b, z):
    p = a + b + z
    pre = np.exp(-(a * b * np.sum((A - B) ** 2) + a * z * np.sum((A - C) ** 2)
                   + b * z * np.sum((B - C) ** 2)) / p)
    return p, pre, (a * A + b * B + z * C) / p


def _boys0(x):
    from scipy.special import erf

    x = max(x, 1e-16)
    return 0.5 * np.sqrt(np.pi / x) * erf(np.sqrt(x))


def _type2_l0_ss_exact(a, b, z, c):
    dA = np.linalg.norm(A - C)
    dB = np.linalg.norm(B - C)
    kA, kB = 2.0 * a * dA, 2.0 * b * dB
    p = a + b + z
    pref = 4.0 * np.pi * c / (2.0 * kA * kB) * np.exp(-a * dA**2 - b * dB**2)
    return pref * 0.5 * np.sqrt(np.pi / p) * (
        np.exp((kA + kB) ** 2 / (4 * p)) - np.exp((kA - kB) ** 2 / (4 * p)))


def test_closed_form_type1_gaussian_ss():
    """tests/test_ecp_closed_form.py: three-Gaussian product, 1e-12."""
    a, b, z, c = 0.9, 1.7, 1.24, -2.3
    p, pre, _ = _three_gauss(a, b, z)
    exact = c * pre * (np.pi / p) ** 1.5
    got = _one_block(_s_shell(A, a), _s_shell(B, b),
                     TChannel(-1, np.array([2]), np.array([z]), np.array([c])))
    assert abs(got[0, 0] - exact) < 1e-12 * max(1.0, abs(exact)), (got, exact)


def test_closed_form_type1_gaussian_sp():
    """First Gaussian moments, 1e-12 abs."""
    a, b, z, c = 1.1, 0.8, 0.9, 1.6
    p, pre, P = _three_gauss(a, b, z)
    exact = c * pre * (np.pi / p) ** 1.5 * (P - B)
    got = _one_block(_s_shell(A, a), _p_shell(B, b),
                     TChannel(-1, np.array([2]), np.array([z]), np.array([c])))
    np.testing.assert_allclose(got[0, :], exact, rtol=0, atol=1e-12)


def test_closed_form_type1_r1_boys():
    """c r^-1 e^{-z r^2}: the Boys-function closed form, 1e-10."""
    a, b, z, c = 0.7, 1.3, 0.8, 2.1
    p = a + b
    Q = (a * A + b * B) / p
    kab = np.exp(-a * b / p * np.sum((A - B) ** 2))
    pz = p + z
    R = (p * Q + z * C) / pz
    kqc = np.exp(-p * z / pz * np.sum((Q - C) ** 2))
    exact = c * kab * kqc * (2.0 * np.pi / pz) * _boys0(pz * np.sum((R - C) ** 2))
    got = _one_block(_s_shell(A, a), _s_shell(B, b),
                     TChannel(-1, np.array([1]), np.array([z]), np.array([c])))
    assert abs(got[0, 0] - exact) < 1e-10 * max(1.0, abs(exact)), (got, exact)


def test_closed_form_type2_l0_ss():
    """Semi-local l = 0 projector over s shells, 1e-10."""
    a, b, z, c = 0.9, 1.4, 1.1, 3.0
    exact = _type2_l0_ss_exact(a, b, z, c)
    got = _one_block(_s_shell(A, a), _s_shell(B, b),
                     TChannel(0, np.array([2]), np.array([z]), np.array([c])))
    assert abs(got[0, 0] - exact) < 1e-10 * max(1.0, abs(exact)), (got, exact)


def test_closed_form_engine_end_to_end():
    """tests/test_ecp_closed_form.py::test_engine_matches_closed_forms
    through the port: local Gaussian + l = 0 channel on He, 1e-9."""
    a, b = 0.9, 1.4
    zg, cg = 1.24, -2.3
    z0, c0 = 1.1, 3.0
    bohr = 0.52917721092
    mol = Molecule.from_atom_string(
        f"H {A[0]*bohr} {A[1]*bohr} {A[2]*bohr};"
        f" H {B[0]*bohr} {B[1]*bohr} {B[2]*bohr};"
        f" He {C[0]*bohr} {C[1]*bohr} {C[2]*bohr}",
        basis="sto-3g",
        ecp=f"ECP\nHe nelec 0\nHe ul\n2 {zg} {cg}\nHe S\n2 {z0} {c0}\nEND\n",
    )
    mol.shells = [_s_shell(A, a), _s_shell(B, b)]
    mat = ECPEngine(BasisLayout(mol), device="cpu").build()
    p, pre, _ = _three_gauss(a, b, zg)
    exact = cg * pre * (np.pi / p) ** 1.5 + _type2_l0_ss_exact(a, b, z0, c0)
    assert abs(mat[0, 1] - exact) < 1e-9 * max(1.0, abs(exact)), (mat[0, 1], exact)


def test_closed_form_blocks_match_jax_oracle():
    """The same s/p blocks through the JAX package's type1/type2 oracle
    functions agree with the port's engine (1e-12 abs)."""
    from joltqc_tpu.mol.ecp_np import type1_cart_np, type2_cart_np

    for l, fn in ((-1, type1_cart_np), (0, type2_cart_np), (1, type2_cart_np)):
        jch = ECPChannel(l, np.array([2, 1]), np.array([1.1, 2.3]),
                         np.array([3.0, -0.7]))
        tch = TChannel(l, jch.powers.copy(), jch.exps.copy(), jch.coefs.copy())
        ref = fn(_s_shell(A, 0.9, JShell), _p_shell(B, 1.4, JShell), C, jch)
        got = _one_block(_s_shell(A, 0.9), _p_shell(B, 1.4), tch)
        assert np.abs(got - ref).max() < 1e-12, (l, np.abs(got - ref).max())


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(na_basis):
    """The same engine on the card and on the CPU (Na2, every channel):
    build and gradient to 1e-12 (needs a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tm = _pair(NA2, na_basis, NA_ECP_TXT)
    lay = BasisLayout(tm)
    on_cpu = ECPEngine(lay, device="cpu")
    on_card = ECPEngine(lay, device="cuda")
    assert np.abs(on_card.build() - on_cpu.build()).max() < 1e-12
    dm = np.eye(tm.nao)
    assert np.abs(on_card.gradient(dm) - on_cpu.gradient(dm)).max() < 1e-12
