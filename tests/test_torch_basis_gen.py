"""Port Molecule bookkeeping with ECPs and the generated fallback basis
against the JAX package: electron counts, effective charges, nuclear
repulsion, the generated shells (exponents ``np.array_equal``) and their
warning, ECP name / path / text resolution, and ``ecp_from_numpy``.  No
SCF here."""

import warnings

import numpy as np
import pytest

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.basis_gen import generate_even_tempered as j_generate
from joltqc_tpu.mol.ecp import available_ecps as j_available
from joltqc_tpu.mol.ecp import load_ecp as j_load
from joltqc_tpu.mol.ecp import parse_nwchem_ecp as j_parse
from joltqc_tpu_torch.convert import ecp_from_numpy
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol import ecp as port_ecp
from joltqc_tpu_torch.mol.basis_gen import generate_even_tempered
from joltqc_tpu_torch.mol.ecp import available_ecps, load_ecp
from test_ecp import ECP_TXT, NA_ECP_TXT


def _build(cls, atoms, **kw):
    """Build a molecule, returning it and the messages of its warnings."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        mol = cls.from_atom_string(atoms, **kw)
    return mol, [str(w.message) for w in rec]


def _same_ecp(a, b):
    assert sorted(a) == sorted(b)
    for sym in a:
        assert a[sym].ncore == b[sym].ncore
        assert len(a[sym].channels) == len(b[sym].channels)
        for ca, cb in zip(a[sym].channels, b[sym].channels):
            assert ca.l == cb.l
            for f in ("powers", "exps", "coefs"):
                assert np.array_equal(getattr(ca, f), getattr(cb, f)), f


CASES = {
    "oh_ecp": dict(atoms="O 0 0 0; H 0 0 1.9", basis="sto-3g", charge=1,
                   ecp=ECP_TXT),
    "nah_model": dict(atoms="Na 0 0 0; H 0 0 1.89", basis="sto-3g",
                      ecp="jqc-model"),
    "na2_full": dict(atoms="Na 0.5 0.5 0; Na 0 1.0 1.0", basis="6-31g",
                     ecp=NA_ECP_TXT),
    "ar_631g": dict(atoms="Ar 0 0 0; H 0 0 1.4", basis="6-31g", charge=1),
    "nai_model": dict(atoms="Na 0 0 0; I 0 0 2.7", basis="sto-3g",
                      ecp="jqc-model"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_molecule_bookkeeping_matches_jax(case):
    kw = dict(CASES[case])
    atoms = kw.pop("atoms")
    if case == "nai_model":  # I (Z = 53) is beyond the generated basis
        for cls in (JMolecule, Molecule):
            with pytest.raises(NotImplementedError, match="Z<=36"):
                _build(cls, atoms, **kw)
        return
    jm, jw = _build(JMolecule, atoms, **kw)
    tm, tw = _build(Molecule, atoms, **kw)
    assert tw == jw  # the same GENERATED warnings, once per element
    assert tm.nelectron == jm.nelectron
    assert np.array_equal(tm.atom_charges_eff, jm.atom_charges_eff)
    assert [tm.atom_ncore(i) for i in range(tm.natm)] == [
        jm.atom_ncore(i) for i in range(jm.natm)]
    assert tm.energy_nuc() == jm.energy_nuc()
    assert tm.nao == jm.nao
    assert len(tm.shells) == len(jm.shells)
    for a, b in zip(tm.shells, jm.shells):
        assert (a.l, a.atom_idx) == (b.l, b.atom_idx)
        for f in ("exps", "coeffs", "coord"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    if tm.ecp:
        _same_ecp(tm.ecp, jm.ecp)


@pytest.mark.parametrize("sym,basis", [("Na", "sto-3g"), ("Ar", "6-31g")])
def test_generated_shells_and_warning(sym, basis):
    """The fallback shells of an element missing from the data, and a
    warning for every molecule built (the per-build cache)."""
    tm, tw = _build(Molecule, f"{sym} 0 0 0; {sym} 0 0 3.0", basis=basis)
    jm, jw = _build(JMolecule, f"{sym} 0 0 0; {sym} 0 0 3.0", basis=basis)
    assert len(tw) == 1 and "GENERATED" in tw[0] and tw == jw
    _, again = _build(Molecule, f"{sym} 0 0 0", basis=basis)
    assert again == tw
    assert len(tm.shells) == len(jm.shells) > 10
    for a, b in zip(tm.shells, jm.shells):
        assert a.l == b.l and a.nprim == b.nprim == 1
        assert np.array_equal(a.exps, b.exps)
        assert np.array_equal(a.coeffs, b.coeffs)


def test_generate_even_tempered_every_element():
    for z in range(1, 37):
        a, b = generate_even_tempered(z), j_generate(z)
        assert len(a) == len(b)
        for sa, sb in zip(a, b):
            assert sa.l == sb.l
            assert np.array_equal(sa.exps, sb.exps)
            assert np.array_equal(sa.coeffs, sb.coeffs)
    with pytest.raises(NotImplementedError):
        generate_even_tempered(37)


def test_ecp_resolution_name_path_text(tmp_path):
    """A shipped name (read from the port's own ecp_data/), a path and
    NWChem text resolve as in the JAX package."""
    assert available_ecps() == j_available() == ["jqc-model"]
    assert port_ecp._ECP_DIR.startswith(
        port_ecp.__file__.rsplit("/", 1)[0])
    _same_ecp(load_ecp("jqc-model"), j_load("jqc-model"))
    path = tmp_path / "na.ecp"
    path.write_text(NA_ECP_TXT)
    _same_ecp(load_ecp(str(path)), j_load(str(path)))
    _same_ecp(load_ecp(ECP_TXT), j_parse(ECP_TXT))
    with pytest.raises(FileNotFoundError, match="jqc-model"):
        load_ecp("def2-nonexistent")
    mol, _ = _build(Molecule, "Na 0 0 0; H 0 0 1.89", basis="sto-3g",
                    ecp=str(path))
    assert mol.nelectron == 2


@pytest.mark.parametrize("source", ["jqc-model", "na_full"])
def test_ecp_from_numpy_round_trip(source):
    data = j_load("jqc-model") if source == "jqc-model" else j_parse(NA_ECP_TXT)
    got = ecp_from_numpy(data)
    _same_ecp(got, data)
    for sym in got:
        assert isinstance(got[sym], port_ecp.ECPData)
        for ca, cb in zip(got[sym].channels, data[sym].channels):
            assert isinstance(ca, port_ecp.ECPChannel)
            assert ca.exps is not cb.exps
        assert got[sym].lmax_semilocal == data[sym].lmax_semilocal
    if source == "na_full":  # the port's own parse of the same text
        _same_ecp(port_ecp.parse_nwchem_ecp(NA_ECP_TXT), got)
