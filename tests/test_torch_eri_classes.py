"""Kernel A's specialised classes against the quartet classes the J/K
engine forms.

The engine sorts shell classes by l (``build_shell_classes``), pairs
shell classes with ci >= cj (``build_pair_classes``) and forms the
quartets of pair classes p1 >= p2 (``JKEngine._build_plan``), so every
l-tuple it launches has la >= lb, lc >= ld and la >= lc; the Schwarz
bounds use (li, lj, li, lj) of each pair class.  Those with l <= 2 must
have a class kernel (``ops/eri.py::ERI_CLASSES``), in both tiers, which
the library that ``class_library`` names must instantiate.  Built from the
shell and pair classes alone: no integrals.
"""

import os
import re

import pytest

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.ops import cuda
from joltqc_tpu_torch.ops.eri import (ERI_CLASSES, TIERS, class_libraries,
                                      class_library)
from joltqc_tpu_torch.scf.tasks import build_pair_classes, build_shell_classes

HERE = os.path.dirname(os.path.abspath(__file__))
H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""
XYZ_0029 = os.path.join(HERE, "..", "benchmarks", "molecules",
                        "0029-elongated-halogenated.xyz")


def _engine_ltuples(mol, merge_nprim):
    """The l-tuples of every ERI launch of a J/K engine on mol: the plan's
    quartet classes and the Schwarz diagonals."""
    classes = build_shell_classes(BasisLayout(mol), merge_nprim=merge_nprim)
    pairs = build_pair_classes(classes)
    out = set()
    for p1i, p1 in enumerate(pairs):
        li, lj = classes[p1.ci].l, classes[p1.cj].l
        out.add((li, lj, li, lj))
        for p2 in pairs[: p1i + 1]:
            out.add((li, lj, classes[p2.ci].l, classes[p2.cj].l))
    return out


@pytest.mark.parametrize("merge_nprim", [True, False])
@pytest.mark.parametrize("name,basis", [
    ("H2O", "6-31g*"), ("0029", "6-31g*"), ("H2O", "def2-svp"),
])
def test_engine_classes_are_canonical_and_specialised(name, basis,
                                                      merge_nprim):
    if name == "H2O":
        mol = Molecule.from_atom_string(H2O, basis=basis)
    else:
        mol = Molecule.from_xyz_file(XYZ_0029, basis=basis)
    tuples = _engine_ltuples(mol, merge_nprim)
    assert tuples
    for la, lb, lc, ld in tuples:
        assert la >= lb and lc >= ld and la >= lc, (la, lb, lc, ld)
    low = {ls for ls in tuples if max(ls) <= 2}
    assert low == tuples  # these bases stop at d
    assert low <= set(ERI_CLASSES)
    assert all(class_library(tier, ls) for tier in TIERS for ls in low)
    if name == "0029":  # one shell class per l, or per (l, nprim bucket)
        assert len(tuples) == (21 if merge_nprim else 22)


def test_specialised_list_is_the_canonical_tuples_up_to_d():
    want = {(la, lb, lc, ld) for la in range(3) for lb in range(3)
            for lc in range(3) for ld in range(3)
            if la >= lb and lc >= ld and la >= lc}
    assert len(want) == 25
    assert len(ERI_CLASSES) == 25 and set(ERI_CLASSES) == want
    for tier in TIERS:  # the generic route
        assert class_library(tier, (0, 1, 0, 0)) is None
        assert class_library(tier, (3, 2, 1, 0)) is None


def test_class_libraries_hold_every_class_once():
    """csrc/eri_class.cu is built once per library of ``class_libraries``;
    the -D flags of each name exactly the (tier, class) pairs that
    ``class_library`` sends to it, in digits and '_' only."""
    got = {}
    for name, flags in class_libraries().items():
        assert cuda.libraries()[name] == ("eri_class", flags)
        for f in flags:
            assert re.fullmatch(r"-D\w+=[0-9_]+", f), f
        codes = flags[0].removeprefix("-DJQC_ERI_CLASS_CODES=").split("_")
        mask = int(flags[1].removeprefix("-DJQC_ERI_TIERS="))
        assert len(set(codes)) == len(codes)
        for bit, tier in enumerate(TIERS):
            for code in codes if mask >> bit & 1 else ():
                ls = tuple(int(x) for x in f"{int(code):04d}")
                assert (tier, ls) not in got
                got[(tier, ls)] = name
    assert got == {(tier, ls): class_library(tier, ls)
                   for tier in TIERS for ls in ERI_CLASSES}
    libs = cuda.libraries()
    assert "eri_class" not in libs and libs["eri"] == ("eri", ())
