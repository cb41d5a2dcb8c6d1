"""Port ``Int1eEngine.hcore`` and ``chunk``, and the layout's
primitive-pair blocks (``PrimPairBlock``, ``pair_block``, ``lpairs``).

``device="cpu"``.  hcore is held against the JAX package's numpy oracle
(``joltqc_tpu.mol.intor_np``, not its compiled engine) to 1e-12, and the
pair blocks against the JAX package's ``BasisLayout`` array for array.
"""

import dataclasses

import numpy as np
import pytest
import torch

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol import intor_np as j_intor_np
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout, PrimPairBlock
from joltqc_tpu_torch.scf.int1e import Int1eEngine

torch.set_num_threads(1)

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""


@pytest.mark.parametrize("basis", ["sto-3g", "6-31g*"])
def test_hcore(basis):
    """hcore() is T + V of stv() bit for bit and within 1e-12 of the JAX
    package's oracle kinetic + nuclear; chunk in {1, 7, 2048} gives the
    same stv() bits (a pair's blocks do not depend on its batch)."""
    lay = BasisLayout(Molecule.from_atom_string(H2O, basis=basis))
    s, t, v = Int1eEngine(lay, device="cpu").stv()
    h = Int1eEngine(lay, device="cpu").hcore()
    assert np.array_equal(h, t + v)
    jmol = JMolecule.from_atom_string(H2O, basis=basis)
    ref = j_intor_np.kinetic(jmol) + j_intor_np.nuclear(jmol)
    assert h.shape == ref.shape
    assert np.abs(h - ref).max() < 1e-12
    for chunk in (1, 7):
        eng = Int1eEngine(lay, device="cpu", chunk=chunk)
        assert eng.chunk == chunk
        for got, want in zip(eng.stv(), (s, t, v)):
            assert np.array_equal(got, want), chunk
    with pytest.raises(ValueError, match="chunk"):
        Int1eEngine(lay, device="cpu", chunk=0)


def test_pair_blocks_match_reference():
    """Every lpairs() block on H2O/6-31g* equals the JAX layout's, field
    by field (dtype included); blocks are cached per layout."""
    lay = BasisLayout(Molecule.from_atom_string(H2O, basis="6-31g*"))
    jlay = JLayout(JMolecule.from_atom_string(H2O, basis="6-31g*"))
    assert lay.lpairs() == jlay.lpairs() == [(0, 0), (1, 0), (1, 1),
                                             (2, 0), (2, 1), (2, 2)]
    for li, lj in lay.lpairs():
        blk, ref = lay.pair_block(li, lj), jlay.pair_block(li, lj)
        assert isinstance(blk, PrimPairBlock)
        assert lay.pair_block(li, lj) is blk
        assert blk.n == ref.n > 0 and blk.q_log is None
        for f in dataclasses.fields(ref):
            got, want = getattr(blk, f.name), getattr(ref, f.name)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype, f.name
                assert np.array_equal(got, want), (li, lj, f.name)
            else:
                assert got == want, (li, lj, f.name)
