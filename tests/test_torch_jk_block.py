"""Port block accumulation against one JAX block engine.

One JAX ``JKEngine(accum='block', tile=4)`` on H2O/sto-3g at all-fp64
routing runs one ``get_jk`` (on the CPU with x64, its XLA
``block_accumulate``); it is the only JAX Fock build of the port's mode
tests, and lives in a file of its own so that it runs beside them.  The
port's block engine, and the JAX plan itself carried across with its
chunks, group slots and tile bases, reproduce its J/K to 1e-9 (the
reference's fp64 bound, tests/test_jk_engine.py).
"""

import numpy as np
import pytest
import torch

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu.ops import df64 as df
from joltqc_tpu.ops.accum import block_accumulate as jax_block
from joltqc_tpu.scf import JKEngine as JJKEngine
from joltqc_tpu_torch.convert import plan_from_numpy
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.ops.accum import block_accumulate, limbs_to_f64
from joltqc_tpu_torch.scf import JKEngine

torch.set_num_threads(1)

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""


@pytest.fixture(scope="module")
def runs():
    a = np.random.default_rng(7).uniform(-1, 1, (7, 7))
    dm = a + a.T
    jeng = JJKEngine(JLayout(JMolecule.from_atom_string(H2O, basis="sto-3g")),
                     cutoff_fp32=1e-30, cutoff_fp64=1e-30, accum="block",
                     tile=4)
    vj, vk = jeng.get_jk(dm)
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    eng = JKEngine(BasisLayout(mol), device="cpu", cutoff_fp32=1e-30,
                   cutoff_fp64=1e-30, accum="block", tile=4)
    return dm, jeng, (vj, vk), eng


def test_block_engine_matches_jax_block_engine(runs):
    dm, jeng, (vj_j, vk_j), eng = runs
    vj, vk = eng.get_jk(dm)
    assert all(e["accum"] == "block" for e in eng._plan)
    assert np.abs(vj - vj_j).max() < 1e-9
    assert np.abs(vk - vk_j).max() < 1e-9


def test_jax_block_plan_runs_as_is(runs):
    """The JAX plan (every entry 'block', one chunk of 64 or 128 tasks
    with its pad tasks, 32 to 128 block rows) comes across with
    layout='as_is' and runs through the port's block path with the JAX
    chunks, gslot and tb4."""
    dm, jeng, (vj_j, vk_j), eng = runs
    assert {e["accum"] for e in jeng._plan} == {"block"}
    assert {np.asarray(e["tasks"][0]).shape for e in jeng._plan} == {
        (1, 64), (1, 128)}
    plan = plan_from_numpy(jeng._plan, eng.classes, layout="as_is")
    assert len(plan) == len(jeng._plan)
    for e, j in zip(plan, jeng._plan):
        B = np.asarray(j["tasks"][0]).shape[1]
        assert e["accum"] == "block" and e["chunk"] == B
        assert e["nrows"] == j["nrows"] and e["nrows"] in (32, 64, 128)
        assert e["idx"].shape == (4, B) and e["ntasks"] == j["ntasks"] < B
        assert int((e["w"] == 0).sum()) == B - e["ntasks"]  # pads kept
        assert np.array_equal(e["gslot"], np.asarray(j["tasks"][5]).ravel())
        assert np.array_equal(e["tb4"], np.asarray(j["tasks"][6]))
    vj, vk = eng.get_jk(dm, plan=plan)
    assert np.abs(vj - vj_j).max() < 1e-9
    assert np.abs(vk - vk_j).max() < 1e-9
    # a tile entry has no as_is form
    with pytest.raises(ValueError, match="as_is"):
        plan_from_numpy([dict(jeng._plan[0], accum="tile")], eng.classes,
                        layout="as_is")


def test_chunk_block_rows_match_jax_block_accumulate(runs):
    """The block rows of one carried chunk, stream by stream: the port's
    block_accumulate of the port's contracted values equals JAX
    block_accumulate of the same values and row keys to 1e-13 of the
    entry's bound."""
    dm, jeng, _, eng = runs
    plan = plan_from_numpy(jeng._plan, eng.classes, layout="as_is")
    entry = max(plan, key=lambda e: e["ntasks"])
    dm_flat = torch.as_tensor(eng.layout.dm_to_internal(dm)).reshape(-1)
    tbls, idx, w, G = eng._chunk_eri(entry, 0)
    js, ks = eng._chunk_streams(entry, tbls, idx, w, G, dm_flat)
    assert [s[0] for s in js + ks] == ["ab", "cd", "ac", "ad", "bc", "bd"]
    bound = np.float32(entry["bound"])
    for xy, vals, _ in js + ks:
        rowkey, _ = eng._block_keys(entry, 0, idx, xy)
        assert rowkey.dtype == torch.int32
        assert 0 <= int(rowkey.min()) and int(rowkey.max()) < entry["nrows"]
        limbs, e = block_accumulate(vals, rowkey, entry["nrows"],
                                    float(bound))
        got = limbs_to_f64(limbs, e).numpy()
        ref = np.asarray(df.to_f64(jax_block(
            df.from_f64(vals.numpy()), rowkey.numpy(), entry["nrows"],
            bound)))
        assert np.abs(vals.numpy()).max() <= bound
        assert np.abs(got - ref).max() < 1e-13 * float(bound), xy
