"""The port's autotune table, ``accum='auto'`` and per-class profiling
(utils/autotune.py, ``JKEngine._entry_mode`` / ``_tuned_chunk``,
``profile`` / ``class_time``).

``device="cpu"``.  The routing (``tuned_chunk`` / ``tuned_accum`` and the
reference's clamp of a tuned chunk) is held against the JAX package's
functions on one table file, which compile nothing; J/K of ``'auto'``
engines against the scatter and tile engines bit for bit and against the
dense oracle (``intor_np``) at the reference's all-fp64 bound, 1e-9.
Every test keeps its files in ``tmp_path`` (``JQC_CACHE_DIR``) and resets
both packages' cached tables.
"""

import json
import os

import numpy as np
import pytest
import torch

from joltqc_tpu.scf.jk_contracted import _chunk_size as jax_chunk_size
from joltqc_tpu.utils import autotune as jax_autotune
from joltqc_tpu_torch.mol import Molecule, intor_np
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import JKEngine
from joltqc_tpu_torch.utils import autotune, plancache

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
FP64 = dict(cutoff_fp32=1e-30, cutoff_fp64=1e-30)  # every task in fp64
KW = dict(tile=4, tile_w=8)  # block tiles and supertiles that H2O fills
ORACLE_TOL = 1e-9  # tests/test_jk_engine.py, all-fp64 routing

TABLE = {
    "(0, 0, 0, 0)|(3, 3, 3, 3)|f32": {"chunk": 128, "accum": "tile"},
    "(1, 0, 0, 0)|(3, 3, 3, 3)|fp64": {"chunk": 4096, "accum": "block",
                                       "mtasks_per_s": 2.5},
    "(1, 1, 0, 0)|(3, 3, 3, 3)|fp64": 512,
    "(1, 1, 1, 1)|(3, 3, 3, 3)|f32": {"accum": "scatter"},
}


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("JQC_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JQC_PLAN_CACHE", "1")
    monkeypatch.setattr(autotune, "_TABLE", None)
    monkeypatch.setattr(jax_autotune, "_TABLE", None)
    return tmp_path


@pytest.fixture(scope="module")
def h2o():
    out = {}
    for basis in ("sto-3g", "6-31g"):
        mol = Molecule.from_atom_string(H2O, basis=basis)
        a = np.random.default_rng(7).uniform(-1, 1, (mol.nao, mol.nao))
        dm = a + a.T
        g = intor_np.eri(mol)
        out[basis] = (mol, dm, (np.einsum("ijkl,kl->ij", g, dm),
                                np.einsum("ikjl,kl->ij", g, dm)))
    return out


def _write(path, table):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f)
    autotune._TABLE = None
    jax_autotune._TABLE = None


def _engine(mol, accum, **kw):
    return JKEngine(BasisLayout(mol), device="cpu", accum=accum,
                    **{**KW, **kw})


def _keys(mol, **kw):
    eng = _engine(mol, "scatter", **kw)
    return eng, sorted({autotune._key(e["ls"], e["nprims"], e["tier"])
                        for e in eng.build_plan(np.eye(mol.nao))})


def _near_oracle(jk, ref):
    scale = max(np.abs(ref[0]).max(), 1.0)
    return max(np.abs(jk[0] - ref[0]).max(),
               np.abs(jk[1] - ref[1]).max()) < ORACLE_TOL * scale


def test_device_name_and_paths(cache_env):
    """The CPU's name and the user table's path under the port's cache
    directory, apart from the JAX package's table."""
    assert autotune._device_name("cpu") == "cpu_cpu"
    assert autotune._table_path("cpu") == os.path.join(
        str(cache_env), "joltqc_tpu_torch", "autotune_cpu_cpu.json")
    assert autotune._table_path("cpu") != jax_autotune._table_path()
    assert autotune.load_table("cpu") == {}


def test_routing_matches_jax(cache_env):
    """tuned_chunk / tuned_accum and the clamp of a tuned chunk (at most
    the task count rounded up to a power of two, at least 64) equal the
    JAX package's on the same table; the user table overrides the loaded
    one after a reset."""
    _write(autotune._table_path("cpu"), TABLE)
    _write(jax_autotune._table_path(), TABLE)
    eng = JKEngine(BasisLayout(Molecule.from_atom_string(H2O,
                                                         basis="sto-3g")),
                   device="cpu", accum="auto")
    keys = list(TABLE) + ["(2, 0, 0, 0)|(1, 3, 3, 3)|f32"]
    for key in keys:
        ls, nprims, tier = key.split("|")
        ls, nprims = eval(ls), eval(nprims)
        assert (autotune.tuned_chunk(ls, nprims, tier, "cpu")
                == jax_autotune.tuned_chunk(ls, nprims, tier)), key
        assert (autotune.tuned_accum(ls, nprims, tier, "cpu")
                == jax_autotune.tuned_accum(ls, nprims, tier)), key
        if jax_autotune.tuned_chunk(ls, nprims, tier) is None:
            assert eng._tuned_chunk(ls, nprims, tier, 1000) is None
            continue
        for n in (1, 50, 64, 65, 100, 129, 5000, 10 ** 6):
            assert (eng._tuned_chunk(ls, nprims, tier, n)
                    == jax_chunk_size(ls, n, nprims=nprims, tier=tier)), \
                (key, n)
    _write(autotune._table_path("cpu"), {keys[0]: {"chunk": 64,
                                                   "accum": "scatter"}})
    assert autotune.tuned_accum((0, 0, 0, 0), (3, 3, 3, 3), "f32",
                                "cpu") == "scatter"


def test_auto_without_table_is_scatter(cache_env, h2o):
    """On the CPU an untuned class runs as scatter: the 'auto' plan is the
    scatter plan, shares its plan key, and J/K agree to the bit."""
    mol, dm, _ = h2o["6-31g"]
    auto, scat = _engine(mol, "auto"), _engine(mol, "scatter")
    ja = auto.get_jk(dm)
    js = scat.get_jk(dm)
    assert {e["accum"] for e in auto._plan} == {"scatter"}
    assert auto.plan_stats["by_accum"]["scatter"] == auto.plan_stats["ntasks"]
    assert np.array_equal(ja[0], js[0]) and np.array_equal(ja[1], js[1])
    D = np.zeros((len(mol.shells),) * 2, np.float32)
    assert (plancache.plan_key(auto, 0.7, D, 0.0)
            == plancache.plan_key(scat, 0.7, D, 0.0))


def test_auto_all_tile_table_is_tile_at_another_chunk(cache_env, h2o):
    """A table that routes every class to tile at chunk 64: the 'auto'
    engine runs tile entries in launches of 64 tasks (the tile engine's
    own chunks ignore the table) and its J/K equal the tile engine's to
    the bit: exact integer limbs make the sum independent of chunking."""
    mol, dm, _ = h2o["6-31g"]
    _, keys = _keys(mol)
    _write(autotune._table_path("cpu"),
           {k: {"chunk": 64, "accum": "tile"} for k in keys})
    auto, tile = _engine(mol, "auto"), _engine(mol, "tile")
    ja = auto.get_jk(dm)
    jt = tile.get_jk(dm)
    assert {e["accum"] for e in auto._plan} == {"tile"}
    assert {auto._entry_chunk(e) for e in auto._plan} == {64}
    assert all(tile._entry_chunk(e) == tile._chunk(e["ls"])
               for e in tile._plan)
    assert max(e["ntasks"] for e in auto._plan) > 64
    assert np.array_equal(ja[0], jt[0]) and np.array_equal(ja[1], jt[1])


def test_auto_mixed_table_vs_oracle(cache_env, h2o):
    """Classes routed in turn to tile, scatter and block at chunks of 64
    and 128: every mode runs, and J/K stay within 1e-9 of the dense
    oracle; a repeat is bit-identical."""
    mol, dm, ref = h2o["6-31g"]
    _, keys = _keys(mol, **FP64)
    modes = ("tile", "scatter", "block")
    _write(autotune._table_path("cpu"),
           {k: {"chunk": (64, 128)[i % 2], "accum": modes[i % 3]}
            for i, k in enumerate(keys)})
    auto = _engine(mol, "auto", **FP64)
    jk = auto.get_jk(dm)
    by = auto.plan_stats["by_accum"]
    assert all(by[m] > 0 for m in modes), by
    assert _near_oracle(jk, ref)
    again = auto.get_jk(dm)
    assert np.array_equal(jk[0], again[0]) and np.array_equal(jk[1], again[1])


def test_tune_workload_writes_a_table_that_routes(cache_env, h2o):
    """tune_workload on H2O/sto-3g (sizes (64, 128), one chunk per
    timing, every class) with block and tile engines: it writes the
    device's user table, the next load_table reads it, and an 'auto'
    engine on it meets the oracle bound."""
    mol, dm, ref = h2o["sto-3g"]
    engines = {m: _engine(mol, m, **FP64) for m in ("scatter", "block",
                                                    "tile")}
    for eng in engines.values():
        eng.get_jk(dm)
    table = autotune.tune_workload(
        engines["scatter"], sizes=(64, 128), min_tasks=1, verbose=False,
        block_engine=engines["block"], tile_engine=engines["tile"],
        max_chunks=1)
    keys = {autotune._key(e["ls"], e["nprims"], e["tier"])
            for e in engines["scatter"]._plan}
    assert set(table) == keys
    for rec in table.values():
        assert rec["accum"] in ("tile", "scatter", "block")
        assert rec["chunk"] >= 1 and rec["mtasks_per_s"] > 0
    with open(autotune._table_path("cpu")) as f:
        assert json.load(f) == table
    autotune._TABLE = None
    assert autotune.load_table("cpu") == table
    auto = _engine(mol, "auto", **FP64)
    jk = auto.get_jk(dm)
    assert [e["accum"] for e in auto._plan] == [
        table[autotune._key(e["ls"], e["nprims"], e["tier"])]["accum"]
        for e in auto._plan]
    assert _near_oracle(jk, ref)


def test_tune_workload_needs_a_plan_and_budget_stops_it(cache_env, h2o):
    mol, dm, _ = h2o["sto-3g"]
    eng = _engine(mol, "scatter")
    with pytest.raises(ValueError, match="no plan"):
        autotune.tune_workload(eng, verbose=False)
    eng.get_jk(dm)
    assert autotune.tune_workload(eng, min_tasks=1, verbose=False,
                                  budget_s=-1.0) == {}
    assert os.path.exists(autotune._table_path("cpu"))


def test_chunk_sizes_and_block_timing(cache_env, h2o):
    """The sizes tuned per class: a quarter, a half and the largest power
    of two below ``JKEngine._chunk(ls)`` and the heuristic itself, or the
    given sizes capped by it, at most 4x the class's tasks; a block entry
    is timed only at its plan's chunk."""
    mol, dm, _ = h2o["sto-3g"]
    eng = _engine(mol, "block")
    eng.get_jk(dm)

    def entry(ls, n):
        return dict(ls=ls, nprims=(1, 1, 1, 1), tier="f32", ntasks=n)

    assert autotune._sizes(eng, entry((0, 0, 0, 0), 10 ** 7), None) == [
        1 << 19, 1 << 20, 1 << 21]
    cap = eng._chunk((2, 2, 2, 2))
    assert cap == (1 << 24) // 36 ** 2
    assert autotune._sizes(eng, entry((2, 2, 2, 2), 10 ** 7), None) == [
        2048, 4096, 8192, cap]
    assert autotune._sizes(eng, entry((2, 2, 2, 2), 10 ** 7),
                           (64, 128, 10 ** 9)) == [64, 128, cap]
    assert autotune._sizes(eng, entry((0, 0, 0, 0), 20), (64, 128)) == [64]
    assert autotune._sizes(eng, entry((0, 0, 0, 0), 1), (64, 128)) == [
        eng._chunk((0, 0, 0, 0))]
    blk = next(e for e in eng._plan if e["accum"] == "block")
    with pytest.raises(ValueError, match="block"):
        autotune._time_class(eng, blk, 64)
    assert autotune._time_class(eng, blk, None, repeats=1) > 0


@pytest.mark.parametrize("accum", ["tile", "scatter", "block"])
def test_profile_changes_no_bit(cache_env, h2o, accum):
    """profile=True leaves J/K bit-identical and fills class_time with
    exactly the plan's (ls, nprims, tier) classes, each timed."""
    mol, dm, _ = h2o["6-31g"]
    eng = _engine(mol, accum)
    j0, k0 = eng.get_jk(dm)
    assert eng.class_time == {}
    eng.profile = True
    j1, k1 = eng.get_jk(dm)
    assert np.array_equal(j0, j1) and np.array_equal(k0, k1)
    assert set(eng.class_time) == {(e["ls"], e["nprims"], e["tier"])
                                   for e in eng._plan}
    assert all(t > 0 for t in eng.class_time.values())
