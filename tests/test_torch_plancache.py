"""The port's plan and Schwarz-q disk caches (utils/plancache.py and
``JKEngine._ensure_q`` / ``_build_plan_cached``).

H2O/6-31g, ``device="cpu"``.  A plan and a q loaded from disk must equal
the ones built, array for array, and J/K from a loaded plan must equal
those from a built one to the bit, direct and incremental.  The JAX
package enters only through functions that compile nothing: its
``_narrow``, its cache paths and its q path.  Every test keeps its files
in ``tmp_path`` (``JQC_CACHE_DIR``) and resets the autotune table.
"""

import os

import numpy as np
import pytest
import torch

from joltqc_tpu.utils import plancache as jax_plancache
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import JKEngine
from joltqc_tpu_torch.utils import autotune, plancache

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
MODES = {"tile": {"tile_w": 8}, "scatter": {}, "block": {"tile": 4}}


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("JQC_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JQC_PLAN_CACHE", "1")
    monkeypatch.setenv("JQC_PLAN_CACHE_MIN_SECS", "0")
    monkeypatch.setattr(autotune, "_TABLE", None)
    return tmp_path


@pytest.fixture(scope="module")
def mol():
    return Molecule.from_atom_string(H2O, basis="6-31g")


def _dm(nao, seed=7):
    a = np.random.default_rng(seed).uniform(-1, 1, (nao, nao))
    return a + a.T


def _engine(mol, accum="tile", **kw):
    return JKEngine(BasisLayout(mol), device="cpu", accum=accum,
                    **{**MODES.get(accum, {}), **kw})


def _bounds(eng, dm):
    lay = eng.layout
    D = np.log(np.maximum(lay.dm_cond(lay.dm_to_internal(dm)), 1e-30))
    D = D.astype(np.float32)
    return float(D.max()) + 0.7, (D + 0.7).astype(np.float32)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("accum", list(MODES))
def test_plan_round_trip(cache_env, mol, accum, monkeypatch):
    """save_plan / load_plan of a tile, scatter and block plan whose
    entries carry their device copies: every saved field np.array_equal,
    the stats equal, the entries' own fields only and no ``_dev``."""
    monkeypatch.setenv("JQC_PLAN_CACHE_MIN_SECS", "1e9")  # get_jk saves none
    eng = _engine(mol, accum)
    eng.get_jk(_dm(mol.nao))
    plan, stats = eng._plan, eng.plan_stats
    assert all("_dev" in e for e in plan)
    key = plancache.plan_key(eng, *_bounds(eng, _dm(mol.nao)), 0.0)
    assert plancache.save_plan(key, plan, stats) > 0
    assert plancache.save_plan(key, plan, stats) == 0  # already on disk
    plan2, stats2 = plancache.load_plan(key)
    assert stats2 == stats
    assert len(plan2) == len(plan)
    for a, b in zip(plan, plan2):
        assert set(b) == set(a) - {"_dev"}
        for f in b:
            if isinstance(b[f], np.ndarray):
                assert np.array_equal(np.asarray(b[f]), a[f]), f
            else:
                assert b[f] == a[f], f
    if accum == "block":
        assert any(e["accum"] == "block" for e in plan2)
    names = {n.split("_", 1)[-1] for n in os.listdir(
        os.path.join(plancache._cache_dir(), f"plan_{key}"))}
    want = {"idx.npy", "w.npy", "meta.json"}
    if accum == "block":
        want |= {"gslot.npy", "tb4.npy"}
    assert names == want


def test_loaded_arrays_are_narrow_and_widen_on_upload(cache_env, mol):
    """A plan file holds int16 indices and float16 weights (exact for
    H2O); the upload widens them to the built plan's int32 and float32."""
    eng = _engine(mol)
    dm = _dm(mol.nao)
    eng.get_jk(dm)
    plan2, _ = plancache.load_plan(
        plancache.plan_key(eng, *_bounds(eng, dm), 0.0))
    for a, b in zip(eng._plan, plan2):
        assert b["idx"].dtype == np.int16 and b["w"].dtype == np.float16
        dev = eng._entry_dev(dict(b))
        assert dev[0].dtype == torch.int32 and dev[1].dtype == torch.float32
        assert torch.equal(dev[0], a["_dev"][0])
        assert torch.equal(dev[1], a["_dev"][1])


NARROW_CASES = {
    "int32 in range": np.array([0, 5, -32768, 32767], np.int32),
    "int32 out of range": np.array([0, 32768], np.int32),
    "int32 tb4 sentinel": np.full((2, 4), 1 << 28, np.int32),
    "float32 weights": np.array([0.0, 0.125, 0.25, 0.5, 1.0], np.float32),
    "float32 inexact": np.array([0.1, 1.0], np.float32),
    "empty int32": np.zeros(0, np.int32),
    "int64": np.array([1, 2], np.int64),
}


@pytest.mark.parametrize("case", list(NARROW_CASES))
def test_narrow_matches_jax(case):
    a = NARROW_CASES[case]
    got, ref = plancache._narrow(a), jax_plancache._narrow(a)
    assert got.dtype == ref.dtype
    assert got.tobytes() == ref.tobytes()
    assert np.array_equal(got.astype(a.dtype), a)


def test_plan_key_sensitivity(cache_env, mol):
    """Each plan input changes the key: logdm, omega, the shell-block
    bounds, the cutoffs, tile_w, the accumulation tag, the device type
    and the table's routing; the table's metadata alone does not."""
    import copy
    import json

    eng = _engine(mol)
    ns = len(mol.shells)
    D = np.zeros((ns, ns), np.float32)
    k0 = plancache.plan_key(eng, 0.7, D, 0.0)
    other = copy.copy(eng)
    other.device = torch.device("meta")
    keys = {
        "logdm": plancache.plan_key(eng, 0.8, D, 0.0),
        "omega": plancache.plan_key(eng, 0.7, D, 0.3),
        "cond": plancache.plan_key(eng, 0.7, D + 1.0, 0.0),
        "nocond": plancache.plan_key(eng, 0.7, None, 0.0),
        "cutoff": plancache.plan_key(_engine(mol, cutoff_fp64=1e-8), 0.7, D,
                                     0.0),
        "tile_w": plancache.plan_key(_engine(mol, tile_w=16), 0.7, D, 0.0),
        "accum": plancache.plan_key(_engine(mol, "scatter"), 0.7, D, 0.0),
        "device": plancache.plan_key(other, 0.7, D, 0.0),
    }
    assert len(set(keys.values()) | {k0}) == len(keys) + 1, keys
    path = autotune._table_path("cpu")
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def with_table(table):
        with open(path, "w") as f:
            json.dump(table, f)
        autotune._TABLE = None
        return plancache.plan_key(eng, 0.7, D, 0.0)

    k_route = with_table({"(0, 0, 0, 0)|(3, 3, 3, 3)|f32":
                          {"chunk": 128, "accum": "tile"}})
    k_meta = with_table({"(0, 0, 0, 0)|(3, 3, 3, 3)|f32":
                         {"chunk": 128, "accum": "tile", "mtasks_per_s": 1.0}})
    k_chunk = with_table({"(0, 0, 0, 0)|(3, 3, 3, 3)|f32":
                          {"chunk": 256, "accum": "tile"}})
    assert k_route != k0 and k_meta == k_route and k_chunk != k_route


@pytest.mark.parametrize("path", ["direct", "incremental"])
def test_second_engine_loads_plans_bit_identical(cache_env, mol, path):
    """A second engine loads every plan the first one built (plan_builds
    0, plan_loads as many as the builds) and gives the same J/K bits,
    direct and through the bucketed plans of get_jk_incr."""
    dms = [_dm(mol.nao, s) * f for s, f in ((7, 1.0), (8, 1e-3), (9, 1e-6))]

    def run(eng):
        if path == "direct":  # a rebuild for the larger density
            return [eng.get_jk(dms[0]), eng.get_jk(dms[0], omega=0.3),
                    eng.get_jk(dms[0] * 1e3)]
        return [eng.get_jk_incr(dms[0] + d) for d in (0.0, *dms[1:])]

    e1, e2 = _engine(mol), _engine(mol)
    out1 = run(e1)
    assert e1.timing["plan_builds"] >= 2
    assert e1.timing["plan_saves"] == e1.timing["plan_builds"]
    assert e1.timing["plan_save_bytes"] > 0
    out2 = run(e2)
    assert e2.timing.get("plan_builds", 0) == 0 and not e2.plan_builds
    assert e2.timing["plan_loads"] == e1.timing["plan_builds"]
    assert e2.timing["plan_load_s"] > 0
    for a, b in zip(out1, out2):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("omega", [0.0, 0.3])
def test_q_from_disk(cache_env, mol, omega, monkeypatch):
    """A second engine takes q from disk, computing none: the same pair
    order (i_loc, j_loc, diag) and the same q bits, omega included."""
    e1, e2 = _engine(mol), _engine(mol)
    for pc in e1.pair_classes:
        e1._ensure_q(pc, omega)

    def no_q(*a, **k):
        raise AssertionError("q computed instead of loaded")

    monkeypatch.setattr(e2, "_q_raw", no_q)
    for p1, p2 in zip(e1.pair_classes, e2.pair_classes):
        q2 = e2._ensure_q(p2, omega)
        assert np.array_equal(q2, e1._ensure_q(p1, omega))
        for f in ("i_loc", "j_loc", "diag", "q_log"):
            assert np.array_equal(getattr(p2, f), getattr(p1, f)), f
            assert getattr(p2, f).dtype == getattr(p1, f).dtype, f
        order = np.argsort(-p1.q_log, kind="stable")
        assert np.array_equal(order, np.arange(p1.npair))


def test_built_plan_not_saved_below_min_secs(cache_env, mol, monkeypatch):
    """Plans whose build took less than JQC_PLAN_CACHE_MIN_SECS are not
    saved (q files are)."""
    monkeypatch.setenv("JQC_PLAN_CACHE_MIN_SECS", "1e9")
    eng = _engine(mol)
    eng.get_jk(_dm(mol.nao))
    files = _files(cache_env)
    assert files and all(os.path.basename(f).startswith("q_") for f in files)
    assert "plan_saves" not in eng.timing


@pytest.mark.parametrize("var,value", [("JQC_PLAN_CACHE", "0"),
                                       ("JQC_PLAN_CACHE", "off"),
                                       ("JQC_CACHE_DIR", "none")])
def test_cache_off_writes_nothing(cache_env, mol, monkeypatch, var, value):
    monkeypatch.setenv("HOME", str(cache_env))
    monkeypatch.setenv(var, value)
    eng = _engine(mol)
    eng.get_jk(_dm(mol.nao))
    assert plancache.plan_key(eng, 0.7, None, 0.0) is None
    assert _files(cache_env) == []
    assert "plan_loads" not in eng.timing and eng.timing["plan_builds"] == 1


def test_port_files_apart_from_the_jax_packages(cache_env, mol, monkeypatch):
    """The port's plan, q and table files land under
    <JQC_CACHE_DIR>/joltqc_tpu_torch/, where the JAX package neither
    writes nor reads: not its plans/ directory, its autotune table or any
    q path of its engine; the defaults are apart too."""
    import json

    from joltqc_tpu.mol import Molecule as JMolecule
    from joltqc_tpu.mol.layout import BasisLayout as JLayout
    from joltqc_tpu.scf import JKEngine as JJKEngine
    from joltqc_tpu.utils import autotune as jax_autotune

    eng = _engine(mol)
    eng.get_jk(_dm(mol.nao), omega=0.3)
    path = autotune._table_path("cpu")
    with open(path, "w") as f:
        json.dump({}, f)
    port = {os.path.join(str(cache_env), f) for f in _files(cache_env)}
    root = os.path.join(str(cache_env), "joltqc_tpu_torch")
    assert port and all(p.startswith(root + os.sep) for p in port)
    assert any(os.path.basename(p).startswith("q_") for p in port)
    assert any(os.path.basename(p) == "meta.json" for p in port)
    jax_dir = jax_plancache._cache_dir()
    assert not any(p.startswith(jax_dir + os.sep) for p in port)
    assert not os.path.exists(jax_dir)
    jax_autotune._TABLE = None
    assert jax_autotune._table_path() not in port
    jeng = JJKEngine(JLayout(JMolecule.from_atom_string(H2O, basis="6-31g")))
    for pc in jeng.pair_classes:
        for om in (0.0, 0.3):
            assert jeng._q_cache_path(pc, om) not in port
    monkeypatch.delenv("JQC_CACHE_DIR")
    monkeypatch.setenv("HOME", str(cache_env))
    home_port = plancache.cache_root()
    assert home_port == os.path.join(str(cache_env), ".cache",
                                     "joltqc_tpu_torch")
    assert not jax_plancache._cache_dir().startswith(home_port)
    assert not home_port.startswith(jax_plancache._cache_dir())
