"""Port get_jk: accumulation modes, omega, hermi=0, stacks, incremental.

H2O/sto-3g, ``device="cpu"`` (the plain versions).  J/K are held against
the dense oracle ``intor_np.eri(mol, omega)`` at the reference's bounds
(tests/test_jk_engine.py: 1e-9 at all-fp64 routing, 1e-6 mixed; block
against scatter 1e-11 of max(|J|, 1)).  Against the JAX package the task
PLANS are compared, with no JAX Fock build: with the JAX engine's Schwarz
bounds copied in, the port's omega and block plans hold the JAX plans'
tasks, tiers and weights.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu.scf import JKEngine as JJKEngine
from joltqc_tpu_torch.mol import Molecule, intor_np
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import JKEngine

torch.set_num_threads(1)

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""

# (cutoff_fp32, cutoff_fp64, bound) as tests/test_torch_jk.py
TIERS = {"fp64": (1e-30, 1e-30, 1e-9), "mixed": (1e-14, 0.1, 1e-6)}
MODES = {"tile": {}, "scatter": {}, "block": {"tile": 4}}
OMEGA = 0.3


@pytest.fixture(scope="module")
def h2o():
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, (mol.nao, mol.nao))  # not symmetric
    dms = {"sym": a + a.T, "nonsym": a,
           "stack": np.stack([a + a.T, 0.5 * (a + a.T) + np.eye(mol.nao)])}
    g = {0.0: intor_np.eri(mol), OMEGA: intor_np.eri(mol, omega=OMEGA)}
    return mol, dms, g


def _ref(g, dm):
    return np.einsum("ijkl,kl->ij", g, dm), np.einsum("ikjl,kl->ij", g, dm)


def _engine(mol, accum, routing):
    c32, c64, _ = TIERS[routing]
    return JKEngine(BasisLayout(mol), device="cpu", cutoff_fp32=c32,
                    cutoff_fp64=c64, accum=accum, tile_w=8, **MODES[accum])


@pytest.mark.parametrize("routing", list(TIERS))
@pytest.mark.parametrize("case", ["plain", "omega", "hermi0", "stack"])
@pytest.mark.parametrize("accum", list(MODES))
def test_get_jk_modes_vs_oracle(h2o, accum, case, routing):
    mol, dms, g = h2o
    eng = _engine(mol, accum, routing)
    tol = TIERS[routing][2]
    if case == "stack":
        vj, vk = eng.get_jk(dms["stack"])
        assert vj.shape == vk.shape == dms["stack"].shape
        for i in range(2):
            rj, rk = _ref(g[0.0], dms["stack"][i])
            assert np.abs(vj[i] - rj).max() < tol
            assert np.abs(vk[i] - rk).max() < tol
        return
    dm = dms["nonsym" if case == "hermi0" else "sym"]
    omega = OMEGA if case == "omega" else 0.0
    vj, vk = eng.get_jk(dm, omega=omega, hermi=0 if case == "hermi0" else 1)
    rj, rk = _ref(g[omega], dm)
    assert np.abs(vj - rj).max() < tol, np.abs(vj - rj).max()
    assert np.abs(vk - rk).max() < tol, np.abs(vk - rk).max()
    if case == "hermi0":
        assert np.abs(vk - vk.T).max() > 1e-3  # the antisymmetric part is there
    # with_j / with_k alone give the same matrices
    assert eng.get_jk(dm, with_k=False, omega=omega,
                      hermi=0 if case == "hermi0" else 1)[1] is None
    # every entry runs in the engine's mode (block: or as scatter)
    allowed = {"block": {"block", "scatter"}}.get(accum, {accum})
    assert {e["accum"] for e in eng._plans_full[omega][0]} <= allowed


@pytest.mark.parametrize("accum", list(MODES))
def test_repeated_get_jk_is_bit_identical(h2o, accum):
    mol, dms, _ = h2o
    eng = _engine(mol, accum, "mixed")
    a = eng.get_jk(dms["nonsym"], hermi=0)
    b = eng.get_jk(dms["nonsym"], hermi=0)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("routing", list(TIERS))
def test_block_plan_has_block_entries_and_matches_scatter(h2o, routing):
    mol, dms, _ = h2o
    eng_b = _engine(mol, "block", routing)
    eng_s = _engine(mol, "scatter", routing)
    vj_b, vk_b = eng_b.get_jk(dms["sym"])
    vj_s, vk_s = eng_s.get_jk(dms["sym"])
    assert any(e["accum"] == "block" for e in eng_b._plan)
    by = eng_b.plan_stats["by_accum"]
    assert by["block"] > 0 and by["tile"] == 0
    assert sum(by.values()) == eng_b.plan_stats["ntasks"]
    assert eng_s.plan_stats["by_accum"]["scatter"] == eng_s.plan_stats["ntasks"]
    scale = max(np.abs(vj_s).max(), 1.0)
    assert np.abs(vj_b - vj_s).max() < 1e-11 * scale
    assert np.abs(vk_b - vk_s).max() < 1e-11 * scale


def test_block_entry_routing_rule():
    """``G*S*S <= 4*B`` decides block or scatter per entry; gslot counts
    the runs of one tile key inside a chunk and tb4 holds their bases."""
    from joltqc_tpu_torch.scf.jk_contracted import block_entry

    class C:
        nshell = 9  # 8 real shells and the pad shell

    classes = [C()] * 4
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 8, (4, 300)).astype(np.int32)
    w = np.ones(300, np.float32)
    args = ((0, 0, 0, 0), (1, 1, 1, 1), "fp64", (0, 1, 2, 3), idx, w, 1.0)
    e = block_entry(classes, 4, 128, *args)   # 16 tile keys in all
    assert e["accum"] == "block" and e["chunk"] == 128
    S, nchunk = 4, 3
    groups = [len({tuple(c) for c in (e["idx"][:, s:s + 128] // S).T.tolist()})
              for s in range(0, 300, 128)]
    G = 1 << int(np.ceil(np.log2(max(groups))))
    assert e["nrows"] == G * S * S <= 4 * 128
    assert e["tb4"].shape == (nchunk, G, 4)
    for t in range(300):
        base = tuple(int(v) for v in (e["idx"][:, t] // S) * S)
        assert tuple(e["tb4"][t // 128, e["gslot"][t]]) == base
    used = {(t // 128, int(s)) for t, s in enumerate(e["gslot"])}
    assert [len({s for c, s in used if c == k}) for k in range(3)] == groups
    empty = [(c, s) for c in range(nchunk) for s in range(G)
             if (c, s) not in used]
    assert all((e["tb4"][c, s] == 1 << 28).all() for c, s in empty)
    assert sorted(map(tuple, e["idx"].T.tolist())) == sorted(
        map(tuple, idx.T.tolist()))
    # 64 shells: nearly every task is a group of its own, G*S*S > 4*B

    class Wide:
        nshell = 65

    idx = rng.integers(0, 64, (4, 300)).astype(np.int32)
    args = args[:4] + (idx, w, 1.0)
    e2 = block_entry([Wide()] * 4, 4, 128, *args)
    assert e2["accum"] == "scatter" and "tb4" not in e2
    assert np.array_equal(np.sort(e2["idx"], axis=1), np.sort(idx, axis=1))


def test_unknown_accum_raises(h2o):
    mol = h2o[0]
    with pytest.raises(ValueError, match="accum"):
        JKEngine(BasisLayout(mol), device="cpu", accum="auto")


def test_full_plan_cache_is_keyed_by_omega(h2o):
    """get_jk(dm), get_jk(dm, omega), get_jk(dm) on one engine: the omega
    plan neither replaces nor is taken for the full-Coulomb plan."""
    mol, dms, g = h2o
    eng = _engine(mol, "tile", "mixed")
    first = eng.get_jk(dms["sym"])
    plan0 = eng._plan
    lr = eng.get_jk(dms["sym"], omega=OMEGA)
    again = eng.get_jk(dms["sym"])
    assert np.array_equal(first[0], again[0])
    assert np.array_equal(first[1], again[1])
    assert set(eng._plans_full) == {0.0, OMEGA}
    assert eng._plans_full[0.0][0] is plan0 is eng._plan
    assert eng.timing["plan_builds"] == 2
    assert eng.plan_builds == {("full", 0.0): 1, ("full", OMEGA): 1}
    rj, _ = _ref(g[OMEGA], dms["sym"])
    assert np.abs(lr[0] - rj).max() < 1e-6
    assert np.abs(lr[0] - first[0]).max() > 1e-2


@pytest.mark.parametrize("accum", ["tile", "block"])
def test_get_jk_incr_matches_get_jk(h2o, accum):
    """Three densities through get_jk_incr: the last J/K equal get_jk of
    the last density (linearity), to 1e-11."""
    mol, dms, _ = h2o
    rng = np.random.default_rng(5)
    eng = _engine(mol, accum, "fp64")
    eng.reset_incremental()
    dm = dms["sym"]
    for step in (0.0, 1e-2, 1e-5):
        d = rng.uniform(-1, 1, dm.shape) * step
        dm = dm + d + d.T
        vj, vk = eng.get_jk_incr(dm)
    rj, rk = _engine(mol, accum, "fp64").get_jk(dm)
    assert np.abs(vj - rj).max() < 1e-11
    assert np.abs(vk - rk).max() < 1e-11
    assert len(eng._plans) >= 2 and not eng._plans_full
    eng.reset_incremental()
    assert eng._incr == {}


# ------------------------------------------- plans against the JAX package
def _task_set(entries):
    """Real tasks as a sorted list of (classes, tier, bra, ket, w) rows,
    bra/ket swapped into canonical order where both pairs share a pair
    class (the two engines may order tied Schwarz bounds differently)."""
    rows = []
    for e in entries:
        if "idx" in e:
            idx, w = e["idx"], e["w"]
        else:
            idx = np.stack([np.asarray(t).reshape(-1) for t in e["tasks"][:4]])
            w = np.asarray(e["tasks"][4]).reshape(-1)
        keep = w != 0
        idx, w = idx[:, keep], w[keep]
        ci = tuple(e["cls_idx"])
        bra = idx[0] * 100000 + idx[1]
        ket = idx[2] * 100000 + idx[3]
        if ci[:2] == ci[2:]:
            bra, ket = np.minimum(bra, ket), np.maximum(bra, ket)
        tier = "fp64" if e["tier"] in ("df64", "fp64") else "f32"
        for b, k, ww in zip(bra, ket, w):
            rows.append((ci, tier, int(b), int(k), float(ww)))
    return sorted(rows)


@pytest.fixture(scope="module")
def jax_q():
    """A JAX engine with its Schwarz bounds for omega 0 and 0.3 (the
    small ``_q_diag_fn`` jit only; no Fock build)."""
    jmol = JMolecule.from_atom_string(H2O, basis="sto-3g")
    c32, c64, _ = TIERS["mixed"]
    jeng = JJKEngine(JLayout(jmol), cutoff_fp32=c32, cutoff_fp64=c64,
                     accum="block", tile=4)
    for pc in jeng.pair_classes:
        jeng._ensure_q(pc)
        jeng._ensure_q(pc, OMEGA)
    return jeng


def _copy_q(jeng, eng):
    for pj, pp in zip(jeng.pair_classes, eng.pair_classes):
        pp.i_loc, pp.j_loc = pj.i_loc.copy(), pj.j_loc.copy()
        pp.diag, pp.q_log = pj.diag.copy(), pj.q_log.copy()
        pp.q_omega = {k: v.copy() for k, v in pj.q_omega.items()}


def _bounds(mol, dm):
    lay = BasisLayout(mol)
    D = np.log(np.maximum(lay.dm_cond(lay.dm_to_internal(dm)), 1e-30))
    Dm = (D.astype(np.float32) + 0.7).astype(np.float32)
    return float(D.astype(np.float32).max()) + 0.7, Dm


def test_omega_plan_matches_jax(h2o, jax_q):
    """With the JAX Schwarz bounds for omega 0 and 0.3, the port's
    omega = 0.3 plan holds exactly the tasks, tiers and weights of JAX
    ``_build_plan(logdm, Dm, omega=0.3)``; the attenuated bounds move
    tasks out of the fp64 tier."""
    mol, dms, _ = h2o
    logdm, Dm = _bounds(mol, dms["sym"])
    eng = _engine(mol, "scatter", "mixed")
    _copy_q(jax_q, eng)
    plan = eng._build_plan(logdm, Dm, omega=OMEGA)
    stats = dict(eng.plan_stats)
    jplan = jax_q._build_plan(logdm, Dm, omega=OMEGA)
    assert _task_set(plan) == _task_set(jplan)
    for k in ("ntasks", "n64", "cand", "cand64"):
        assert stats[k] == jax_q.plan_stats[k], k
    eng._build_plan(logdm, Dm)
    assert stats["ntasks"] <= eng.plan_stats["ntasks"]
    assert stats["n64"] < eng.plan_stats["n64"]


def test_block_plan_matches_jax(h2o, jax_q):
    """The port's block plan (tile=4) holds the task set of the JAX block
    plan, entry by entry in the same mode.  The JAX plan pads its last
    chunk with pad tasks, which form a group of their own, so its group
    count can be one power of two above the port's."""
    mol, dms, _ = h2o
    logdm, Dm = _bounds(mol, dms["sym"])
    eng = _engine(mol, "block", "mixed")
    _copy_q(jax_q, eng)
    plan = eng._build_plan(logdm, Dm)
    jplan = jax_q._build_plan(logdm, Dm)
    assert _task_set(plan) == _task_set(jplan)

    def shape(entries):
        return sorted((tuple(e["ls"]), tuple(e["cls_idx"]),
                       "fp64" if e["tier"] == "df64" else e["tier"],
                       e["accum"], e.get("nrows", 0)) for e in entries)

    ours, theirs = shape(plan), shape(jplan)
    assert [x[:4] for x in ours] == [x[:4] for x in theirs]
    assert all(a[4] in (b[4], b[4] // 2) for a, b in zip(ours, theirs))
    assert any(e["accum"] == "block" for e in plan)
