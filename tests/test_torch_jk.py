"""Port J/K engine (tile accumulation) vs the JAX package and the oracle.

The port's ``JKEngine(device="cpu")`` runs its plain versions; the JAX
``JKEngine(accum="tile", tile_w=8)`` runs as tests/test_jk_engine.py
runs it, on the CPU with x64.  Both see the same density, made with
numpy from a seed.  Bounds are the reference's: 1e-9 for the fp64 tier,
1e-6 mixed (tests/test_jk_engine.py).
"""

import numpy as np
import pytest
import torch

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu.scf import JKEngine as JJKEngine
from joltqc_tpu_torch.convert import plan_from_numpy
from joltqc_tpu_torch.mol import Molecule, intor_np
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import JKEngine

torch.set_num_threads(1)

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""

# (cutoff_fp32, cutoff_fp64, bound): all-fp64 and mixed routing.  The
# random density is O(1), so a mixed split needs a large cutoff_fp64.
# The JAX tile path takes entries of more than 64 tasks (chunk % 128);
# at sto-3g the fp64 plan has two, the rest go to its scatter path.
TIERS = {"fp64": (1e-30, 1e-30, 1e-9), "mixed": (1e-14, 0.1, 1e-6)}


def _dm(nao, seed):
    a = np.random.default_rng(seed).uniform(-1, 1, (nao, nao))
    return a + a.T


@pytest.fixture(scope="module")
def h2o():
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    dm = _dm(mol.nao, seed=7)
    g = intor_np.eri(mol)
    ref = (np.einsum("ijkl,kl->ij", g, dm), np.einsum("ikjl,kl->ij", g, dm))
    return mol, dm, ref


@pytest.fixture(scope="module")
def jax_runs(h2o):
    """One JAX tile engine per routing: its J/K and its plan."""
    _, dm, _ = h2o
    jmol = JMolecule.from_atom_string(H2O, basis="sto-3g")
    out = {}
    for name, (c32, c64, _) in TIERS.items():
        eng = JJKEngine(JLayout(jmol), cutoff_fp32=c32, cutoff_fp64=c64,
                        accum="tile", tile_w=8)
        vj, vk = eng.get_jk(dm)
        out[name] = (eng, vj, vk)
    return out


def _port_engine(mol, name):
    c32, c64, _ = TIERS[name]
    return JKEngine(BasisLayout(mol), device="cpu", cutoff_fp32=c32,
                    cutoff_fp64=c64, tile_w=8)


def _task_set(entries, tier_key):
    """Real tasks as a sorted array of (classes, tier, bra, ket, w) rows,
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
        # int64: a plan loaded from a disk cache holds narrowed indices
        idx, w = np.asarray(idx, np.int64)[:, keep], w[keep]
        ci = tuple(e["cls_idx"])
        bra = idx[0] * 100000 + idx[1]
        ket = idx[2] * 100000 + idx[3]
        if ci[:2] == ci[2:]:
            bra, ket = np.minimum(bra, ket), np.maximum(bra, ket)
        tier = tier_key(e["tier"])
        for b, k, ww in zip(bra, ket, w):
            rows.append((ci, tier, int(b), int(k), float(ww)))
    return sorted(rows)


def _tier(t):
    return "fp64" if t in ("df64", "fp64") else "f32"


@pytest.mark.parametrize("name", list(TIERS))
def test_get_jk_matches_jax_and_oracle(h2o, jax_runs, name):
    mol, dm, (vj_ref, vk_ref) = h2o
    eng = _port_engine(mol, name)
    vj, vk = eng.get_jk(dm)
    _, vj_j, vk_j = jax_runs[name]
    tol = TIERS[name][2]
    assert np.abs(vj - vj_j).max() < tol
    assert np.abs(vk - vk_j).max() < tol
    assert np.abs(vj - vj_ref).max() < tol
    assert np.abs(vk - vk_ref).max() < tol
    # the task plans hold the same tasks, tiers and weights
    jeng = jax_runs[name][0]
    assert _task_set(eng._plan, _tier) == _task_set(jeng._plan, _tier)
    if name == "mixed":
        assert {e["tier"] for e in eng._plan} == {"f32", "fp64"}
    # repeated builds are bit-identical (exact integer accumulation)
    vj2, vk2 = eng.get_jk(dm)
    assert np.array_equal(vj, vj2) and np.array_equal(vk, vk2)


def test_plan_from_numpy_runs_the_jax_plan(h2o, jax_runs):
    """The JAX plan (tile and scatter entries), carried across by
    plan_from_numpy, runs through the port and reproduces the JAX J/K."""
    mol, dm, _ = h2o
    jeng, vj_j, vk_j = jax_runs["fp64"]
    assert {e["accum"] for e in jeng._plan} == {"tile", "scatter"}
    eng = _port_engine(mol, "fp64")
    plan = plan_from_numpy(jeng._plan, eng.classes, tile_w=eng.tile_w)
    assert _task_set(plan, _tier) == _task_set(jeng._plan, _tier)
    vj, vk = eng.get_jk(dm, plan=plan)
    assert np.abs(vj - vj_j).max() < 1e-9
    assert np.abs(vk - vk_j).max() < 1e-9


def test_plan_matches_jax_for_the_same_schwarz_bounds(h2o, jax_runs):
    """Given the JAX engine's Schwarz bounds, the port's _build_plan
    makes exactly the JAX plan's task set (H2O/6-31g would take minutes
    of JAX compiles; the split classes of sto-3g's O 1s/2sp suffice)."""
    mol, dm, _ = h2o
    jeng = jax_runs["mixed"][0]
    eng = _port_engine(mol, "mixed")
    for pj, pp in zip(jeng.pair_classes, eng.pair_classes):
        pp.i_loc, pp.j_loc = pj.i_loc.copy(), pj.j_loc.copy()
        pp.diag, pp.q_log = pj.diag.copy(), pj.q_log.copy()
    plan = eng.build_plan(dm)
    assert _task_set(plan, _tier) == _task_set(jeng._plan, _tier)
