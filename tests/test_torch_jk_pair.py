"""Port pair J/K engine (scf/jk_pair.py) vs the JAX package and the oracles.

The port's ``PairJEngine(device="cpu")`` runs the same PyTorch code as on
the card.  The JAX side is held through its cheap routes: the stacked MD
helpers called eagerly (DF64 runs as float64 emulation on the CPU,
tests/conftest.py), its task lists (``build_quartet_tasks``, numpy),
and the dense oracle and quartet engine that tests/test_jk_pair.py
itself uses; the cases, densities and bounds are that file's.  The JAX ``PairJEngine`` compiles
its unrolled primitive-pair scans for minutes, so the whole-engine
comparison with it is the one ``slow`` test here.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu.mol import Molecule as JMolecule
from joltqc_tpu.mol.layout import BasisLayout as JLayout
from joltqc_tpu.ops import df64 as df
from joltqc_tpu.ops import md as jmd
from joltqc_tpu.ops.arith import get_arith
from joltqc_tpu.scf import tasks as jtasks
from joltqc_tpu_torch.mol import Molecule, intor_np
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.ops import md
from joltqc_tpu_torch.ops.boys import boys
from joltqc_tpu_torch.scf import JKEngine, PairJEngine, PairJKEngine
from joltqc_tpu_torch.scf import jk_pair

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
OH = "O 0 0 0; H 0 0 0.96"
ALL_FP64 = (1e-30, 1e-30)
MIXED = (1e-14, 1e-7)


def _dm(nao, seed, lo=-1.0, hi=1.0, eye=0.0):
    a = np.random.default_rng(seed).uniform(lo, hi, (nao, nao))
    return a + a.T + eye * np.eye(nao)


_ERI = {}


def _oracle(atoms, basis, dm):
    key = (atoms, basis)
    if key not in _ERI:
        _ERI[key] = intor_np.eri(Molecule.from_atom_string(atoms, basis=basis))
    g = _ERI[key]
    return np.einsum("ijkl,kl->ij", g, dm), np.einsum("ijkl,jk->il", g, dm)


def _engine(atoms, basis, cutoffs):
    mol = Molecule.from_atom_string(atoms, basis=basis)
    return mol, PairJEngine(BasisLayout(mol), device="cpu",
                            cutoff_fp32=cutoffs[0], cutoff_fp64=cutoffs[1])


# ------------------------------------------------------ (a) MD helpers
def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("li,lj", [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1),
                                   (2, 2)])
def test_e_rows_match_jax_stack_e_pairs(li, lj):
    """e_rows(e_table) == stack_e_pairs(e_tensor): same (f, t) order."""
    rng = np.random.default_rng(10 * li + lj)
    T = 16
    inv2p = 0.5 / rng.uniform(0.2, 6.0, T)
    xpa, xpb = rng.normal(0, 0.7, (T, 3)), rng.normal(0, 0.7, (T, 3))
    epref = rng.uniform(0.05, 1.0, T)
    ar = get_arith("df64")
    ref = df.to_f64(jmd.stack_e_pairs(ar, li, lj, jmd.e_tensor(
        ar, li, lj, df.from_f64(inv2p), df.from_f64(xpa), df.from_f64(xpb),
        df.from_f64(epref))))
    t = [torch.as_tensor(x) for x in (inv2p, xpa, xpb, epref)]
    got = md.e_rows(li, lj, md.e_table(li, lj, *t)).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-13


@pytest.mark.parametrize("L", [0, 1, 2, 4, 6, 8])
def test_r_table_matches_jax_r_tensor_stacked(L):
    rng = np.random.default_rng(L)
    T = 16
    theta = rng.uniform(0.1, 4.0, T)
    pq = rng.normal(0, 1.0, (T, 3))
    fv = boys(L, torch.as_tensor(theta * (pq * pq).sum(-1)))
    ref = df.to_f64(jmd.r_tensor_stacked(
        get_arith("df64"), L, df.from_f64(theta), df.from_f64(pq),
        [df.from_f64(fv[m].numpy()) for m in range(L + 1)]))
    got = md.r_table(L, torch.as_tensor(theta), torch.as_tensor(pq),
                     fv).numpy()
    assert _rel(got, ref) < 1e-13


def test_batched_md_helpers_equal_flat():
    """The (B, npp_b, npp_k) batch the pair path uses gives the flat
    batch's numbers bit for bit."""
    rng = np.random.default_rng(3)
    shape = (5, 3, 2)
    A, B = rng.normal(size=shape + (3,)), rng.normal(size=shape + (3,))
    a, b = rng.uniform(0.2, 3, shape), rng.uniform(0.2, 3, shape)
    t = {k: torch.as_tensor(v) for k, v in dict(A=A, B=B, a=a, b=b).items()}
    pd = md.make_pair_data(t["A"], t["B"], t["a"], t["b"], t["a"])
    flat = md.make_pair_data(*(t[k].reshape(-1, 3) for k in "AB"),
                             t["a"].reshape(-1), t["b"].reshape(-1),
                             t["a"].reshape(-1))
    E = md.e_rows(2, 1, md.e_table(2, 1, 0.5 / pd["p"], pd["xpa"],
                                   pd["xpb"], pd["epref"]))
    Ef = md.e_rows(2, 1, md.e_table(2, 1, 0.5 / flat["p"], flat["xpa"],
                                    flat["xpb"], flat["epref"]))
    assert torch.equal(E.reshape(Ef.shape), Ef)
    th = pd["p"] / 7.0
    R = md.r_table(5, th, pd["P"], boys(5, th))
    Rf = md.r_table(5, th.reshape(-1), flat["P"], boys(5, th.reshape(-1)))
    assert torch.equal(R.reshape(Rf.shape), Rf)


@pytest.mark.parametrize("lab,lcd", [(0, 0), (1, 2), (2, 2), (4, 3), (4, 4)])
def test_coupling_index_and_ket_signs_equal_jax(lab, lcd):
    assert np.array_equal(md.coupling_index(lab, lcd),
                          jmd.coupling_index(lab, lcd))
    assert np.array_equal(md.ket_signs(lcd), jmd.ket_signs(lcd))


# ----------------------------------------------------- (b) task lists
def test_task_lists_equal_jax_task_lists():
    """Every pair-class pair of H2O/6-31g: the engine's tasks, weights and
    tiers are JAX ``build_quartet_tasks``' on the same (q-sorted) pair
    lists, and its shell and pair classes are the JAX package's."""
    mol, eng = _engine(H2O, "6-31g", MIXED)
    jcls = jtasks.build_shell_classes(
        JLayout(JMolecule.from_atom_string(H2O, basis="6-31g")),
        merge_nprim=True)
    assert [(c.l, c.nprim) for c in jcls] == [(c.l, c.nprim)
                                              for c in eng.jk.classes]
    for jc, c in zip(jcls, eng.jk.classes):
        assert np.array_equal(jc.exps, c.exps)
        assert np.array_equal(jc.ao, c.ao)
    (_, log32, log64), _ = eng._prepare(_dm(mol.nao, 5))
    got = {(p1, p2, tier): rest for p1, p2, tier, *rest
           in eng.task_sets(log32, log64)}
    pcs = eng.jk.pair_classes
    jpcs = jtasks.build_pair_classes(jcls)
    want = {}
    for p1i in range(len(pcs)):
        assert np.array_equal(np.sort(jpcs[p1i].i_loc * 1000
                                      + jpcs[p1i].j_loc),
                              np.sort(pcs[p1i].i_loc * 1000 + pcs[p1i].j_loc))
        for p2i in range(p1i + 1):
            same = p1i == p2i
            t1, t2, w, t64 = jtasks.build_quartet_tasks(
                pcs[p1i], pcs[p2i], same, log32, log64)
            wj = np.where(same & (t1 == t2), 0.5, 1.0)
            for tier, sel in (("fp64", t64), ("f32", ~t64)):
                if sel.any():
                    want[(p1i, p2i, tier)] = (t1[sel], t2[sel], w[sel],
                                              wj[sel])
    assert got.keys() == want.keys()
    assert {k[2] for k in want} == {"fp64", "f32"}
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert np.array_equal(g, w), k


# ------------------------------------------- (c) oracle, quartet engine
# tests/test_jk_pair.py's cases: (atoms, basis, density, seed, what)
ORACLE_CASES = [
    (H2O, "sto-3g", dict(seed=0), "j"),
    (H2O, "sto-3g", dict(seed=1), "k"),
    (H2O, "6-31g", dict(seed=4, lo=-0.3, hi=0.3, eye=1.0), "j"),
    (OH, "6-31g", dict(seed=4), "jk"),
]


@pytest.mark.parametrize("atoms,basis,dmkw,what", ORACLE_CASES,
                         ids=["h2o-sto3g-j", "h2o-sto3g-k", "h2o-631g-j",
                              "oh-631g-jk"])
def test_all_fp64_matches_dense_oracle(atoms, basis, dmkw, what):
    mol, eng = _engine(atoms, basis, ALL_FP64)
    dm = _dm(mol.nao, **dmkw)
    rj, rk = _oracle(atoms, basis, dm)
    if what == "j":
        got = {"j": eng.get_j(dm)}
    elif what == "k":
        got = {"k": eng.get_k(dm)}
    else:
        got = dict(zip("jk", eng.get_jk(dm)))
    for kind, v in got.items():
        ref = rj if kind == "j" else rk
        assert np.abs(v - ref).max() < 1e-9, (kind, np.abs(v - ref).max())
    run = eng.last_run["get_" + what[0]]
    assert run["tasks"]["f32"] == 0 and run["tasks"]["fp64"] > 0


@pytest.mark.parametrize("kind,seed", [("j", 2), ("k", 3)])
@pytest.mark.parametrize("cutoffs", [MIXED, (1e-14, 1.0)])
def test_mixed_matches_oracle_and_quartet_engine(kind, seed, cutoffs):
    """tests/test_jk_pair.py's mixed cases (1e-14/1e-7), and a split that
    sends most tasks to the f32 tier (1e-14/1.0: 99 of 120): within 1e-5
    of the oracle and of the port's quartet JKEngine at the same
    cutoffs."""
    mol, eng = _engine(H2O, "sto-3g", cutoffs)
    dm = _dm(mol.nao, seed)
    rj, rk = _oracle(H2O, "sto-3g", dm)
    v = eng.get_j(dm) if kind == "j" else eng.get_k(dm)
    qe = JKEngine(BasisLayout(mol), device="cpu", cutoff_fp32=cutoffs[0],
                  cutoff_fp64=cutoffs[1])
    qj, qk = qe.get_jk(dm, with_j=kind == "j", with_k=kind == "k")
    ref, q = (rj, qj) if kind == "j" else (rk, qk)
    assert np.abs(v - ref).max() < 1e-5
    assert np.abs(v - q).max() < 1e-5
    if cutoffs[1] == 1.0:
        run = eng.last_run["get_" + kind]
        assert run["tasks"]["f32"] > run["tasks"]["fp64"] > 0


# ---------------------------------------------------- (d) determinism
def test_bit_identical_across_calls_and_chunk_budgets(monkeypatch):
    mol, eng = _engine(OH, "6-31g", MIXED)
    dm = _dm(mol.nao, 4)
    j1, k1 = eng.get_jk(dm)
    j2, k2 = eng.get_jk(dm)
    monkeypatch.setattr(jk_pair, "PAIR_CHUNK_ELEMS", 1 << 12)
    _, small = _engine(OH, "6-31g", MIXED)
    j3, k3 = small.get_jk(dm)
    assert small.last_run["get_j"]["chunks"] > 4 * eng.last_run["get_j"][
        "chunks"]
    for a, b in ((j1, j2), (k1, k2), (j1, j3), (k1, k3)):
        assert np.array_equal(a, b)


def test_limb_bounds_hold(monkeypatch):
    """Every contribution lies below its accumulator's 2^e (JH: the
    analytic bound; vk: the Schwarz bound), and the engine refuses a
    system whose limb sums could overflow."""
    seen = []
    add = jk_pair.add_limbs_

    def spy(acc, values, idx, e):
        seen.append(float(values.abs().max()) / 2.0 ** e)
        return add(acc, values, idx, e)

    monkeypatch.setattr(jk_pair, "add_limbs_", spy)
    mol, eng = _engine(OH, "6-31g", ALL_FP64)
    eng.get_jk(_dm(mol.nao, 4))
    assert seen and max(seen) < 1.0
    monkeypatch.setattr(jk_pair, "LIMB_TERMS_MAX", 100)
    with pytest.raises(ValueError, match="int64 limbs"):
        eng.get_j(_dm(mol.nao, 4))


def test_alias_and_default_device():
    assert PairJKEngine is PairJEngine
    assert set(jk_pair.__all__) >= {"PairJEngine", "PairJKEngine"}
    if not torch.cuda.is_available():
        mol = Molecule.from_atom_string(H2O, basis="sto-3g")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PairJEngine(BasisLayout(mol))


# ------------------------------------------ (f) the JAX engine itself
@pytest.mark.slow
def test_engine_matches_jax_pair_engine():
    """The port against the JAX PairJEngine on H2O/sto-3g, same density:
    1e-10 (about ten minutes of JAX compiles on a CPU)."""
    from joltqc_tpu.scf.jk_pair import PairJEngine as JPair

    dm = _dm(7, 0)
    jeng = JPair(JLayout(JMolecule.from_atom_string(H2O, basis="sto-3g")),
                 cutoff_fp32=1e-30, cutoff_fp64=1e-30)
    _, eng = _engine(H2O, "sto-3g", ALL_FP64)
    assert np.abs(eng.get_j(dm) - jeng.get_j(dm)).max() < 1e-10
    assert np.abs(eng.get_k(dm) - jeng.get_k(dm)).max() < 1e-10
