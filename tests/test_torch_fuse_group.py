"""Port ``JKEngine.fuse_group``: the plan run in groups of G entries.

On the CPU each group runs its entries directly (on the card it is one
CUDA graph, tests/test_torch_gpu.py), with the same call keys and the
same state in the plan's first entry.  Port engines only, ``device="cpu"``
(the per-entry path is held against the JAX plans by
tests/test_torch_jk_modes.py): J/K of every G must equal the per-entry
loop's bit for bit, since the limb sums are exact and every launch is the
same.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import JKEngine

torch.set_num_threads(1)

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""

MODES = {"scatter": {}, "block": {"tile": 4}}


@pytest.fixture(scope="module")
def systems():
    out = {}
    for basis in ("sto-3g", "6-31g"):
        mol = Molecule.from_atom_string(H2O, basis=basis)
        a = np.random.default_rng(11).uniform(-1, 1, (mol.nao, mol.nao))
        out[basis] = (BasisLayout(mol), a)
    return out


def _equal(x, y):
    return all(np.array_equal(p, q) for p, q in zip(x, y))


def _calls(lay, a):
    """name -> call(engine): one density, a stack of two through
    ``_run_plan`` (a block entry then runs as scatter), hermi=0, omega.
    ``a`` scaled by 0.9 keeps the plan (inside its 0.7 log margin)."""
    dm = a + a.T
    stack = np.stack([lay.dm_to_internal(dm),
                      lay.dm_to_internal(0.5 * dm + np.eye(len(dm)))])
    return {
        "one": lambda eng: eng.get_jk(dm),
        "stack": lambda eng: eng._run_plan(stack, True, True),
        "hermi0": lambda eng: eng.get_jk(a, hermi=0),
        "omega": lambda eng: eng.get_jk(dm, omega=0.3),
    }


@pytest.mark.parametrize("basis", ["sto-3g", "6-31g"])
def test_groups_bit_identical(systems, basis):
    """Scatter and block engines, G in {1, 3, len(plan)}: the key's first
    call (and at G = 3 a repeat, which reuses the key's state) equals the
    per-entry loop's J/K, and at G = 3 so does a call of one density
    with another density under the same key (0.9 a: the state's static
    buffers take the new density); the plan's first entry holds a state per call key (G, n_dm,
    with_j, with_k, omega, e, modes, launch sizes).  One
    test per basis: a file of at most four tests is handed out after the
    suite's longest file by pytest-xdist's loadfile order."""
    for accum in MODES:
        _bit_identical(*systems[basis], accum)


def _bit_identical(lay, a, accum):
    eng = JKEngine(lay, device="cpu", accum=accum, **MODES[accum])
    other = _calls(lay, 0.9 * a)["one"]
    for name, call in _calls(lay, a).items():
        eng.fuse_group = None
        ref = call(eng)  # builds the case's plan first
        plan = eng._plan
        if name == "one":
            ref2 = other(eng)
            assert eng._plan is plan and not _equal(ref2, ref)
        for G in (1, 3, len(plan)):
            eng.fuse_group = G
            for rep in range(2 if G == 3 else 1):
                assert _equal(call(eng), ref), (name, G, rep)
            if G == 3 and name == "one":
                nkeys = len(plan[0]["_groups"])
                assert _equal(other(eng), ref2), "0.9 a"
                assert len(plan[0]["_groups"]) == nkeys
            assert eng._plan is plan
        keys = list(plan[0]["_groups"])
        assert {1, 3, len(plan)} <= {k[0] for k in keys}
        if name == "stack":  # a block entry runs as scatter
            assert any(k[1] == 2 and set(k[6]) == {"scatter"} for k in keys)
        elif name == "omega":
            assert any(k[4] == 0.3 for k in keys)
        elif accum == "block":
            assert any(k[1] == 1 and "block" in k[6] for k in keys)
        elif name == "hermi0":  # symmetric and antisymmetric parts stacked
            assert any(k[1] == 2 for k in keys)


def test_groups_rule(systems, monkeypatch):
    """``profile``, ``_split`` or a tile entry take the per-entry loop;
    a spy on the grouped run shows which ran.  A fuse_group that is not
    None or an int >= 1 raises."""
    lay, a = systems["sto-3g"]
    dm = a + a.T
    seen = []
    grouped = JKEngine._run_groups

    def spy(self, *args, **kw):
        seen.append(self)
        return grouped(self, *args, **kw)

    monkeypatch.setattr(JKEngine, "_run_groups", spy)
    ref = JKEngine(lay, device="cpu", accum="scatter").get_jk(dm)

    def run(accum="scatter", **attrs):
        eng = JKEngine(lay, device="cpu", accum=accum)
        eng.fuse_group = 3
        for k, v in attrs.items():
            setattr(eng, k, v)
        seen.clear()
        out = eng.get_jk(dm)
        return out, bool(seen)

    out, took = run()
    assert took and _equal(out, ref)
    out, took = run(profile=True)
    assert not took and _equal(out, ref)
    out, took = run(_split=(0, 1))
    assert not took and _equal(out, ref)
    tile, took = run(accum="tile")
    assert not took
    assert max(np.abs(p - q).max() for p, q in zip(tile, ref)) < 1e-9
    for bad in (0, -1, 2.5, False):
        with pytest.raises(ValueError, match="fuse_group"):
            run(fuse_group=bad)


def test_groups_rebuild(systems):
    """The density x10 passes the 0.7 log margin: the rebuilt plan has
    new group state, the old state leaves with the old plan, and J/K
    still equal the per-entry engine's on the same calls."""
    lay, a = systems["sto-3g"]
    dm = a + a.T
    for accum, kw in MODES.items():
        ref = JKEngine(lay, device="cpu", accum=accum, **kw)
        eng = JKEngine(lay, device="cpu", accum=accum, **kw)
        eng.fuse_group = 3
        assert _equal(eng.get_jk(dm), ref.get_jk(dm))
        old = eng._plan
        state = old[0]["_groups"]
        want = ref.get_jk(10.0 * dm)
        assert _equal(eng.get_jk(10.0 * dm), want)
        assert eng._plan is not old
        assert eng.plan_builds[("full", 0.0)] == 2
        new = eng._plan[0]["_groups"]
        assert new is not state and len(new) == 1
        assert all(old is not x for x, _ in eng._plans_full.values())
        assert _equal(eng.get_jk(10.0 * dm), want)
