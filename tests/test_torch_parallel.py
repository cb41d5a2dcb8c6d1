"""Port sharded J/K (``JKEngine(group=...)``, ``joltqc_tpu_torch.parallel``):
bit-identity with one rank.

Against the JAX package: the sharded build equals the one-rank build of
the port to the bit, here, and the one-rank port at these inputs
(H2O/sto-3g and H2O/6-31g, the three accumulation modes, omega, hermi=0,
stacks, the incremental path) is what tests/test_torch_jk.py,
test_torch_jk_modes.py and test_torch_jk_block.py hold against the JAX
engine.  The (H2O)4/6-31g ``dryrun_multichip`` against the JAX package's
own single-chip result (tests/data/dryrun_ref_w4_631g.npz) is the one
``slow`` test here (about 100 s of CPU); it runs in full on the card in
phase ``multi`` of chip_smoke.py.

 - in process: a group-less engine with ``_split = (rank, world)`` runs
   one rank's slices and reduces nothing; its limb accumulators, summed
   over the ranks, must equal the one-rank accumulators bit for bit, call
   by call (``_limbs``), and every task runs on exactly one rank;
 - real processes: 2 and 3 gloo ranks (``file://`` rendezvous in
   ``tmp_path``) give J/K bit-identical to one rank, the plan of every
   rank equals the one-rank plan (idx, w, gslot, tb4) with the same
   ``plan_key``, and ranks whose plans or launch sizes differ raise.
"""

import os

import numpy as np
import pytest
import torch

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import JKEngine
from joltqc_tpu_torch.utils import plancache

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
MODES = {"tile": {"tile_w": 8}, "scatter": {}, "block": {"tile": 4}}
PLAN_ARRAYS = ("idx", "w", "gslot", "tb4")


@pytest.fixture(autouse=True)
def _no_plan_cache(monkeypatch):
    monkeypatch.setenv("JQC_PLAN_CACHE", "0")


def _density(nao, seed=0):
    a = np.random.default_rng(seed).uniform(-1, 1, (nao, nao))
    return a + a.T, a


def _calls(eng, dm, a, every):
    """get_jk plain, with hermi=0 and with omega 0.3; with ``every`` also
    a stack of 2 and two incremental calls."""
    eng.get_jk(dm)
    eng.get_jk(a, hermi=0)
    eng.get_jk(dm, omega=0.3)
    if every:
        eng.get_jk(np.stack([dm, 0.5 * dm + np.eye(len(dm))]))
        eng.reset_incremental()
        eng.get_jk_incr(dm)
        eng.get_jk_incr(1.1 * dm)


@pytest.mark.parametrize("basis", ["sto-3g", "6-31g"])
def test_split_limbs_sum_to_one_rank(basis):
    """R in {2, 3} in-process ranks: per call, the ranks' limb
    accumulators sum to the one-rank ones bit for bit; tile, scatter and
    block entries, every path of ``_calls`` at sto-3g, the first three at
    6-31g (a stack and the incremental path run the same slices on other
    densities, and cost 15 s more there)."""
    mol = Molecule.from_atom_string(H2O, basis=basis)
    dm, a = _density(mol.nao)
    for accum, kw in MODES.items():
        eng = JKEngine(BasisLayout(mol), device="cpu", accum=accum, **kw)
        assert eng.world == 1 and eng.group is None
        # one pass first: a later call may outgrow an earlier plan's
        # density margin and rebuild it; after it, every pass runs the
        # same plans
        _calls(eng, dm, a, basis == "sto-3g")
        runs = {}
        for split in (None, (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)):
            eng._split, eng._limbs = split, []
            _calls(eng, dm, a, basis == "sto-3g")
            runs[split] = (eng._limbs, eng.plan_stats["rank_tasks"])
        one, ntasks = runs[None]
        assert ntasks == eng.plan_stats["ntasks"] > 0
        assert eng.plan_stats["by_accum"][accum] == ntasks
        for R in (2, 3):
            parts = [runs[(r, R)] for r in range(R)]
            assert sum(p[1] for p in parts) == ntasks, (accum, R)
            assert all(p[1] > 0 for p in parts), (accum, R)
            for i, (acc1, e) in enumerate(one):
                for k, a1 in enumerate(acc1):
                    got = [p[0][i][0][k] for p in parts]
                    if a1 is None:
                        assert all(g is None for g in got)
                        continue
                    assert all(p[0][i][1] == e for p in parts)
                    assert torch.equal(sum(got), a1), (accum, R, i, k)


def test_group_helpers_no_fallback(monkeypatch):
    """``task_group`` needs a group or torchrun's environment;
    ``rank_device`` gives the CPU only when asked; without a card the
    sharded engine raises rather than falling back."""
    import torch.distributed as dist

    from joltqc_tpu_torch.parallel import (
        rank_device, sharded_jk_engine, task_group,
    )

    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        task_group()
    assert rank_device(None, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device(None)
        lay = BasisLayout(Molecule.from_atom_string(H2O, basis="sto-3g"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_jk_engine(lay, group=object())
    assert not dist.is_initialized()


def _rank_worker(rank, world, tmp):
    """A spawned gloo rank: tile and block get_jk on H2O/sto-3g, the plan
    arrays and key, then a run whose plan differs on the last rank, and
    one whose launch sizes (an ``'auto'`` engine's tuned chunks) do."""
    import torch.distributed as dist

    from joltqc_tpu_torch.parallel import sharded_jk_engine

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        mol = Molecule.from_atom_string(H2O, basis="sto-3g")
        lay = BasisLayout(mol)
        dm, a = _density(mol.nao)
        out = {}
        for accum, kw in MODES.items():
            if accum == "scatter":
                continue
            eng = sharded_jk_engine(lay, group, device="cpu", accum=accum,
                                    **kw)
            vj, vk = eng.get_jk(dm)
            out[f"{accum}_vj"], out[f"{accum}_vk"] = vj, vk
            out[f"{accum}_tasks"] = np.array(
                [eng.plan_stats["rank_tasks"], eng.plan_stats["ntasks"],
                 eng.timing["reduce_bytes"]])
            out[f"{accum}_key"] = np.array(plancache.plan_key(
                eng, 0.0, None, 0.0) or "")
            for i, x in enumerate(eng._plan):
                for f in PLAN_ARRAYS:
                    if f in x:
                        out[f"{accum}_{i}_{f}"] = x[f]
        # the last rank sends every task to the f32 tier: its plan differs
        cut = 1.0 if rank == world - 1 else 1e-6
        eng = sharded_jk_engine(lay, group, device="cpu", cutoff_fp64=cut)
        try:
            eng.get_jk(dm)
            out["mismatch"] = np.array("")
        except RuntimeError as e:
            out["mismatch"] = np.array(str(e))
        # the last rank's autotune table gives other launch sizes: the
        # same plan, cut into other slices
        eng = sharded_jk_engine(lay, group, device="cpu", accum="auto")
        if rank == world - 1:
            eng._tuned_chunk = lambda ls, nprims, tier, ntasks: 8
        try:
            eng.get_jk(dm)
            out["chunk_mismatch"] = np.array("")
        except RuntimeError as e:
            out["chunk_mismatch"] = np.array(str(e))
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_gloo_ranks_bit_identical(tmp_path):
    """2 and 3 real gloo ranks (one test, so that this file keeps four
    and is handed out after tests/test_jk_pair.py; ROADMAP)."""
    for world in (2, 3):
        _check_gloo_ranks(world, tmp_path / f"r{world}")


def _check_gloo_ranks(world, tmp_path):
    import torch.multiprocessing as mp

    tmp_path.mkdir()
    mp.spawn(_rank_worker, args=(world, str(tmp_path)), nprocs=world,
             join=True)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    mol = Molecule.from_atom_string(H2O, basis="sto-3g")
    lay = BasisLayout(mol)
    dm, _ = _density(mol.nao)
    for accum, kw in MODES.items():
        if accum == "scatter":
            continue
        eng = JKEngine(lay, device="cpu", accum=accum, **kw)
        vj, vk = eng.get_jk(dm)
        key = plancache.plan_key(eng, 0.0, None, 0.0) or ""
        tasks = [int(x[f"{accum}_tasks"][0]) for x in ranks]
        assert sum(tasks) == eng.plan_stats["ntasks"] > 0 and min(tasks) > 0
        for x in ranks:
            np.testing.assert_array_equal(x[f"{accum}_vj"], vj)
            np.testing.assert_array_equal(x[f"{accum}_vk"], vk)
            assert str(x[f"{accum}_key"]) == key
            assert int(x[f"{accum}_tasks"][2]) > 0  # limbs were reduced
            for i, e in enumerate(eng._plan):
                for f in PLAN_ARRAYS:
                    if f in e:
                        np.testing.assert_array_equal(x[f"{accum}_{i}_{f}"],
                                                      e[f])
            assert f"{accum}_{len(eng._plan)}_idx" not in x
    for x in ranks:
        assert "differs from that of rank" in str(x["mismatch"])
        assert "differs from that of rank" in str(x["chunk_mismatch"])


@pytest.mark.slow
def test_dryrun_multichip_cpu_vs_jax_npz():
    """(H2O)4/6-31g, block, 2 gloo ranks on the CPU: bit-identical to one
    rank and within 1e-6 of the JAX package's single-chip J/K."""
    from joltqc_tpu_torch.entry import dryrun_multichip

    got = dryrun_multichip(2, device="cpu")
    assert got["ntasks"] == sum(got["rank_tasks"]) == 243639
    assert got["gap_j"] < 1e-6 and got["gap_k"] < 1e-6
