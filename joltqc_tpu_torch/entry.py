"""Entry points: the production Fock step, and the multi-rank dryrun.

Port of the repository root's ``__graft_entry__.py`` (the JAX package's):

``entry()`` returns ``(fn, args)``: the hot step of the J/K engine, one
tile entry's first launch at H2O/6-31g through the engine's own chunk
loop -- kernel A (the chunk's ERI blocks) then kernel B (density
contraction and exact integer-limb tile accumulation, the six output
streams) into the (1, E, E, 3) limb accumulators.  It runs on ``cuda``
unless ``device='cpu'`` is passed (the plain PyTorch versions).

``dryrun_multichip(n)`` spawns n gloo ranks (all on ``cuda:0`` on a
one-card machine, or on the CPU when asked), runs the sharded
``get_jk`` at (H2O)4/6-31g with ``accum='block'`` on the JAX dryrun's
seed-0 density, and asserts that every rank's J/K is bit-identical to a
one-rank engine's and within 1e-6 of the JAX package's single-chip result
(``tests/data/dryrun_ref_w4_631g.npz``, read only; the bound is the mixed
tier's).  Run ``python -m joltqc_tpu_torch.entry [n]`` for both.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import numpy as np
import torch

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
WATERS = "; ".join([
    "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696",
    "O 3 0 0.1174; H 2.243 0 -0.4696; H 3.757 0 -0.4696",
    "O 0 3 0.1174; H -0.757 3 -0.4696; H 0.757 3 -0.4696",
    "O 3 3 0.1174; H 2.243 3 -0.4696; H 3.757 3 -0.4696",
])
REF_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data", "dryrun_ref_w4_631g.npz")
REF_TOL = 1e-6  # the mixed tier's bound against the JAX single-chip run
DRYRUN_TIMEOUT_S = 900.0  # the ranks' spawn to exit; then they are killed


def _require(cond, msg):
    """The dryrun's checks (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def _seed0_density(nao):
    rng = np.random.default_rng(0)
    dm = rng.standard_normal((nao, nao))
    return dm + dm.T


def entry(device=None):
    """(fn, args): ``fn(*args)`` runs the engine's own launch
    (``JKEngine._run_entry``) of the first chunk of the first tile entry
    of the H2O/6-31g plan (``JKEngine(accum='tile', tile_w=8)``, seed-0
    density): kernel A, then kernel B on its six streams.  It adds into
    the (1, E, E, 3) int64 J and K limb accumulators of ``args`` (zero
    there) and returns them; ``fn.e`` is their limb exponent
    (``limbs_to_f64`` decodes them), ``fn.tier`` the entry's tier."""
    from .mol import Molecule
    from .mol.layout import BasisLayout
    from .ops.accum import bound_exponent
    from .ops.eri import tier_dtype
    from .scf.jk_contracted import JKEngine

    mol = Molecule.from_atom_string(H2O, basis="6-31g")
    layout = BasisLayout(mol)
    eng = JKEngine(layout, device=device, accum="tile", tile_w=8)
    dm_int = layout.dm_to_internal(_seed0_density(mol.nao))
    D = np.log(np.maximum(layout.dm_cond(dm_int), 1e-30)).astype(np.float32)
    plan = eng._ensure_full_plan(D, float(D.max()), 0.0)
    ent = next(x for x in plan if x["accum"] == "tile")
    e = max(bound_exponent(x["bound"]) for x in plan)  # as _run_plan
    B = min(eng._entry_chunk(ent), ent["ntasks"])
    dm_t = torch.as_tensor(dm_int, dtype=tier_dtype(ent["tier"]),
                           device=eng.device)
    EJ, EK, _, _ = eng._accumulators(1, True, True, True, False)

    def fock_step(dm, EJ, EK):
        eng._run_entry(ent, "tile", dm[None], (EJ, EK, None, None), e,
                       stop=B)
        return EJ, EK

    fock_step.e, fock_step.tier = e, ent["tier"]
    return fock_step, (dm_t, EJ, EK)


def _dryrun_rank(rank, world, tmp, device):
    """One spawned rank of ``dryrun_multichip``: the sharded block
    ``get_jk``; its J/K and counts go to ``tmp/rank<r>.npz``."""
    import torch.distributed as dist

    from .mol import Molecule
    from .mol.layout import BasisLayout
    from .ops.accum import accum_block_chunk
    from .ops.eri import eri_chunk
    from .parallel import rank_device, sharded_jk_engine

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DRYRUN_TIMEOUT_S))
    try:
        group = dist.group.WORLD
        mol = Molecule.from_atom_string(WATERS, basis="6-31g")
        eng = sharded_jk_engine(BasisLayout(mol), group, accum="block",
                                device=rank_device(group, device))
        eri_chunk.launches = accum_block_chunk.launches = 0
        t0 = time.perf_counter()
        vj, vk = eng.get_jk(_seed0_density(mol.nao))
        wall = time.perf_counter() - t0
        st, plan = eng.plan_stats, eng._plan
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), vj=vj, vk=vk,
                 counts=np.array([
                     st["rank_tasks"], st["ntasks"], st["n64"], len(plan),
                     sum(x["accum"] == "block" for x in plan),
                     eri_chunk.launches, accum_block_chunk.launches,
                     eng.timing["reduce_bytes"]], np.int64),
                 secs=np.array([wall, eng.timing["reduce_s"]]))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Sharded ``get_jk`` over ``n_devices`` spawned gloo ranks at
    (H2O)4/6-31g, block accumulation; asserts bit-identity with one rank
    and the 1e-6 gap to the JAX package's single-chip result, prints the
    JAX dryrun's lines, and returns the measured numbers."""
    from .mol import Molecule
    from .mol.layout import BasisLayout
    from .ops.cuda import resolve_device
    from .parallel import spawn_ranks
    from .scf.jk_contracted import JKEngine

    dev = resolve_device(device)
    mol = Molecule.from_atom_string(WATERS, basis="6-31g")
    with tempfile.TemporaryDirectory(prefix="jqc_dryrun_") as tmp:
        spawn_s = spawn_ranks(_dryrun_rank, n_devices, (tmp, dev.type),
                              timeout=DRYRUN_TIMEOUT_S)
        ranks = []
        for r in range(n_devices):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
    (_, ntasks, n64, ncls, nblk, _, _, reduce_bytes) = (
        int(v) for v in ranks[0]["counts"])
    rank_tasks = [int(x["counts"][0]) for x in ranks]
    print(f"dryrun_multichip: nao={mol.nao} classes={ncls} (block-accum "
          f"{nblk}) ntasks={ntasks} fp64={n64} tasks/rank={rank_tasks} "
          f"[{n_devices} ranks on {dev.type}, spawn+build+run "
          f"{spawn_s:.1f}s]", flush=True)
    _require(sum(rank_tasks) == ntasks,
             f"tasks per rank {rank_tasks} do not sum to {ntasks}")

    vj_1, vk_1 = JKEngine(BasisLayout(mol), device=dev,
                          accum="block").get_jk(_seed0_density(mol.nao))
    err_j = max(float(np.abs(x["vj"] - vj_1).max()) for x in ranks)
    err_k = max(float(np.abs(x["vk"] - vk_1).max()) for x in ranks)
    print(f"dryrun_multichip: sharded-vs-one-rank |dJ|={err_j:.3e} "
          f"|dK|={err_k:.3e}", flush=True)
    _require(np.all(np.isfinite(vj_1)) and np.any(vj_1 != 0),
             "one-rank J is not finite and nonzero")
    _require(mol.nao >= 50 and ncls > 10, f"nao {mol.nao}, {ncls} classes")
    _require(all(np.array_equal(x["vj"], vj_1)
                 and np.array_equal(x["vk"], vk_1) for x in ranks),
             "sharded get_jk differs from one rank")

    with np.load(REF_NPZ) as z:
        gap_j = float(np.abs(vj_1 - z["vj"]).max())
        gap_k = float(np.abs(vk_1 - z["vk"]).max())
    print(f"dryrun_multichip: vs the JAX single-chip result |dJ|={gap_j:.3e}"
          f" |dK|={gap_k:.3e} (tol {REF_TOL:g})", flush=True)
    _require(gap_j < REF_TOL and gap_k < REF_TOL,
             f"|dJ| {gap_j:.3e}, |dK| {gap_k:.3e} from the JAX result")
    jmax = float(np.abs(vj_1).max())
    print(f"dryrun_multichip ok: {n_devices} ranks, nao={mol.nao}, "
          f"|J|max={jmax:.6f}", flush=True)
    return dict(
        ranks=n_devices, nao=mol.nao, classes=ncls, ntasks=ntasks,
        rank_tasks=rank_tasks, gap_j=gap_j, gap_k=gap_k, jmax=jmax,
        eri_launches=[int(x["counts"][5]) for x in ranks],
        block_launches=[int(x["counts"][6]) for x in ranks],
        wall_s=[float(x["secs"][0]) for x in ranks],
        reduce_s=[float(x["secs"][1]) for x in ranks],
        reduce_bytes=reduce_bytes, spawn_s=spawn_s)


if __name__ == "__main__":
    import sys

    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry ok")
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
