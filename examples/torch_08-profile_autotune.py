"""Per-class timings, the autotune table and ``accum='auto'`` on the GPU
port (counterpart of examples/03-profile_kernels.py for
joltqc_tpu_torch).

1. ``profile=True``: the card is synchronised after each plan entry and
   each entry's wall time adds to ``class_time[(ls, nprims, tier)]``;
   J/K are unchanged to the bit.
2. ``tune_workload``: every class of a scatter engine's plan is timed at
   chunk sizes around the port's heuristic, and its block and tile
   entries (from engines in those modes) at their plan's chunk; the
   fastest mode and chunk per class go to the device's user table,
   ``$JQC_CACHE_DIR/joltqc_tpu_torch/autotune_<device>.json``.
3. ``accum='auto'``: an engine that routes each class by that table
   (untuned classes: tile on the card, scatter on the CPU), against the
   tile engine.

The table committed for the H100 (joltqc_tpu_torch/data/, see its
README) was measured with this script at 0029/6-31g*.

  PYTHONPATH=. python3 examples/torch_08-profile_autotune.py
  PYTHONPATH=. python3 examples/torch_08-profile_autotune.py --device cpu
  PYTHONPATH=. JQC_PLAN_CACHE=0 python3 examples/torch_08-profile_autotune.py \\
      --xyz benchmarks/molecules/0029-elongated-halogenated.xyz \\
      --basis 6-31g* --budget 600
"""

import argparse
import time

import numpy as np

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.scf import RHF, JKEngine
from joltqc_tpu_torch.utils import autotune

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--xyz", default=None, help="an xyz file (default: H2O)")
ap.add_argument("--basis", default="6-31g")
ap.add_argument("--budget", type=float, default=60.0,
                help="tune_workload's budget in seconds")
ap.add_argument("--max-chunks", type=int, default=4,
                help="chunks per timing in tune_workload")
ap.add_argument("--min-tasks", type=int, default=256,
                help="classes with fewer tasks are not tuned")
args = ap.parse_args()


def timed(eng, dm):
    eng.get_jk(dm)  # the plan and its upload
    t0 = time.perf_counter()
    out = eng.get_jk(dm)
    return out, time.perf_counter() - t0  # get_jk returns host arrays


if args.xyz:
    mol = Molecule.from_xyz_file(args.xyz, basis=args.basis)
else:
    mol = Molecule.from_atom_string(
        "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696",
        basis=args.basis)
mf = RHF(mol, device=args.device)
e = mf.kernel()
dm = mf.dm
print(f"E = {e:.10f} in {mf.scf_summary['cycles']} cycles ({mol.nao} AO)")

# 1. per-class wall times of one get_jk, on engines whose plans are
# screened at the converged density (the SCF's last plan was screened
# at an earlier one, so its J/K differ in the last bits)
kw = dict(device=args.device, cutoff_fp32=mf.cutoff_fp32,
          cutoff_fp64=mf.cutoff_fp64)
tile = JKEngine(mf.layout, accum="tile", **kw)
jt, wall_tile = timed(tile, dm)
tile.profile = True
jp = tile.get_jk(dm)
tile.profile = False
assert np.array_equal(jp[0], jt[0]) and np.array_equal(jp[1], jt[1])
print(f"tile get_jk {wall_tile:.3f} s; class_time sum "
      f"{sum(tile.class_time.values()):.3f} s; the slowest classes:")
for key, t in sorted(tile.class_time.items(), key=lambda kv: -kv[1])[:10]:
    print(f"  {t * 1e3:9.3f} ms  {key}")

# 2. tune on the converged density
scatter = JKEngine(mf.layout, accum="scatter", **kw)
block = JKEngine(mf.layout, accum="block", **kw)
for eng in (scatter, block):
    eng.get_jk(dm)
print(f"device {autotune._device_name(tile.device)}; committed table "
      f"{len(autotune.load_table(tile.device))} classes")
t0 = time.perf_counter()
table = autotune.tune_workload(scatter, block_engine=block, tile_engine=tile,
                               max_chunks=args.max_chunks,
                               min_tasks=args.min_tasks, budget_s=args.budget)
modes = [v["accum"] for v in table.values() if isinstance(v, dict)]
print(f"tuned in {time.perf_counter() - t0:.1f} s: {len(table)} classes, "
      f"modes { {m: modes.count(m) for m in sorted(set(modes))} }")

# 3. accum='auto' on the table just written
auto = JKEngine(mf.layout, accum="auto", **kw)
ja, wall_auto = timed(auto, dm)
print(f"auto get_jk {wall_auto:.3f} s (tile {wall_tile:.3f} s); tasks by "
      f"mode {auto.plan_stats['by_accum']}; vs tile max |dJ| "
      f"{np.abs(ja[0] - jt[0]).max():.2e} max |dK| "
      f"{np.abs(ja[1] - jt[1]).max():.2e}")
