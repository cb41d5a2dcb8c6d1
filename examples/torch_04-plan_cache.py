"""Task plans and Schwarz bounds persisted across processes (counterpart
of examples/04-aot_cache.py for joltqc_tpu_torch, whose kernels build
once per checkout into joltqc_tpu_torch/_build/ anyway).

An RHF builds one screened task plan per density-bound key it meets;
the plan depends on that key, not on the density, so a second run of the
same workload loads every plan from disk instead of screening again, and
its energy is the first run's to the bit.  Run this script twice and
compare the plan-build wall of the first run with the plan-load wall of
the second.  The cache lives in ``$JQC_CACHE_DIR/joltqc_tpu_torch``
(default ``~/.cache/joltqc_tpu_torch``); ``JQC_PLAN_CACHE=0`` turns it
off; a built plan is saved only if its build took at least
``JQC_PLAN_CACHE_MIN_SECS`` seconds (5 unless set: this script sets 0 so
that a small molecule's plans are saved too).

  PYTHONPATH=. python3 examples/torch_04-plan_cache.py
  PYTHONPATH=. python3 examples/torch_04-plan_cache.py --device cpu
  PYTHONPATH=. python3 examples/torch_04-plan_cache.py \\
      --xyz benchmarks/molecules/0029-elongated-halogenated.xyz --basis 6-31g*
"""

import argparse
import os
import time

os.environ.setdefault("JQC_PLAN_CACHE_MIN_SECS", "0")

from joltqc_tpu_torch.mol import Molecule  # noqa: E402
from joltqc_tpu_torch.scf import RHF  # noqa: E402
from joltqc_tpu_torch.utils.plancache import cache_root  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--xyz", default=None, help="an xyz file (default: H2O)")
ap.add_argument("--basis", default="6-31g")
args = ap.parse_args()

if args.xyz:
    mol = Molecule.from_xyz_file(args.xyz, basis=args.basis)
else:
    mol = Molecule.from_atom_string(
        "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696",
        basis=args.basis)
print("plan cache:", os.path.join(cache_root(), "plans"),
      "(off)" if os.environ.get("JQC_PLAN_CACHE") in ("0", "off", "none")
      else "")
mf = RHF(mol, device=args.device)
t0 = time.perf_counter()
e = mf.kernel()
wall = time.perf_counter() - t0
tm = mf.jk.timing
print(f"E = {e:.10f} in {mf.scf_summary['cycles']} cycles, SCF {wall:.2f} s")
print(f"plans built {tm.get('plan_builds', 0)} in "
      f"{tm.get('plan_build_s', 0.0):.3f} s (saved {tm.get('plan_saves', 0)}, "
      f"{tm.get('plan_save_bytes', 0)} bytes in "
      f"{tm.get('plan_save_s', 0.0):.3f} s); loaded {tm.get('plan_loads', 0)} "
      f"in {tm.get('plan_load_s', 0.0):.3f} s")
