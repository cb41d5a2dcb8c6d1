"""FP32 / FP64 / mixed precision task routing on the GPU port
(counterpart of examples/02-mixed_precision.py for joltqc_tpu_torch).

The cutoffs route each screened shell-quartet task by its Schwarz x
density bound: contributions above cutoff_fp64 run in float64, the rest
in float32; cutoff_fp32 drops tasks entirely.  Each routing runs RHF to
convergence and prints its energy beside the default's, so a shift that
comes from the f32 tier or from screening shows up as a difference.

  PYTHONPATH=. python3 examples/torch_02-mixed_precision.py          # H2O/6-31g
  PYTHONPATH=. python3 examples/torch_02-mixed_precision.py mol.xyz 6-31g*
"""

import sys

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.scf import RHF

if len(sys.argv) > 1:
    mol = Molecule.from_xyz_file(sys.argv[1], basis=sys.argv[2])
else:
    mol = Molecule.from_atom_string(
        "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696",
        basis="6-31g",
    )

configs = {
    "mixed (default)": dict(cutoff_fp32=1e-13, cutoff_fp64=1e-6),
    "fp64-only": dict(cutoff_fp32=1e-13, cutoff_fp64=1e-30),
    "fp64-only, cutoff_fp32=1e-16": dict(cutoff_fp32=1e-16, cutoff_fp64=1e-30),
}
ref = None
for name, cfg in configs.items():
    mf = RHF(mol, **cfg)
    e = mf.kernel()
    if ref is None:
        ref = e
    st = mf.jk.plan_stats
    print(f"{name:30s} E = {e:.10f}  dE vs default = {e - ref:+.3e}  "
          f"cycles {mf.scf_summary['cycles']}  converged {mf.converged}  "
          f"tasks {st['ntasks']} (fp64 {st['n64']})", flush=True)
