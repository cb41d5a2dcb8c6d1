"""RKS DFT on the GPU port: pure, hybrid and range-separated functionals
(counterpart of examples/01-rks_dft.py for joltqc_tpu_torch).

Runs on the card unless ``--device cpu`` is given; the defaults are the
JAX package's (Lebedev 302 grid, mixed float32/float64 numint, AO
screening where it pays, VV10 for the -v functionals).

  PYTHONPATH=. python3 examples/torch_01-rks_dft.py
  PYTHONPATH=. python3 examples/torch_01-rks_dft.py --device cpu
"""

import argparse

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.scf import RKS

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

mol = Molecule.from_atom_string(
    "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696",
    basis="6-31g",
)

for xc in ("pbe", "b3lyp", "wb97x-v"):
    mf = RKS(mol, xc=xc, device=args.device)
    e = mf.kernel()
    print(f"E({xc}) = {e:.10f} Ha  (grid nelec = {mf._nelec_grid:.6f}, "
          f"{mf.scf_summary['cycles']} cycles, converged {mf.converged})")
