"""Minimal RHF on the GPU port (counterpart of examples/00-rhf.py for
joltqc_tpu_torch).

H2O/6-31g to convergence; the Fock builds run kernels A and B on the card
unless ``--device cpu`` is given.

  PYTHONPATH=. python3 examples/torch_00-rhf.py
  PYTHONPATH=. python3 examples/torch_00-rhf.py --device cpu
"""

import argparse

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.scf import RHF

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

mol = Molecule.from_atom_string(
    "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696",
    basis="6-31g",
)
mf = RHF(mol, device=args.device, verbose=1)
e = mf.kernel()
print(f"E(RHF/6-31g) = {e:.10f} Ha  (converged: {mf.converged})")
print("timing:", mf.scf_summary)
