"""RHF with an effective core potential on the GPU port, and the ECP's
nuclear gradient (counterpart of examples/05-ecp.py for joltqc_tpu_torch).

NaH/sto-3g with the shipped model ECP ``jqc-model`` (10-core Na; Na is
not in the sto-3g data, so it gets the generated fallback basis, with a
warning).  Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=. python3 examples/torch_06-ecp.py
  PYTHONPATH=. python3 examples/torch_06-ecp.py --device cpu
"""

import argparse

import numpy as np

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.scf import RHF, ECPEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

mol = Molecule.from_atom_string("Na 0 0 0; H 0 0 1.89", basis="sto-3g",
                                ecp="jqc-model")
print("electrons (10-core ECP on Na):", mol.nelectron)

mf = RHF(mol, device=args.device)
e = mf.kernel()
print(f"E(RHF, ECP) = {e:.10f} Ha  ({mf.scf_summary['cycles']} cycles, "
      f"converged {mf.converged}; the JAX package's anchor -0.7088327233)")

grad = ECPEngine(mf.layout, device=args.device).gradient(mf.dm)
print("ECP nuclear gradient (Ha/Bohr):")
print(np.array_str(grad, precision=8))
