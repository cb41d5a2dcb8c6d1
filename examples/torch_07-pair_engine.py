"""The pair-algorithm J/K engine on the GPU port (counterpart of the pair
half of examples/06-multi_dm_and_pair_engine.py for joltqc_tpu_torch).

``PairJKEngine`` builds J through the Hermite-density factorisation (the
right algorithm for J-only, pure-functional DFT) and K through
per-task E·M·Eᵀ products; both are held here against the quartet engine
on the same density.  Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=. python3 examples/torch_07-pair_engine.py
  PYTHONPATH=. python3 examples/torch_07-pair_engine.py --device cpu
"""

import argparse

import numpy as np

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import JKEngine, PairJKEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

mol = Molecule.from_atom_string(
    "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696", basis="6-31g"
)
layout = BasisLayout(mol)
a = np.random.default_rng(0).uniform(-1, 1, (mol.nao, mol.nao))
dm = a + a.T

vj, vk = JKEngine(layout, device=args.device).get_jk(dm)
pair = PairJKEngine(layout, device=args.device)
vj_p = pair.get_j(dm)  # Hermite-density Coulomb
vk_p = pair.get_k(dm)  # E @ M @ E^T exchange
print("pair vs quartet |dJ| =", np.abs(vj_p - vj).max())
print("pair vs quartet |dK| =", np.abs(vk_p - vk).max())
for call, run in pair.last_run.items():
    print(f"{call}: tasks {run['tasks']}, primitive quartets "
          f"{run['quartets']}, {run['chunks']} chunks, {run['wall_s']:.3f} s")
