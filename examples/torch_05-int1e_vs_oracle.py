"""The port's one-electron integrals against the numpy oracle at a real
size (joltqc_tpu_torch).

Builds S, T and V of a molecule with the class-batched engine
(``scf/int1e.py::Int1eEngine``) and with the loop-per-shell-pair oracle
(``mol/intor_np.py``), and prints the largest difference of each beside
its largest element and both wall times.  On 0029-elongated-halogenated
/6-31g* (302 AO) the oracle takes about two minutes on the CPU.

  PYTHONPATH=. python3 examples/torch_05-int1e_vs_oracle.py --device cpu
  PYTHONPATH=. python3 examples/torch_05-int1e_vs_oracle.py [mol.xyz basis]
"""

import argparse
import os
import time

import numpy as np

from joltqc_tpu_torch.mol import Molecule, intor_np
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf.int1e import Int1eEngine

HERE = os.path.dirname(os.path.abspath(__file__))
XYZ = os.path.join(HERE, "..", "benchmarks", "molecules",
                   "0029-elongated-halogenated.xyz")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xyz", nargs="?", default=XYZ)
    ap.add_argument("basis", nargs="?", default="6-31g*")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    mol = Molecule.from_xyz_file(args.xyz, basis=args.basis)
    t0 = time.perf_counter()
    got = Int1eEngine(BasisLayout(mol), device=args.device).stv()
    t_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = (intor_np.overlap(mol), intor_np.kinetic(mol),
            intor_np.nuclear(mol))
    t_oracle = time.perf_counter() - t0
    print(f"{os.path.basename(args.xyz)}/{args.basis}: {mol.nao} AO; port "
          f"{t_port:.1f} s, oracle {t_oracle:.1f} s")
    for name, a, b in zip("STV", got, want):
        print(f"{name}: max |port - oracle| {np.abs(a - b).max():.2e} "
              f"(max |{name}| {np.abs(b).max():.4g})")


if __name__ == "__main__":
    main()
