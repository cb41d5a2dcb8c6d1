"""The J/K engine's accumulation modes, omega, hermi=0 and density stacks
on the GPU port (joltqc_tpu_torch).

One JKEngine per accumulation mode builds J and K of the same density:
  tile     fused contract + integer tile accumulation (csrc/accum_tile.cu)
  scatter  batched stream contractions, then an integer limb scatter
  block    the same contractions, segment-summed per shell tile by the
           block kernel (csrc/accum_block.cu), then a scatter of the rows
All three sum exact integer limbs, so they differ only by the rounding of
the contraction.  The script prints the largest differences between the
modes, then the long-range (omega) J/K, a non-symmetric density
(hermi=0), a stack of two densities and an incremental SCF.

  PYTHONPATH=. python3 examples/torch_03-jk_modes.py                # on the card
  PYTHONPATH=. python3 examples/torch_03-jk_modes.py --device cpu   # plain versions
"""

import argparse

import numpy as np

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import RHF, JKEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--basis", default="6-31g")
args = ap.parse_args()

mol = Molecule.from_atom_string(
    "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696", basis=args.basis)
mf = RHF(mol, device=args.device)
e_direct = mf.kernel()
dm = mf.dm
print(f"RHF/{args.basis}: E = {e_direct:.10f} in {mf.scf_summary['cycles']} "
      "cycles")

layout = BasisLayout(mol)
engines = {
    "tile": JKEngine(layout, device=args.device, accum="tile"),
    "scatter": JKEngine(layout, device=args.device, accum="scatter"),
    "block": JKEngine(layout, device=args.device, accum="block", tile=4),
}
jk = {name: eng.get_jk(dm) for name, eng in engines.items()}
for name, eng in engines.items():
    print(f"{name:8s} tasks by entry mode {eng.plan_stats['by_accum']}")
for name in ("tile", "block"):
    dj = np.abs(jk[name][0] - jk["scatter"][0]).max()
    dk = np.abs(jk[name][1] - jk["scatter"][1]).max()
    print(f"{name:8s} vs scatter: max |dJ| = {dj:.2e}  max |dK| = {dk:.2e}")

eng = engines["tile"]
# long-range Coulomb kernel erf(omega r)/r: its own re-screened plan
jo, ko = eng.get_jk(dm, omega=0.3)
print(f"omega=0.3: max |J_lr| = {np.abs(jo).max():.4f} "
      f"(full {np.abs(jk['tile'][0]).max():.4f})")

# a non-symmetric density: J sees the symmetric part, K both parts
a = np.random.default_rng(0).standard_normal(dm.shape) * 1e-2
x = dm + a
jh, kh = eng.get_jk(x, hermi=0)
js, _ = eng.get_jk(0.5 * (x + x.T), with_k=False)
print(f"hermi=0: max |J(x) - J(sym x)| = {np.abs(jh - js).max():.1e}  "
      f"max |K - K^T| = {np.abs(kh - kh.T).max():.2e}")

# a stack: the ERIs are computed once and contracted with every density
sj, sk = eng.get_jk(np.stack([dm, 0.5 * dm]))
print(f"stack [dm, dm/2]: max |J1 - J0/2| = "
      f"{np.abs(sj[1] - 0.5 * sj[0]).max():.1e}")

# incremental direct SCF: Fock builds on dm - dm_prev
mi = RHF(mol, device=args.device, incremental=True)
e_incr = mi.kernel()
print(f"incremental RHF: E = {e_incr:.10f}  dE vs direct = "
      f"{e_incr - e_direct:+.1e}  plan builds per bucket "
      f"{ {str(k[0]): v for k, v in mi.jk.plan_builds.items()} }")
