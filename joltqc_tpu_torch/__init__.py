"""joltqc_tpu_torch: the PyTorch + CUDA port of joltqc_tpu for one
NVIDIA H100.

The JAX package ``joltqc_tpu`` stays the reference; this package imports
neither JAX nor ``joltqc_tpu``.  Host-side numpy modules are copied
(mol/, scf/tasks.py, scf/diis.py, native/), tensor code is PyTorch, and
the four TPU kernels of the reference are hand-written CUDA for sm_90a
(csrc/eri.cu, the two kernels of csrc/accum_tile.cu, csrc/accum_block.cu).
RKS DFT (dft/, scf/rks.py) runs its grid work as PyTorch products with a
float64 tier; its Fock builds go through the same kernels.  Effective
core potentials (mol/ecp.py, scf/ecp.py, ops/bessel.py) enter hcore as
float64 PyTorch type-1/type-2 integrals, with their ip/ipip/gradient
derivatives; an element missing from the basis data gets the generated
fallback basis of mol/basis_gen.py.  Task plans and Schwarz bounds persist
on disk across processes, and ``accum='auto'`` routes each class by a
per-device autotune table (utils/).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``, which runs the
plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"

from .mol import Molecule  # noqa: F401,E402
from .scf import RHF, RKS, JKEngine  # noqa: F401,E402
