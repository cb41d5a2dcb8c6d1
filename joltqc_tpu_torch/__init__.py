"""joltqc_tpu_torch: the PyTorch + CUDA port of joltqc_tpu for one
NVIDIA H100.

The JAX package ``joltqc_tpu`` stays the reference; this package imports
neither JAX nor ``joltqc_tpu``.  Host-side numpy modules are copied
(mol/, scf/tasks.py, scf/diis.py, native/), tensor code is PyTorch, and
the four TPU kernels of the reference are hand-written CUDA for sm_90a
(csrc/eri.cu, the two kernels of csrc/accum_tile.cu, csrc/accum_block.cu).
Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, which runs the plain PyTorch
versions of the kernels.
"""

__version__ = "0.1.0"

from .mol import Molecule  # noqa: F401,E402
from .scf import RHF, JKEngine  # noqa: F401,E402
