"""DFT: molecular quadrature grids, XC functionals, numerical integration.

Port of ``joltqc_tpu/dft``: grids are built on the host in numpy (the JAX
package's code), AO/rho/vxc evaluation are float32 matrix products over
grid blocks on the device with a float64 tier for the heavy AO pairs,
and XC potentials come from ``torch.autograd`` in float64.
"""

from .grids import Grids
from .xc import eval_xc, hybrid_coeff, is_gga, parse_xc

__all__ = ["Grids", "eval_xc", "parse_xc", "hybrid_coeff", "is_gga"]
