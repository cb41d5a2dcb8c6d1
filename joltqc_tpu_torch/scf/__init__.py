from .ecp import ECPEngine  # noqa: F401
from .hf import RHF  # noqa: F401
from .jk_contracted import JKEngine  # noqa: F401
from .jk_pair import PairJEngine, PairJKEngine  # noqa: F401
from .rks import RKS  # noqa: F401
