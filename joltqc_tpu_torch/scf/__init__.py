from .hf import RHF  # noqa: F401
from .jk_contracted import JKEngine  # noqa: F401
