"""Global layout constants (copy of ``joltqc_tpu/constants.py``, the
parts the port uses).

Invariants of the reference implementation (JoltQC jqc/constants.py):
the maximum angular momentum and the primitive-segment cap.
"""

# Maximum angular momentum supported (s,p,d,f,g)
LMAX = 4

# Max primitives per (split) contracted shell; shells with more primitives
# are split into several <=NPRIM_MAX shells (see scf/tasks.py).
NPRIM_MAX = 3


# Number of cartesian components for angular momentum l
def nf_cart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


# Number of spherical components for angular momentum l
def nf_sph(l: int) -> int:
    return 2 * l + 1


__all__ = ["LMAX", "NPRIM_MAX", "nf_cart", "nf_sph"]
