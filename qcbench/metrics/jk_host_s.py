"""Host seconds a get_jk call spends around its launches, per call in the
window: the program's spans prepare_s (the symmetry check, the internal
basis, the density bound, the plan check, the density's upload) and
unfold_s (P + P^T and the mol basis) in JKEngine.timing."""

from qcbench.metrics._spans import per_call


def read(ctx):
    return per_call(ctx, "jk.timing", ("prepare_s", "unfold_s"))
