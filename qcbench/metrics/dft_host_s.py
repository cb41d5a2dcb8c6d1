"""Host seconds of get_veff's DFT layer outside its card work, per call in
the window: the program's spans rows_s (sigma, the E_xc and electron
sums, the potential rows, in numpy) and to_mol_s (V_xc to the mol basis)
in RKS.veff_time."""

from qcbench.metrics._spans import per_call


def read(ctx):
    return per_call(ctx, "veff_time", ("rows_s", "to_mol_s"))
