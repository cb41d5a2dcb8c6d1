"""Host wall seconds of get_veff's DFT layer (grid AO values, rho, XC,
V_xc) per call in the window, by the program's own counter
RKS.veff_time['dft']."""


def read(ctx):
    before = ctx.counters["setup"].get("veff_time")
    after = ctx.counters["window"].get("veff_time")
    if before is None or after is None or not ctx.calls:
        return None
    return (after["dft"] - before["dft"]) / ctx.calls
