"""The least time of one Fock build's kernel work on the cell's inputs,
from the reference's screening at the configuration's cutoffs (shared by
the roofline readers; computed once per run)."""

from __future__ import annotations

from qcbench import roofline
from qcbench.reference.jk import quartet_counts


def least_times(ctx):
    """(kernel A seconds, kernel B seconds) of one call, cached on ctx."""
    got = ctx.cache.get("least_times")
    if got is None:
        kw = ctx.cell.config["method"]["kwargs"]
        counts = quartet_counts(ctx.inputs.ref_mol, ctx.inputs.dm,
                                kw["cutoff_fp32"], kw["cutoff_fp64"],
                                ctx.device)
        got = ctx.cache["least_times"] = roofline.least_times(counts)
    return got


def share(ctx, least, pattern):
    """100 x least time of the window's calls over the device time of the
    kernels named by ``pattern``; None where the trace holds none."""
    if ctx.trace is None:
        return None
    t = ctx.trace.device_time(pattern)
    if t <= 0.0:
        return None
    return 100.0 * least * ctx.calls / t
