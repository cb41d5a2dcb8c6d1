"""The whole Fock build's share of the card's peak: the least time of
kernels A's and B's work over the traced window's wall time per call."""

from qcbench.metrics._fock_work import least_times


def read(ctx):
    if ctx.trace is None:
        return None
    ta, tb = least_times(ctx)
    return 100.0 * (ta + tb) * ctx.calls / ctx.trace.window_s
