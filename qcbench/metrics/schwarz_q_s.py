"""Seconds of the Schwarz bounds in set-up (kernel A on each pair class's
diagonal and the copy to the host), by the program's span counter
JKEngine.timing['schwarz_q_s'], inside plan_build_s."""

from qcbench.metrics._spans import at_setup


def read(ctx):
    return at_setup(ctx, "jk.timing", "schwarz_q_s")
