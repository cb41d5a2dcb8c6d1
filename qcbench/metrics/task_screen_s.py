"""Seconds of the task screen in set-up (the C++ screen, or the numpy one,
over every pair of pair classes), by the program's span counter
JKEngine.timing['screen_s'], inside plan_build_s."""

from qcbench.metrics._spans import at_setup


def read(ctx):
    return at_setup(ctx, "jk.timing", "screen_s")
