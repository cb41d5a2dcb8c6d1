"""Host seconds of a get_jk call's launch loop, per call in the window:
the program's span launch_s in JKEngine.timing (the card runs behind it;
the wait for the card is the span drain_s)."""

from qcbench.metrics._spans import per_call


def read(ctx):
    return per_call(ctx, "jk.timing", ("launch_s",))
