"""Kernel B's share of its roofline: the least bytes of the same quartets
at the card's bandwidth, over kernel B's device time over the window."""

from qcbench.metrics._fock_work import least_times, share
from qcbench.roofline import KERNEL_B


def read(ctx):
    return share(ctx, least_times(ctx)[1], KERNEL_B)
