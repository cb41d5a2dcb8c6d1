"""Kernel A's share of its roofline: the least time of the screened ERI
work of the window's calls at the card's peaks, over kernel A's device
time summed by name over the window."""

from qcbench.metrics._fock_work import least_times, share
from qcbench.roofline import KERNEL_A


def read(ctx):
    return share(ctx, least_times(ctx)[0], KERNEL_A)
