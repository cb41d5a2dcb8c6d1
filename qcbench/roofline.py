"""The yardstick of the Fock build's kernels: the card's published peaks,
the operations of one primitive quartet of the ERI chain, the bytes the
kernels must move, and the program's kernel names.

The arithmetic is a frozen copy of ``chip_smoke.py``'s bounds
(``_eri_flops``, ``_fock_bounds``); the work it counts comes from the
reference's own screening (``reference.jk.quartet_counts``), never from
the program's plan, so the same work is counted whatever implements it.
"""

from __future__ import annotations

import itertools
import math

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: HBM3 bytes/s,
# and FLOP/s outside the tensor cores (FFMA and DFMA, which kernel A uses)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "fp64": 34e12}
ELEM_BYTES = {"f32": 4, "fp64": 8}

# the program's kernel names (torch.profiler rows): kernel A, the ERI
# chunk, and kernel B, the tile path's contraction and accumulation
KERNEL_A = r"eri_(class_|generic_)?kernel"
KERNEL_B = r"contract_kernel|accum_tile_kernel"


def cart_components(l):
    return [(lx, ly, l - lx - ly) for lx in range(l, -1, -1)
            for ly in range(l - lx, -1, -1)]


def nf(l):
    return (l + 1) * (l + 2) // 2


def _flops_ordered(ls):
    la, lb, lc, ld = ls
    L = sum(ls)
    lab = la + lb
    nr = 0
    for m in range(L - 1, -1, -1):
        for s in range(1, L - m + 1):
            nr += (s + 1) * (s + 2) // 2 * 3
    ne = 0
    for li, lj in ((la, lb), (lc, ld)):
        for i in range(li):
            ne += 3 * 5 * (i + 2)
        for j in range(lj):
            for i in range(li + 1):
                ne += 3 * 5 * (i + j + 2)
    ntab = [(t, u, s - t - u) for s in range(lab + 1) for t in range(s + 1)
            for u in range(s - t + 1)]
    nasm = 0
    for c in cart_components(lc):
        for d in cart_components(ld):
            ket = (c[0] + d[0] + 1) * (c[1] + d[1] + 1) * (c[2] + d[2] + 1)
            nasm += len(ntab) * 2 * ket
            for a in cart_components(la):
                for b in cart_components(lb):
                    nasm += 2 * ((a[0] + b[0] + 1) * (a[1] + b[1] + 1)
                                 * (a[2] + b[2] + 1)) + 2
    return nr + ne + nasm


def eri_flops(ls):
    """Floating-point operations (a multiply-add counts 2) of one primitive
    quartet of the McMurchie-Davidson chain: R recursion, E tables and the
    ket-then-bra assembly, Boys function and pair data left out; the least
    over the eight orderings that give the same integrals, so that it
    stays a lower bound whichever order an implementation picks."""
    la, lb, lc, ld = ls
    orders = set()
    for (a, b), (c, d) in ((( la, lb), (lc, ld)), ((lc, ld), (la, lb))):
        for x, y in itertools.product(((a, b), (b, a)), ((c, d), (d, c))):
            orders.add(x + y)
    return min(_flops_ordered(o) for o in orders)


def least_times(counts):
    """(kernel A seconds, kernel B seconds): the least time the card needs
    for the screened work of one Fock build, J and K together.

    ``counts``: {(ls, nprims, tier): (quartets, primitive quartets)}.
    A: the larger of the operations at the tier's peak and its bytes (16 B
    of indices in, the cartesian ERI block out, per quartet).  B: bytes
    only, each read once: the ERI block and 20 B of indices and weight per
    quartet.  (chip_smoke.py's B bound reads the block once per output
    stream; once is the least, and keeps the share under 100% where the
    six streams' reads of a block hit in the L2 cache.)"""
    ta = tb = 0.0
    for (ls, _, tier), (nq, npq) in counts.items():
        es = ELEM_BYTES[tier]
        nfel = math.prod(nf(x) for x in ls)
        ta += max(npq * eri_flops(ls) / PEAK_FLOPS[tier],
                  nq * (16 + nfel * es) / PEAK_BYTES)
        tb += nq * (nfel * es + 20) / PEAK_BYTES
    return ta, tb
