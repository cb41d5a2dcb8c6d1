"""``driver.jk.get_jk(dm)`` on the mix's fixed density: J and K, on the
host, compared with the reference's J and K."""

from __future__ import annotations

from qcbench.inputs import max_rel

names = ("J", "K")


def bind(driver, inputs, cell):
    get_jk, dm = driver.jk.get_jk, inputs.dm
    return lambda k: get_jk(dm)


def reference(inputs, config, limits, device):
    from qcbench.reference.jk import get_jk

    return get_jk(inputs.ref_mol, inputs.dm, device,
                  thresh=limits["ref_thresh"])


def numbers(out, ref):
    return {"J": max_rel(out[0], ref[0]), "K": max_rel(out[1], ref[1])}
