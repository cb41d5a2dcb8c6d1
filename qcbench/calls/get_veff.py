"""``driver.get_veff(dm)`` on the mix's fixed density: V_eff on the host,
with the two-electron energy (Coulomb + exchange-correlation, HF exchange
included) that the call leaves in the driver, read through
``energy_elec`` with h = 0; compared with the reference's B3LYP."""

from __future__ import annotations

import numpy as np

from qcbench.inputs import max_rel

names = ("V", "E")


def bind(driver, inputs, cell):
    dm = inputs.dm
    zero = np.zeros_like(dm)

    def call(k):
        v = driver.get_veff(dm)
        return v, driver.energy_elec(dm, zero, v)

    return call


def reference(inputs, config, limits, device):
    from qcbench.reference.dft import B3LYP_HYB, exc_vxc
    from qcbench.reference.jk import get_jk

    if config["method"]["kwargs"].get("xc") != "b3lyp":
        raise ValueError("the reference's functional is B3LYP")
    dm = inputs.dm
    J, K = get_jk(inputs.ref_mol, dm, device, thresh=limits["ref_thresh"])
    exc, vxc, _ = exc_vxc(inputs.ref_mol, dm, device)
    V = vxc + J - 0.5 * B3LYP_HYB * K
    E = (0.5 * float(np.einsum("ij,ij->", dm, J)) + exc
         - 0.25 * B3LYP_HYB * float(np.einsum("ij,ij->", dm, K)))
    return V, E


def numbers(out, ref):
    return {"V": max_rel(out[0], ref[0]), "E": abs(out[1] - ref[1])}
