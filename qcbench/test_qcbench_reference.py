"""The yardstick: the reference against the port's plain CPU path at
H2O/sto-3g and H2O/6-31g*, the work counts of kernels A and B on a
hand-counted case, the control and the faults of the timed path, which
the comparison must call not correct, and the imports of a run."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from qcbench import harness, roofline
from qcbench.reference import int1e, jk
from qcbench.reference.basis import RefMolecule

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WATER = [("O", (0.0, 0.0, 0.2217)), ("H", (-1.43, 0.0, -0.887)),
         ("H", (1.43, 0.1, -0.887))]


def _pair(basis):
    """(the reference's molecule, the port's molecule) of WATER (Bohr)."""
    from joltqc_tpu_torch.mol import Molecule

    ref = RefMolecule([s for s, _ in WATER], [c for _, c in WATER], basis)
    prog = Molecule.from_atom_string(
        "\n".join(f"{s} {x} {y} {z}" for s, (x, y, z) in WATER),
        basis=basis, unit="bohr")
    return ref, prog


@pytest.mark.parametrize("basis", ["sto-3g", "6-31g*"])
def test_reference_agrees_with_the_ports_plain_path(basis):
    from joltqc_tpu_torch.scf import RHF, RKS

    ref, prog = _pair(basis)
    assert ref.nao == prog.nao
    mf = RHF(prog, device="cpu", cutoff_fp32=1e-30, cutoff_fp64=1e-30)
    S, T, V = int1e.one_electron(ref, "cpu")
    assert np.abs(S - mf.get_ovlp()).max() < 1e-12
    assert np.abs(T + V - mf.get_hcore()).max() < 1e-11
    dm = int1e.core_guess_density(ref, "cpu")
    assert np.abs(dm - mf.init_guess(mf.get_ovlp(), mf.get_hcore())) \
        .max() < 1e-9
    J, K = jk.get_jk(ref, dm, "cpu")
    Jp, Kp = mf.jk.get_jk(dm)
    assert np.abs(J - Jp).max() < 1e-11 * np.abs(J).max()
    assert np.abs(K - Kp).max() < 1e-11 * np.abs(K).max()
    # the semilocal B3LYP part on the reference's grid against the port's
    # float64 numint on its own grid
    from qcbench.reference.dft import B3LYP_HYB, exc_vxc

    ks = RKS(prog, xc="b3lyp", device="cpu", cutoff_fp32=1e-30,
             cutoff_fp64=1e-30)
    ks.dft_cutoff_fp64 = 1e-300
    veff = ks.get_veff(dm)
    exc, vxc, nel = exc_vxc(ref, dm, "cpu")
    assert abs(nel - ref.nelectron) < 1e-3
    assert np.abs(veff - (vxc + J - 0.5 * B3LYP_HYB * K)).max() < 1e-11
    e2 = ks.energy_elec(dm, np.zeros_like(dm), veff)
    e2_ref = (0.5 * np.einsum("ij,ij", dm, J) + exc
              - 0.25 * B3LYP_HYB * np.einsum("ij,ij", dm, K))
    assert abs(e2 - e2_ref) < 1e-11


def test_kernel_work_hand_counted_h2o_sto3g():
    # O 1s, O 2s, O 2p, H 1s, H 1s: four s shells and one p shell, three
    # primitives each.  Pairs: 10 ss, 4 ps, 1 pp; unique quartets by
    # angular momenta: ssss 55, sssp 40, sspp 10 + pspp 10, sppp 4, pppp 1
    ref, _ = _pair("sto-3g")
    dm = int1e.core_guess_density(ref, "cpu")
    counts = jk.quartet_counts(ref, dm, 1e-300, 1e-300, "cpu")
    by = {}
    for (ls, nprims, tier), (nq, npq) in counts.items():
        assert tier == "fp64" and nprims == (3, 3, 3, 3) and npq == 81 * nq
        key = tuple(sorted(ls))
        by[key] = by.get(key, 0) + nq
    assert by == {(0, 0, 0, 0): 55, (0, 0, 0, 1): 40, (0, 0, 1, 1): 20,
                  (0, 1, 1, 1): 4, (1, 1, 1, 1): 1}
    # (ss|ss): no R recursion or E steps, one Hermite term: 2 + 4 flops
    assert roofline.eri_flops((0, 0, 0, 0)) == 6
    ta, tb = roofline.least_times(counts)
    # B reads each ERI block once (8 B an element) and 20 B of indices
    nfel = {(0, 0, 0, 0): 1, (0, 0, 0, 1): 3, (0, 0, 1, 1): 9,
            (0, 1, 1, 1): 27, (1, 1, 1, 1): 81}
    tb_hand = sum(n * (8 * nfel[k] + 20) for k, n in by.items()) / 3.35e12
    assert tb == pytest.approx(tb_hand, rel=1e-12)
    ta_hand = 0.0
    for (ls, _, _), (nq, npq) in counts.items():
        ta_hand += max(npq * roofline.eri_flops(ls) / 34e12,
                       nq * (16 + 8 * nfel[tuple(sorted(ls))]) / 3.35e12)
    assert ta == pytest.approx(ta_hand, rel=1e-12)
    # nothing kept above every bound, and the f32 tier below cutoff_fp64
    assert jk.quartet_counts(ref, dm, 1e10, 1e20, "cpu") == {}
    assert {k[2] for k in jk.quartet_counts(ref, dm, 1e-300, 1e10, "cpu")} \
        == {"f32"}


def test_eri_flops_is_the_least_over_orderings():
    for ls in [(2, 1, 1, 0), (0, 1, 2, 1), (2, 2, 1, 0)]:
        assert roofline.eri_flops(ls) <= roofline._flops_ordered(ls)
    assert roofline.eri_flops((2, 1, 1, 0)) == roofline.eri_flops((1, 0, 1, 2))


@pytest.mark.parametrize("cell", ["water-rhf.fock", "water-b3lyp.veff"])
def test_control_is_not_correct(small_bench, cell):
    """The cell's control (its limits file names the program's own
    lower-precision path) must break a limit; run at water size."""
    from qcbench.control import readings

    c = harness.Cell.load(cell, small_bench, small_bench)
    res = readings(c, [11, 2 ** 32 + 1], "cpu")
    lim = c.limits["checks"]
    for nums in res["program"]:
        assert all(nums[k] <= lim[k] for k in lim)
    for nums in res["control"]:
        assert any(nums[k] > lim[k] for k in lim)


def _drop_half_of_the_plan(driver, fn):
    eng = driver.jk
    build = eng._build_plan

    def half(*a, **kw):
        plan = build(*a, **kw)
        return plan[::2]

    eng._build_plan = half
    return fn


def _alter_the_answer(driver, fn):
    def call(k):
        out = fn(k)
        a = out[0].copy()
        a[1, 2] += 1e-6 * np.abs(a).max()
        return (a,) + tuple(out[1:])

    return call


def _drop_half_of_the_grid(driver, fn):
    grids = driver.grids  # built in set-up
    w = grids.weights.reshape(-1, grids.block).copy()
    w[1::2] = 0.0
    grids.weights = w.reshape(-1)
    return fn


FAULTS = {"water-rhf.fock": [_drop_half_of_the_plan, _alter_the_answer],
          "water-b3lyp.veff": [_drop_half_of_the_plan, _drop_half_of_the_grid,
                               _alter_the_answer]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs])
def test_fault_is_not_correct(small_bench, cell, fault):
    res = harness.run(cell, 77, 0.2, 0, device="cpu", fault=fault,
                      chips_check=False, root=small_bench, data=small_bench)
    assert not res["correct"] and res["failed"] == res["attempted"]


def test_a_run_loads_no_jax(small_bench):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from qcbench import harness\n"
        f"harness.run('water-rhf.fock', 3, 0.2, 1, device='cpu', "
        f"chips_check=False, root={small_bench!r}, data={small_bench!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "joltqc_tpu_torch" in top and "qcbench" in top
    assert not top & {"jax", "jaxlib", "flax", "joltqc_tpu", "benchmarks"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["0029-rhf-631gs.fock",
                                  "0029-b3lyp-631gs.veff"])
def test_control_on_the_card(cuda_device, cell):
    """The control at the cell's own size, on three seeds."""
    from qcbench.control import readings

    c = harness.Cell.load(cell)
    res = readings(c, [101, 2 ** 31 + 7, 9999999999], cuda_device)
    lim = c.limits["checks"]
    assert all(all(n[k] <= lim[k] for k in lim) for n in res["program"])
    assert all(any(n[k] > lim[k] for k in lim) for n in res["control"])
