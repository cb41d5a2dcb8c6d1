"""Port ``entry()`` (joltqc_tpu_torch/entry.py, the counterpart of the
JAX package's ``__graft_entry__.entry``): the production Fock step on the
CPU, plain versions of kernels A and B.

``fn(*args)`` is the engine's own launch (``_run_entry``) of the first
chunk of the first tile entry of the H2O/6-31g plan: it must add into the
limb accumulators what that launch adds on the plan that ``get_jk`` (the
path tests/test_torch_jk.py holds against the JAX engine) builds for the
same density, and its folded decode must equal that of the same tasks
through the scatter path (the flat accumulation, no tile kernel).
"""

import numpy as np
import torch

from joltqc_tpu_torch.entry import entry
from joltqc_tpu_torch.ops.accum import limbs_to_f64

torch.set_num_threads(1)


def test_entry_step_equals_engine_launch(monkeypatch):
    monkeypatch.setenv("JQC_PLAN_CACHE", "0")
    fn, args = entry(device="cpu")
    dm, EJ, EK = args
    assert EJ.shape == EK.shape and EJ.shape[0] == 1 and EJ.shape[-1] == 3
    assert not EJ.any() and not EK.any()
    out_j, out_k = fn(*args)
    assert out_j is EJ and out_k is EK
    assert EJ.any() and EK.any()

    # the same launch on the plan that get_jk builds for the seed-0 density
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.ops.accum import bound_exponent
    from joltqc_tpu_torch.scf import JKEngine

    mol = Molecule.from_atom_string(
        "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696", basis="6-31g")
    eng = JKEngine(BasisLayout(mol), device="cpu", accum="tile", tile_w=8)
    rng = np.random.default_rng(0)
    d = rng.standard_normal((mol.nao, mol.nao))
    eng.get_jk(d + d.T)
    ent = next(x for x in eng._plan if x["accum"] == "tile")
    e = max(bound_exponent(x["bound"]) for x in eng._plan)
    assert (e, ent["tier"]) == (fn.e, fn.tier)
    B = min(eng._entry_chunk(ent), ent["ntasks"])
    acc = eng._accumulators(1, True, True, True, False)
    assert eng._run_entry(ent, "tile", dm[None], acc, e, stop=B) == B > 0
    assert torch.equal(acc[0], EJ) and torch.equal(acc[1], EK)

    # the same tasks through the scatter path: folded, the same partials
    # (fp64 tier: 1e-13 of the limb scale 2^e, chip_smoke's ACC_TOL)
    assert fn.tier == "fp64"
    flat = eng._accumulators(1, True, True, False, True)
    assert eng._run_entry(ent, "scatter", dm[None], flat, e, stop=B) == B
    R = eng._efold()
    for ext, fl in ((EJ, flat[2]), (EK, flat[3])):
        tile = R.T @ limbs_to_f64(ext, e) @ R
        scat = limbs_to_f64(fl[:-1], e).view(tile.shape)
        assert scat.abs().max() > 0
        assert (tile - scat).abs().max() <= 1e-13 * 2.0 ** e

    # a second step adds the same limbs again
    fn(*args)
    assert torch.equal(EJ, 2 * acc[0]) and torch.equal(EK, 2 * acc[1])
