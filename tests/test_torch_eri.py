"""Port ERI chain (joltqc_tpu_torch.ops) vs the JAX package.

The port's plain PyTorch versions run on the CPU (``device="cpu"``
tensors); the JAX side runs as its own tests run it: on the CPU with x64
(tests/conftest.py), the Pallas class kernel in interpret mode.
Tolerances are those of tests/test_eri_pallas.py, relative to the
block's maximum: 1e-12 for the fp64 tier against JAX's df64 (which runs
as float64 on the CPU), 2e-5 for f32.
"""

import mpmath
import numpy as np
import pytest
import torch
from scipy import special

from joltqc_tpu.ops import df64 as df
from joltqc_tpu.ops.eri import contracted_eri_batch as jax_eri
from joltqc_tpu.ops.eri_pallas import eri_chunk_pallas
from joltqc_tpu_torch.ops.boys import boys
from joltqc_tpu_torch.ops.eri import contracted_eri_batch

torch.set_num_threads(1)

TOL = {"f32": 2e-5, "df64": 1e-12}

# the CASES of tests/test_eri_pallas.py.  The df64 Pallas kernel runs
# for about a minute per class in interpret mode; on the two heaviest
# classes the port is held to the XLA path only, which
# tests/test_eri_pallas.py holds to the Pallas kernel at the same bound.
PALLAS_DF64 = {(0, 0, 0, 0), (1, 0, 1, 0)}
CASES = [
    ((0, 0, 0, 0), (2, 2, 2, 2)),
    ((1, 0, 1, 0), (2, 1, 2, 1)),
    ((1, 1, 1, 1), (1, 1, 1, 1)),
    ((2, 1, 1, 0), (1, 1, 1, 1)),
]


def _geom(nprims, T, seed):
    """Per-center float64 numpy arrays, as test_eri_pallas._quartet."""
    rng = np.random.default_rng(seed)
    g = {}
    for name, npx in zip("abcd", nprims):
        g[f"coord_{name}"] = rng.standard_normal((T, 3))
        g[f"exps_{name}"] = rng.uniform(0.3, 3.0, (T, npx))
        g[f"coefs_{name}"] = rng.standard_normal((T, npx))
    return g


def _for_jax(g, tier):
    if tier == "df64":
        return {k: df.from_f64(v) for k, v in g.items()}
    return {k: np.asarray(v, np.float32) for k, v in g.items()}


def _for_port(g, tier):
    dt = torch.float64 if tier == "df64" else torch.float32
    return {k: torch.as_tensor(v, dtype=dt) for k, v in g.items()}


def _np(x, tier):
    return np.asarray(df.to_f64(x)) if tier == "df64" else np.asarray(x, np.float64)


def _rel(out, ref):
    return np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30)


# ------------------------------------------------------------------ (a)
def _boys_mp(m, x):
    if x == 0.0:
        return 1.0 / (2 * m + 1)
    return float(mpmath.gammainc(m + 0.5, 0, x)
                 / (2 * mpmath.mpf(x) ** (m + 0.5)))


def _boys_scipy(m, x):
    a = m + 0.5
    return special.gamma(a) * special.gammainc(a, x) / (2 * x ** a)


@pytest.mark.parametrize("mmax", [0, 4, 8, 16])
def test_boys_fp64_vs_oracles(mmax):
    """fp64 Boys to 1e-14 relative: against scipy's closed form where
    that form is itself good to 1e-14 (x >= 1e-2, m <= 8), and against
    a 40-digit mpmath evaluation on the whole grid (scipy's gammainc
    loses ~3e-14 at small x and high m)."""
    mpmath.mp.dps = 40
    grid = np.concatenate([
        [0.0, 1e-10, 1e-6], np.logspace(-4, 2.3, 60),
        np.linspace(8, 40, 65),  # every switch point max(12, 2m+5)
    ])
    f = boys(mmax, torch.as_tensor(grid)).numpy()
    for m in range(mmax + 1):
        ref = np.array([_boys_mp(m, x) for x in grid])
        rel = np.abs(f[m] - ref) / ref
        assert rel.max() < 1e-14, (m, grid[np.argmax(rel)], rel.max())
        if m <= 8:
            sel = grid >= 1e-2
            sref = _boys_scipy(m, grid[sel])
            srel = np.abs(f[m][sel] - sref) / sref
            assert srel.max() < 1e-14, (m, srel.max())


def test_boys_f32_vs_scipy():
    grid = np.concatenate([np.logspace(-4, 2.3, 200), np.linspace(8, 40, 65)])
    for mmax in (0, 6, 16):
        f = boys(mmax, torch.as_tensor(grid, dtype=torch.float32))
        for m in range(mmax + 1):
            ref = _boys_scipy(m, grid)
            rel = np.abs(f[m].double().numpy() - ref) / ref
            assert rel.max() < 2e-6, (mmax, m, rel.max())


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("ls,nprims", CASES)
@pytest.mark.parametrize("tier", ["f32", "df64"])
def test_eri_matches_jax(ls, nprims, tier):
    """Port contracted_eri_batch vs JAX contracted_eri_batch (XLA path)
    and eri_chunk_pallas (interpret mode) at T=128."""
    T = 128
    g = _geom(nprims, T, seed=sum(ls) + sum(nprims))
    gj = _for_jax(g, tier)
    ref = _np(jax_eri(tier, ls, nprims, gj, 0.0), tier)
    out = contracted_eri_batch(tier, ls, nprims, _for_port(g, tier)).double()
    out = out.numpy()
    assert out.shape == ref.shape
    assert _rel(out, ref) < TOL[tier]
    if tier == "f32" or ls in PALLAS_DF64:
        pal = _np(eri_chunk_pallas(tier, ls, nprims, gj, 0.0), tier)
        assert _rel(out, pal) < TOL[tier]


@pytest.mark.parametrize("tier", ["f32", "df64"])
def test_eri_omega_matches_jax(tier):
    """erf-attenuated kernel (omega > 0), as test_eri_pallas's omega case
    (which holds the f32 Pallas kernel; df64 against the XLA path)."""
    ls, nprims, T, omega = (1, 0, 1, 0), (2, 1, 2, 1), 128, 0.33
    g = _geom(nprims, T, seed=7)
    gj = _for_jax(g, tier)
    ref = _np(jax_eri(tier, ls, nprims, gj, omega), tier)
    out = contracted_eri_batch(tier, ls, nprims, _for_port(g, tier), omega)
    out = out.double().numpy()
    assert _rel(out, ref) < TOL[tier]
    if tier == "f32":
        pal = _np(eri_chunk_pallas(tier, ls, nprims, gj, omega), tier)
        assert _rel(out, pal) < TOL[tier]


@pytest.mark.parametrize("ls", [(2, 2, 2, 2), (3, 2, 1, 0), (4, 1, 2, 0)])
def test_eri_high_l_matches_jax(ls):
    """d/f/g classes (the fp64 tier) against the JAX XLA path at a small
    T: the classes the 0029/6-31g* path and the l<=4 kernel cover."""
    nprims, T = (1, 1, 1, 1), 8
    g = _geom(nprims, T, seed=sum(ls))
    ref = _np(jax_eri("df64", ls, nprims, _for_jax(g, "df64"), 0.0), "df64")
    out = contracted_eri_batch("fp64", ls, nprims, _for_port(g, "df64"))
    assert _rel(out.numpy(), ref) < TOL["df64"]


def test_eri_indexed_tables_equal_gathered():
    """The engine form (per-class tables + int32 row indices) gives the
    blocks of the gathered form bit for bit."""
    ls, nprims = (1, 0, 1, 0), (2, 1, 2, 1)
    rows, T = 6, 40
    g = _for_port(_geom(nprims, rows, seed=3), "df64")
    rng = np.random.default_rng(4)
    idx = torch.as_tensor(rng.integers(0, rows, (4, T)), dtype=torch.int32)
    got = contracted_eri_batch("fp64", ls, nprims, g, idx=tuple(idx))
    gathered = {f"{n}_{x}": g[f"{n}_{x}"][idx[k].long()]
                for k, x in enumerate("abcd")
                for n in ("coord", "exps", "coefs")}
    want = contracted_eri_batch("fp64", ls, nprims, gathered)
    assert torch.equal(got, want)
