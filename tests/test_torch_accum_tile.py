"""Port fused contract + tile accumulation vs the JAX package.

The port's ``fused_contract_tile`` (plain PyTorch version on the CPU)
is decoded with ``tile_limbs_to_f64`` and held against JAX's
``fused_contract_tile`` (Pallas, interpret mode on the CPU) decoded with
``tile_limbs_to_df64``, at T=128 and W=8, in both tiers.  Tolerances are
those of tests/test_accum_tile.py: the contraction rounds per operation
in the tier's type, so the bound scales with max|G| max|d| nfo T.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from joltqc_tpu.ops import df64 as df
from joltqc_tpu.ops.accum_tile import dm_rows_t
from joltqc_tpu.ops.accum_tile import fused_contract_tile as jax_fct
from joltqc_tpu.ops.accum_tile import tile_limbs_to_df64
from joltqc_tpu_torch.ops.accum_tile import (
    NLIMB, fused_contract_tile, tile_limbs_to_f64,
)

torch.set_num_threads(1)

T, W = 128, 8


def _inputs(nfxy, nfo, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((T, nfxy, nfo)) * np.exp(
        rng.uniform(-8, 0, (T, 1, 1)))
    d = rng.standard_normal((T, nfo))
    lx = rng.integers(0, W, T).astype(np.int32)
    ly = rng.integers(0, W, T).astype(np.int32)
    bound = float(np.float32(np.abs(G).max() * np.abs(d).max() * nfo * 2))
    return G, d, lx, ly, bound


def _port(G, d, lx, ly, bound, dt):
    limbs, e = fused_contract_tile(
        torch.as_tensor(G, dtype=dt), torch.as_tensor(d, dtype=dt),
        torch.as_tensor(lx), torch.as_tensor(ly), W, W, bound)
    return limbs, e


@pytest.mark.parametrize("tier,nfxy,nfo", [
    ("f32", 3, 3),
    ("f32", 9, 9),
    ("df64", 3, 1),
    ("df64", 9, 4),
])
def test_fused_contract_tile_matches_jax(tier, nfxy, nfo):
    G, d, lx, ly, bound = _inputs(nfxy, nfo, seed=5 + nfxy + nfo)
    if tier == "df64":
        Gj, dj, dt = df.from_f64(G), df.from_f64(d), torch.float64
    else:
        G = G.astype(np.float32).astype(np.float64)
        d = d.astype(np.float32).astype(np.float64)
        Gj, dj, dt = jnp.asarray(G, jnp.float32), jnp.asarray(d, jnp.float32), torch.float32
    limbs_j, sexp = jax.jit(
        lambda g, dd, a, b: jax_fct(g, dm_rows_t(dd, nfo), a, b, W, W,
                                    jnp.float32(bound))
    )(Gj, dj, jnp.asarray(lx), jnp.asarray(ly))
    ref = np.asarray(df.to_f64(
        tile_limbs_to_df64(limbs_j.astype(jnp.int32), sexp)))

    limbs, e = _port(G, d, lx, ly, bound, dt)
    assert limbs.shape == (W, W, nfxy, NLIMB) and limbs.dtype == torch.int64
    got = tile_limbs_to_f64(limbs, e).numpy()

    vals = np.einsum("tao,to->ta", G, d)
    want = np.zeros((W, W, nfxy))
    np.add.at(want, (lx, ly), vals)
    scale = np.abs(G).max() * np.abs(d).max() * nfo * T
    tol = (1e-14 if tier == "df64" else 2e-7) * scale
    np.testing.assert_allclose(got, ref, atol=tol)
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_fused_contract_tile_order_independent(dt):
    """Integer limb sums: task order does not change a single bit."""
    G, d, lx, ly, bound = _inputs(6, 9, seed=11)
    perm = np.random.default_rng(12).permutation(T)
    a, e = _port(G, d, lx, ly, bound, dt)
    b, _ = _port(G[perm], d[perm], lx[perm], ly[perm], bound, dt)
    assert torch.equal(a, b)


def test_limbs_exact_below_bound():
    """The three 40-bit limbs keep 120 bits below the static bound: a
    decoded single contribution equals the fp64 value to its last bit."""
    G, d, lx, ly, bound = _inputs(4, 4, seed=13)
    lx[:] = np.arange(T) % W
    ly[:] = (np.arange(T) // W) % W
    limbs, e = _port(G[:64], d[:64], lx[:64], ly[:64], bound, torch.float64)
    got = tile_limbs_to_f64(limbs, e).numpy()
    want = np.zeros((W, W, 4))
    vals = (torch.as_tensor(G[:64]) * torch.as_tensor(d[:64])[:, None, :]
            ).sum(-1).numpy()
    want[lx[:64], ly[:64]] = vals
    assert np.array_equal(got, want)
