"""Port scatter, block and tile accumulation vs the JAX package.

The same values and indices, made with numpy from a seed, go through the
JAX functions (on the CPU with x64; the Pallas kernels in interpret mode)
and through the port's plain PyTorch versions (CPU tensors).  Both sides
sum exactly, so they agree to the decode's rounding; the bounds are those
of tests/test_accum.py and tests/test_accum_tile.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from joltqc_tpu.ops import df64 as df
from joltqc_tpu.ops.accum import block_accumulate as jax_block
from joltqc_tpu.ops.accum import scatter_add_det as jax_scatter
from joltqc_tpu.ops.accum_pallas import block_accumulate_pallas as jax_block_pl
from joltqc_tpu.ops.accum_tile import tile_accumulate as jax_tile
from joltqc_tpu.ops.accum_tile import tile_limbs_to_df64
from joltqc_tpu_torch.ops import accum_tile as port_tile
from joltqc_tpu_torch.ops.accum import (
    NLIMB, block_accumulate, limbs_to_f64, scatter_add_det,
    scatter_add_det_2d, scatter_limbs,
)
from joltqc_tpu_torch.ops.accum_tile import (
    tile_accumulate, tile_limbs_to_f64,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------- scatter
@pytest.mark.parametrize("tier", ["fp64", "f32"])
def test_scatter_add_det_matches_jax_and_oracle(tier):
    rng = np.random.default_rng(0)
    n, size = 20_000, 64
    vals = rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-8, 2, n)
    idx = rng.integers(0, size + 1, n).astype(np.int32)  # size: dropped
    if tier == "f32":
        vals = vals.astype(np.float32)
        vj, vt = jnp.asarray(vals), torch.as_tensor(vals)
        tol = 1e-6
    else:
        vj, vt = df.from_f64(vals), torch.as_tensor(vals)
        tol = 1e-13 * np.abs(vals).max()
    ref_j = np.asarray(df.to_f64(jax_scatter(vj, jnp.asarray(idx), size)))
    got = scatter_add_det(vt, torch.as_tensor(idx), size).numpy()
    ref = np.zeros(size + 1)
    np.add.at(ref, idx, vals.astype(np.float64))
    assert got.shape == (size,) and got.dtype == np.float64
    assert np.abs(got - ref[:size]).max() < tol
    assert np.abs(got - ref_j).max() < tol
    # a permuted input gives the same bits
    perm = rng.permutation(n)
    got_p = scatter_add_det(vt[perm], torch.as_tensor(idx[perm]), size)
    assert np.array_equal(got, got_p.numpy())


def test_scatter_limbs_static_bound_and_2d():
    """A static bound fixes the scale, so limb sums of two halves add as
    integers to the sums of the whole; idx == size is dropped."""
    rng = np.random.default_rng(1)
    n, shape = 4000, (5, 7)
    size = shape[0] * shape[1]
    vals = torch.as_tensor(rng.standard_normal(n))
    idx = torch.as_tensor(rng.integers(0, size + 1, n))
    whole, e = scatter_limbs(vals, idx, size, bound=8.0)
    a, ea = scatter_limbs(vals[: n // 2], idx[: n // 2], size, bound=8.0)
    b, eb = scatter_limbs(vals[n // 2:], idx[n // 2:], size, bound=8.0)
    assert e == ea == eb == 4
    assert whole.shape == (size, NLIMB) and whole.dtype == torch.int64
    assert torch.equal(whole, a + b)
    out2d = scatter_add_det_2d(vals, idx, shape)
    assert out2d.shape == shape
    keep = idx < size
    ref = np.zeros(size)
    np.add.at(ref, idx[keep].numpy(), vals[keep].numpy())
    assert np.abs(out2d.numpy().ravel() - ref).max() < 1e-13
    assert np.abs(limbs_to_f64(whole, e).numpy() - ref).max() < 1e-13


# ------------------------------------------------------------------ block
@pytest.mark.parametrize("T,nf,nrows,seed,spread", [
    (1024, 5, 16, 3, (-20, 3)),
    (256, 3, 32, 9, (-15, 2)),
])
@pytest.mark.parametrize("tier", ["fp64", "f32"])
def test_block_accumulate_matches_jax_xla_and_pallas(T, nf, nrows, seed,
                                                     spread, tier):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((T, nf)) * np.exp(rng.uniform(*spread, (T, nf)))
    keys = rng.integers(0, nrows + 2, T).astype(np.int32)  # incl. pad rows
    mx = np.float32(np.abs(vals).max() * 2)
    scale = np.abs(vals).max()
    if tier == "f32":
        vals = vals.astype(np.float32)
        vj, vt, tol = jnp.asarray(vals), torch.as_tensor(vals), 1e-9 * scale
    else:
        vj, vt, tol = df.from_f64(vals), torch.as_tensor(vals), 1e-13 * scale
    ref_x = np.asarray(df.to_f64(jax_block(vj, keys, nrows, mx)))
    ref_p = np.asarray(df.to_f64(jax_block_pl(vj, jnp.asarray(keys), nrows,
                                              mx)))
    limbs, e = block_accumulate(vt, torch.as_tensor(keys), nrows, float(mx))
    assert limbs.shape == (nrows, nf, NLIMB) and limbs.dtype == torch.int64
    got = limbs_to_f64(limbs, e).numpy()
    ref = np.zeros((nrows + 2, nf))
    np.add.at(ref, keys, vals.astype(np.float64))
    assert np.abs(got - ref[:nrows]).max() < tol
    assert np.abs(got - ref_x).max() < tol
    assert np.abs(got - ref_p).max() < tol
    perm = rng.permutation(T)
    limbs_p, _ = block_accumulate(vt[perm], torch.as_tensor(keys[perm]),
                                  nrows, float(mx))
    assert torch.equal(limbs, limbs_p)


def test_block_accumulate_shared_exponent_adds_as_integers():
    """``e=`` overrides the bound's exponent: blocks of two calls made at
    one exponent add as integers to the blocks of one call; negative keys
    are dropped like keys >= nrows."""
    rng = np.random.default_rng(4)
    T, nf, nrows = 512, 4, 8
    vals = torch.as_tensor(rng.standard_normal((T, nf)))
    keys = torch.as_tensor(rng.integers(-1, nrows + 1, T).astype(np.int32))
    whole, e = block_accumulate(vals, keys, nrows, 1.0, e=7)
    a, _ = block_accumulate(vals[:200], keys[:200], nrows, 100.0, e=7)
    b, _ = block_accumulate(vals[200:], keys[200:], nrows, 0.01, e=7)
    assert e == 7 and torch.equal(whole, a + b)
    keep = (keys >= 0) & (keys < nrows)
    ref = np.zeros((nrows, nf))
    np.add.at(ref, keys[keep].numpy(), vals[keep].numpy())
    assert np.abs(limbs_to_f64(whole, e).numpy() - ref).max() < 1e-13


# ------------------------------------------------------------------- tile
@pytest.mark.parametrize("tier,nf,Wx,Wy", [
    ("f32", 3, 64, 64),
    ("df64", 36, 64, 64),
    ("f32", 1, 8, 64),
])
def test_tile_accumulate_matches_jax(tier, nf, Wx, Wy):
    rng = np.random.default_rng(7)
    T = 1024
    vals64 = rng.standard_normal((T, nf)) * np.exp(rng.uniform(-12, 0, (T, 1)))
    ix = rng.integers(0, Wx, T).astype(np.int32)
    iy = rng.integers(0, Wy, T).astype(np.int32)
    bound = float(np.float32(np.abs(vals64).max() * 1.5))
    if tier == "df64":
        vj, vt = df.from_f64(vals64), torch.as_tensor(vals64)
    else:
        v32 = vals64.astype(np.float32)
        vj, vt = jnp.asarray(v32), torch.as_tensor(v32)
        vals64 = v32.astype(np.float64)  # oracle on the rounded f32
    limbs_j, sexp = jax.jit(
        lambda v, i, j: jax_tile(v, i, j, Wx, Wy, jnp.float32(bound))
    )(vj, jnp.asarray(ix), jnp.asarray(iy))
    ref_j = np.asarray(df.to_f64(
        tile_limbs_to_df64(limbs_j.astype(jnp.int32), sexp)))
    limbs, e = tile_accumulate(vt, torch.as_tensor(ix), torch.as_tensor(iy),
                               Wx, Wy, bound)
    assert limbs.shape == (Wx, Wy, nf, NLIMB) and limbs.dtype == torch.int64
    got = tile_limbs_to_f64(limbs, e).numpy()
    want = np.zeros((Wx, Wy, nf))
    np.add.at(want, (ix, iy), vals64)
    tol = (1e-15 * np.abs(vals64).max() if tier == "df64" else 1e-13) * T
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got, ref_j, atol=tol)
    perm = rng.permutation(T)
    limbs_p, _ = tile_accumulate(vt[perm], torch.as_tensor(ix[perm]),
                                 torch.as_tensor(iy[perm]), Wx, Wy, bound)
    assert torch.equal(limbs, limbs_p)


def test_tile_accumulate_two_chunks_sum_as_integers():
    """Two chunks accumulated as integer limb tiles match one dense pass
    (tests/test_accum_tile.py's cross-chunk carry)."""
    rng = np.random.default_rng(3)
    T, nf, W = 512, 3, 64
    vals = rng.standard_normal((2, T, nf))
    ix = rng.integers(0, W, (2, T)).astype(np.int32)
    iy = rng.integers(0, W, (2, T)).astype(np.int32)
    carry = torch.zeros((W, W, nf, NLIMB), dtype=torch.int64)
    for c in range(2):
        limbs, e = tile_accumulate(torch.as_tensor(vals[c]),
                                   torch.as_tensor(ix[c]),
                                   torch.as_tensor(iy[c]), W, W, 3.0)
        carry += limbs
    one, e1 = tile_accumulate(torch.as_tensor(vals.reshape(-1, nf)),
                              torch.as_tensor(ix.reshape(-1)),
                              torch.as_tensor(iy.reshape(-1)), W, W, 3.0)
    assert e == e1 and torch.equal(carry, one)
    want = np.zeros((W, W, nf))
    np.add.at(want, (ix.reshape(-1), iy.reshape(-1)), vals.reshape(-1, nf))
    np.testing.assert_allclose(tile_limbs_to_f64(carry, e).numpy(), want,
                               atol=1e-12)


def test_tile_accumulate_drops_tasks_outside_the_tile():
    vals = torch.ones((4, 2), dtype=torch.float64)
    ix = torch.tensor([0, 1, 8, -1], dtype=torch.int32)
    iy = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    limbs, e = tile_accumulate(vals, ix, iy, 8, 8, 2.0)
    got = tile_limbs_to_f64(limbs, e)
    assert float(got.sum()) == 4.0 and float(got[0, 0, 0]) == 1.0


def test_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only; the dispatchers pick the
    plain version for a CPU tensor and nothing else."""
    v = torch.ones((4, 2), dtype=torch.float64)
    k = torch.zeros(4, dtype=torch.int32)
    from joltqc_tpu_torch.ops.accum import accum_block_chunk

    with pytest.raises(ValueError, match="needs CUDA tensors"):
        accum_block_chunk(v, k, torch.zeros((2, 2, 3), dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        port_tile.tile_accumulate_chunk(
            v, k, k, torch.zeros((2, 2, 2, 3), dtype=torch.int64), 1)
    assert accum_block_chunk.launches == 0
    assert port_tile.tile_accumulate_chunk.launches == 0
