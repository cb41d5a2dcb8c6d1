"""Port kernels against their plain versions on the card.

A CUDA kernel has no interpret mode: these tests need a card and skip
without one (decided inside the fixture, never at import).  Run them on
the card with ``python -m pytest tests/test_torch_gpu.py -q``;
``chip_smoke.py`` drives the same checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu_torch.ops.accum import (
    accum_block_chunk, block_accumulate, block_accumulate_plain, limbs_to_f64,
)
from joltqc_tpu_torch.ops.accum_tile import (
    _supertile, accum_tile_plain, fused_contract_tile, tile_accumulate,
    tile_accumulate_chunk, tile_accumulate_plain, tile_limbs_to_f64,
)
from joltqc_tpu_torch.ops.eri import eri_chunk
from joltqc_tpu_torch.ops.md import eri_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("tier,tol", [("f32", 2e-5), ("fp64", 1e-12)])
@pytest.mark.parametrize("ls,nprims", [
    ((0, 0, 0, 0), (3, 3, 3, 3)),
    ((1, 1, 1, 1), (1, 3, 1, 1)),
    ((2, 2, 2, 2), (1, 1, 1, 1)),
    ((4, 2, 1, 0), (1, 1, 1, 1)),
])
def test_eri_kernel_matches_plain(cuda, tier, tol, ls, nprims):
    dt = torch.float32 if tier == "f32" else torch.float64
    rng = np.random.default_rng(sum(ls))
    q = {}
    for x, npx in zip("abcd", nprims):
        q[f"coord_{x}"] = rng.standard_normal((256, 3))
        q[f"exps_{x}"] = rng.uniform(0.3, 3.0, (256, npx))
        q[f"coefs_{x}"] = rng.standard_normal((256, npx))
    q = {k: torch.as_tensor(v, dtype=dt, device=cuda) for k, v in q.items()}
    got = eri_chunk(tier, ls, nprims, q, 0.0)
    ref = eri_plain(ls, nprims, q, 0.0)
    assert float((got - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_accum_kernel_matches_plain_and_is_order_free(cuda, dt):
    rng = np.random.default_rng(3)
    T, W, nfxy, nfo = 4096, 64, 9, 9
    G = torch.as_tensor(rng.standard_normal((T, nfxy, nfo)), dtype=dt,
                        device=cuda)
    d = torch.as_tensor(rng.standard_normal((T, nfo)), dtype=dt, device=cuda)
    lx = torch.as_tensor(rng.integers(0, W, T), dtype=torch.int32,
                         device=cuda)
    ly = torch.as_tensor(rng.integers(0, W, T), dtype=torch.int32,
                         device=cuda)
    bound = float(G.abs().max() * d.abs().max() * nfo * 2)
    a, e = fused_contract_tile(G, d, lx, ly, W, W, bound)
    p, _ = _supertile(accum_tile_plain, G, d, lx, ly, W, W, bound)
    tol = 1e-13 if dt == torch.float64 else 1e-6
    err = (tile_limbs_to_f64(a, e) - tile_limbs_to_f64(p, e)).abs().max()
    assert float(err) < tol * bound
    perm = torch.randperm(T, device=cuda)
    b, _ = fused_contract_tile(G[perm].contiguous(), d[perm].contiguous(),
                               lx[perm], ly[perm], W, W, bound)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_tile_accumulate_kernel_matches_plain_and_is_order_free(cuda, dt):
    rng = np.random.default_rng(4)
    T, W, nf = 8192, 64, 36
    v = torch.as_tensor(rng.standard_normal((T, nf))
                        * np.exp(rng.uniform(-12, 0, (T, 1))), dtype=dt,
                        device=cuda)
    ix = torch.as_tensor(rng.integers(0, W, T), dtype=torch.int32, device=cuda)
    iy = torch.as_tensor(rng.integers(-1, W + 1, T), dtype=torch.int32,
                         device=cuda)  # some outside the tile: dropped
    bound = float(v.abs().max()) * 1.5
    n0 = tile_accumulate_chunk.launches
    a, e = tile_accumulate(v, ix, iy, W, W, bound)
    assert tile_accumulate_chunk.launches == n0 + 1
    p = tile_accumulate_plain(v, ix, iy, torch.zeros_like(a), e)
    tol = 1e-13 if dt == torch.float64 else 1e-6
    err = (tile_limbs_to_f64(a, e) - tile_limbs_to_f64(p, e)).abs().max()
    assert float(err) < tol * 2.0 ** e
    perm = torch.randperm(T, device=cuda)
    b, _ = tile_accumulate(v[perm], ix[perm], iy[perm], W, W, bound)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_block_accumulate_kernel_matches_plain_and_is_order_free(cuda, dt):
    rng = np.random.default_rng(5)
    T, nf, nrows = 16384, 9, 256
    v = torch.as_tensor(rng.standard_normal((T, nf))
                        * np.exp(rng.uniform(-20, 3, (T, nf))), dtype=dt,
                        device=cuda)
    key = torch.as_tensor(rng.integers(-1, nrows + 2, T), dtype=torch.int32,
                          device=cuda)  # some outside [0, nrows): dropped
    bound = float(v.abs().max()) * 2
    n0 = accum_block_chunk.launches
    a, e = block_accumulate(v, key, nrows, bound)
    assert accum_block_chunk.launches == n0 + 1
    p = block_accumulate_plain(v, key, torch.zeros_like(a), e)
    tol = 1e-13 if dt == torch.float64 else 1e-6
    err = (limbs_to_f64(a, e) - limbs_to_f64(p, e)).abs().max()
    assert float(err) < tol * 2.0 ** e
    perm = torch.randperm(T, device=cuda)
    b, _ = block_accumulate(v[perm], key[perm], nrows, bound)
    assert torch.equal(a, b)
