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
    accum_block_chunk, block_accumulate, block_accumulate_plain,
    bound_exponent, limbs_to_f64,
)
from joltqc_tpu_torch.ops.accum_tile import (
    _supertile, accum_tile_chunk, accum_tile_plain, fused_contract_tile,
    tile_accumulate, tile_accumulate_chunk, tile_accumulate_plain,
    tile_limbs_to_f64,
)
from joltqc_tpu_torch.ops.eri import ERI_CLASSES, eri_chunk
from joltqc_tpu_torch.ops.md import eri_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eri_case(cuda, tier, ls, nprims, omega):
    """Kernel A and its plain version on one random chunk of 256 tasks:
    (relative error, launches of the generic route)."""
    dt = torch.float32 if tier == "f32" else torch.float64
    rng = np.random.default_rng(sum(ls))
    q = {}
    for x, npx in zip("abcd", nprims):
        q[f"coord_{x}"] = rng.standard_normal((256, 3))
        q[f"exps_{x}"] = rng.uniform(0.3, 3.0, (256, npx))
        q[f"coefs_{x}"] = rng.standard_normal((256, npx))
    q = {k: torch.as_tensor(v, dtype=dt, device=cuda) for k, v in q.items()}
    g0 = eri_chunk.generic_launches
    got = eri_chunk(tier, ls, nprims, q, omega)
    ref = eri_plain(ls, nprims, q, omega)
    return (float((got - ref).abs().max() / ref.abs().max()),
            eri_chunk.generic_launches - g0)


# every specialised class at 6-31g*'s primitive counts (1 for d, 3
# below), the first cases of this test, and omega > 0
ERI_KERNEL_CASES = (
    [(ls, tuple(1 if l == 2 else 3 for l in ls), 0.0) for ls in ERI_CLASSES]
    + [((0, 0, 0, 0), (3, 3, 3, 3), 0.0), ((1, 1, 1, 1), (1, 3, 1, 1), 0.0),
       ((2, 2, 2, 2), (1, 1, 1, 1), 0.0), ((2, 1, 1, 0), (1, 3, 3, 3), 0.3),
       ((1, 1, 1, 0), (3, 3, 3, 3), 0.3)])


@pytest.mark.parametrize("tier,tol", [("f32", 2e-5), ("fp64", 1e-12)])
@pytest.mark.parametrize("ls,nprims,omega", ERI_KERNEL_CASES)
def test_eri_kernel_matches_plain(cuda, tier, tol, ls, nprims, omega):
    """The class kernels against the plain version; none of these
    launches takes the generic route."""
    err, generic = _eri_case(cuda, tier, ls, nprims, omega)
    assert err < tol
    assert generic == 0


@pytest.mark.parametrize("tier,tol", [("f32", 2e-5), ("fp64", 1e-12)])
@pytest.mark.parametrize("ls,nprims", [
    ((0, 1, 0, 0), (3, 1, 3, 3)),  # not canonical: lb > la
    ((3, 2, 1, 0), (1, 1, 1, 1)),
    ((4, 2, 1, 0), (1, 1, 1, 1)),
])
def test_eri_generic_route_matches_plain(cuda, tier, tol, ls, nprims):
    """A non-canonical l-tuple and l >= 3 take the generic kernel, and
    agree with the plain version."""
    err, generic = _eri_case(cuda, tier, ls, nprims, 0.0)
    assert err < tol
    assert generic == 1


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


def _runs(rng, T, hi, longest):
    """(T,) int32 runs of one value in [0, hi), lengths 1..longest"""
    lens = rng.integers(1, longest + 1, T)
    return np.repeat(rng.integers(0, hi, T), lens)[:T].astype(np.int32)


def _window_case(rng, case, W, T):
    """(lx, ly) of one window case: every task on one target, every
    target distinct, runs of one target, random order, random order
    sorted by 64 x 64 window."""
    if case == "one target":
        return np.full(T, 5, np.int32), np.full(T, 5, np.int32)
    if case == "distinct":
        g = rng.permutation(W * W).astype(np.int32)
        return g // W, g % W
    if case == "runs":
        return _runs(rng, T, W, 100), _runs(rng, T, W, 100)
    lx, ly = rng.integers(0, W, (2, T)).astype(np.int32)
    if case.startswith("sorted"):
        order = np.argsort((lx // 64) * 4 + ly // 64, kind="stable")
        lx, ly = lx[order], ly[order]
    return lx, ly


# kernel B's shared window (64 x 64 shells) under stress: (case, tile
# edge W); a 256 x 256 tile spans 16 windows
B_CASES = [("one target", 64), ("distinct", 64), ("runs", 64),
           ("random over 16 windows", 256), ("sorted by window", 256)]


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,W", [("tasks outside the tile", 64)] + B_CASES)
def test_tile_accumulate_kernel_matches_plain_and_is_order_free(cuda, dt,
                                                                case, W):
    """Kernel C against its plain version, bit for bit: tasks outside the
    tile (dropped) and the window cases of kernel B; a permuted launch
    gives the same bits."""
    rng = np.random.default_rng(4)
    T, nf = 8192, 36
    if case == "tasks outside the tile":
        ix = rng.integers(0, W, T).astype(np.int32)
        iy = rng.integers(-1, W + 1, T).astype(np.int32)
    else:
        ix, iy = _window_case(rng, case, W, T)
        T = ix.shape[0]
    v = torch.as_tensor(rng.standard_normal((T, nf))
                        * np.exp(rng.uniform(-12, 0, (T, 1))), dtype=dt,
                        device=cuda)
    ix = torch.as_tensor(ix, device=cuda)
    iy = torch.as_tensor(iy, device=cuda)
    bound = float(v.abs().max()) * 1.5
    n0 = tile_accumulate_chunk.launches
    a, e = tile_accumulate(v, ix, iy, W, W, bound)
    assert tile_accumulate_chunk.launches == n0 + 1
    p = tile_accumulate_plain(v, ix, iy, torch.zeros_like(a), e)
    assert torch.equal(a, p)
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


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,W", B_CASES)
def test_accum_kernel_window_cases(cuda, dt, case, W):
    """Kernel B against its plain version where its window is stressed:
    every task on one target, every target distinct, runs of one target,
    tasks in random order over many windows (the global route) and sorted
    by window; with symmetry weights.  A repeat and a permuted launch give
    the same bits."""
    rng = np.random.default_rng(6)
    nfxy, nfo = 6, 9
    lx, ly = _window_case(rng, case, W, 8192)
    T = lx.shape[0]
    G = torch.as_tensor(rng.standard_normal((T, nfxy, nfo)) * np.exp(
        rng.uniform(-10, 0, (T, 1, 1))), dtype=dt, device=cuda)
    d = torch.as_tensor(rng.standard_normal((T, nfo)), dtype=dt, device=cuda)
    w = torch.as_tensor(2.0 ** -rng.integers(0, 3, T), dtype=torch.float32,
                        device=cuda)
    lxt = torch.as_tensor(lx, device=cuda)
    lyt = torch.as_tensor(ly, device=cuda)
    bound = float(G.abs().max() * d.abs().max()) * nfo * 2

    def kernel(perm):
        args = [G, d, lxt, lyt, w]
        if perm is not None:
            args = [a[perm].contiguous() for a in args]
        return _supertile(accum_tile_chunk, *args[:4], W, W, bound,
                          w=args[4])

    a, e = kernel(None)
    p, _ = _supertile(accum_tile_plain, G, d, lxt, lyt, W, W, bound, w=w)
    tol = 1e-13 if dt == torch.float64 else 1e-6
    err = (tile_limbs_to_f64(a, e) - tile_limbs_to_f64(p, e)).abs().max()
    assert float(err) < tol * 2.0 ** e
    assert torch.equal(a, kernel(None)[0])
    assert torch.equal(a, kernel(torch.randperm(T, device=cuda))[0])


D_CASES = ["one row", "distinct rows", "random, keys outside",
           "engine order nf 3", "engine order nf 36", "one row nf 1"]


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", D_CASES)
def test_block_kernel_window_cases_bit_identical(cuda, dt, case):
    """Kernel D against its plain version, bit for bit, where its window
    is stressed: every task on one row, every row distinct, rows in
    random order with keys outside [0, nrows), and the engine's order
    (groups of 64 rows, gslot non-decreasing, runs of one row); a repeat
    and a permuted launch give the same bits."""
    rng = np.random.default_rng(7)
    if case.startswith("one row"):
        nf, nrows = (1, 8) if case.endswith("nf 1") else (3, 16)
        key = np.full(50_000, 3, np.int32)
    elif case == "distinct rows":
        nf, nrows = 3, 16_384
        key = rng.permutation(nrows).astype(np.int32)
    elif case == "random, keys outside":
        nf, nrows = 9, 4096
        key = rng.integers(-1, nrows + 2, 131_072).astype(np.int32)
    else:
        nf, nrows = int(case.split()[-1]), 512 * 64
        gs = np.sort(rng.integers(0, 512, 100_000 if nf == 3 else 30_000))
        key = (gs * 64 + _runs(rng, gs.shape[0], 64, 40)).astype(np.int32)
    T = key.shape[0]
    v = torch.as_tensor(rng.standard_normal((T, nf))
                        * np.exp(rng.uniform(-20, 3, (T, nf))), dtype=dt,
                        device=cuda)
    kt = torch.as_tensor(key, device=cuda)
    e = bound_exponent(float(v.abs().max()) * 2)
    acc = [torch.zeros((nrows, nf, 3), dtype=torch.int64, device=cuda)
           for _ in range(4)]
    accum_block_chunk(v, kt, acc[0], e)
    block_accumulate_plain(v, kt, acc[1], e)
    accum_block_chunk(v, kt, acc[2], e)
    perm = torch.randperm(T, device=cuda)
    accum_block_chunk(v[perm].contiguous(), kt[perm].contiguous(), acc[3], e)
    assert bool(acc[0].any())
    assert torch.equal(acc[0], acc[1])
    assert torch.equal(acc[0], acc[2]) and torch.equal(acc[0], acc[3])
