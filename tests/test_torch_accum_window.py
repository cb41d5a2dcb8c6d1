"""What the shared-memory windows of kernels B and D rely on, on the CPU.

Kernel B (csrc/accum_tile.cu) sums one stream's tasks in a shared
window of 64 x 64 shells on 64-aligned shells, which holds a supertile of
the plan's order; kernel D (csrc/accum_block.cu) sums block rows in a
window of the rows just below the largest row seen, which slides up as
the keys grow.  Any task order is right for both, but only the plan's
order is fast: these tests hold the plans of H2O/6-31g (engines on the
CPU), and the plan entries of made-up classes wider than one window, to
that order.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.ops.accum import limbs_to_f64
from joltqc_tpu_torch.ops.accum_tile import _supertile, accum_tile_plain
from joltqc_tpu_torch.scf import JKEngine
from joltqc_tpu_torch.scf.jk_contracted import (
    STREAMS, block_entry, tile_entry,
)

torch.set_num_threads(1)

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""


@pytest.fixture(scope="module")
def h2o():
    mol = Molecule.from_atom_string(H2O, basis="6-31g")
    a = np.random.default_rng(0).uniform(-1, 1, (mol.nao, mol.nao))
    return mol, a + a.T


def _engine(mol, **kw):
    # all-fp64 routing: every screened task is in the plan
    return JKEngine(BasisLayout(mol), device="cpu", cutoff_fp32=1e-30,
                    cutoff_fp64=1e-30, **kw)


@pytest.mark.parametrize("W", [2, 3, 4])
def test_tile_entries_keep_each_stream_in_one_window(h2o, W):
    """Tasks come in non-decreasing supertile-key order, and over a run of
    one key every stream's (x div W, y div W) is constant: kernel B's
    window moves once per supertile.  Tasks on the pad shell (last class
    row) are the exception where W divides the shell count (the key
    clamps them onto the last tile); they add exact zeros, which the
    kernel drops without moving its window."""
    mol, dm = h2o
    eng = _engine(mol, tile_w=W)
    runs = 0
    for e in eng.build_plan(dm):
        assert e["accum"] == "tile"
        idx = e["idx"].astype(np.int64)
        ns = [eng.classes[k].nshell - 1 for k in e["cls_idx"]]  # real
        nt = [max(1, -(-n // W)) for n in ns]
        t4 = [np.minimum(i // W, n - 1) for i, n in zip(idx, nt)]
        key = ((t4[0] * nt[1] + t4[1]) * nt[2] + t4[2]) * nt[3] + t4[3]
        assert np.all(np.diff(key) >= 0)
        real = np.all([i < n for i, n in zip(idx, ns)], axis=0)
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        for a, b in zip(starts, np.r_[starts[1:], key.size]):
            m = real[a:b]
            for _, xi, yi, *_ in STREAMS:
                win = np.stack([idx[xi, a:b] // W, idx[yi, a:b] // W])[:, m]
                assert (win == win[:, :1]).all()
            runs += 1
    assert runs > len(eng._plan)  # several supertiles per entry


@pytest.mark.parametrize("S", [2, 4])
def test_block_entries_keep_rows_in_their_group(h2o, S):
    """Within a chunk of a block entry gslot never decreases, and the row
    key of every stream lies in [gslot*S^2, (gslot + 1)*S^2): the keys of
    a run of tasks fall at most S^2 - 1 rows below the largest seen, so
    kernel D's window (at least S^2 rows up to nf = 63 at S = 8) holds
    every row still to come of the groups it has reached."""
    mol, dm = h2o
    eng = _engine(mol, accum="block", tile=S)
    plan = eng.build_plan(dm)
    blocks = [e for e in plan if e["accum"] == "block"]
    assert blocks
    for e in blocks:
        B = e["chunk"]
        idx_all = eng._entry_dev(e)[0]
        gslot = e["gslot"].astype(np.int64)
        for s0 in range(0, e["ntasks"], B):
            g = gslot[s0:s0 + B]
            assert np.all(np.diff(g) >= 0) and g[0] == 0
            idx = tuple(idx_all[k, s0:s0 + B] for k in range(4))
            for xy in ("ab", "cd", "ac", "ad", "bc", "bd"):
                key, _ = eng._block_keys(e, s0, idx, xy)
                key = key.numpy().astype(np.int64)
                assert np.all(key >= g * S * S)
                assert np.all(key < (g + 1) * S * S)
                assert key.max() < e["nrows"]
                assert np.all(np.maximum.accumulate(key) - key < S * S)


def test_supertile_weights_scale_each_task():
    """``_supertile`` with task weights (the engine's symmetry weights,
    powers of two) against a float64 sum."""
    rng = np.random.default_rng(3)
    T, nfxy, nfo, W = 300, 4, 3, 8
    G = torch.as_tensor(rng.standard_normal((T, nfxy, nfo)))
    d = torch.as_tensor(rng.standard_normal((T, nfo)))
    lx = torch.as_tensor(rng.integers(0, W, T), dtype=torch.int32)
    ly = torch.as_tensor(rng.integers(0, W, T), dtype=torch.int32)
    w = torch.as_tensor(2.0 ** -rng.integers(0, 3, T), dtype=torch.float32)
    bound = float(G.abs().max() * d.abs().max()) * nfo
    limbs, e = _supertile(accum_tile_plain, G, d, lx, ly, W, W, bound, w=w)
    v = torch.einsum("tfo,to->tf", G, d) * w.double()[:, None]
    want = torch.zeros(W * W, nfxy, dtype=torch.float64).index_add_(
        0, (lx * W + ly).long(), v)
    got = limbs_to_f64(limbs, e).view(W * W, nfxy)
    assert (got - want).abs().max() < 1e-13 * bound


# made-up classes of 300, 200, 150 and 90 shells (the last one a pad
# shell, as in the engine's classes): several windows of 64 per center
NSHELL = (301, 201, 151, 91)


class _Class:
    def __init__(self, nshell):
        self.nshell = nshell


def _tasks(n=40_000):
    """random quadruples over the four classes"""
    rng = np.random.default_rng(11)
    idx = np.stack([rng.integers(0, k, n) for k in NSHELL]).astype(np.int32)
    return idx, rng.uniform(0.5, 2.0, n)


def _dense_tasks():
    """every quadruple of 300 x 12 x 4 x 3 shells, shuffled: dense tiles,
    as a screened plan has them"""
    g = np.stack(np.meshgrid(*map(np.arange, (300, 12, 4, 3)),
                             indexing="ij")).reshape(4, -1)
    rng = np.random.default_rng(12)
    g = g[:, rng.permutation(g.shape[1])].astype(np.int32)
    return g, rng.uniform(0.5, 2.0, g.shape[1])


@pytest.mark.parametrize("tile_w", [1, 2, 4, 8, 16, 32, 64])
def test_tile_entry_keeps_each_stream_in_one_64_window(tile_w):
    """A supertile of a power-of-two tile_w up to 64 nests in one of
    kernel B's 64-aligned windows: over a run of one supertile key, every
    stream's (x div 64, y div 64) is constant (pad-shell tasks aside:
    their key is clamped onto the last tile and they add exact zeros), so
    the window moves at most once per supertile."""
    classes = [_Class(n) for n in NSHELL]
    idx, w = _tasks()
    e = tile_entry(classes, tile_w, (0, 0, 0, 0), (1, 1, 1, 1), "fp64",
                   (0, 1, 2, 3), idx, w, 1.0)
    idx = e["idx"].astype(np.int64)
    assert sorted(map(tuple, idx.T)) == sorted(map(tuple, _tasks()[0].T))
    ns = [n - 1 for n in NSHELL]
    nt = [max(1, -(-n // tile_w)) for n in ns]
    t4 = [np.minimum(i // tile_w, n - 1) for i, n in zip(idx, nt)]
    key = ((t4[0] * nt[1] + t4[1]) * nt[2] + t4[2]) * nt[3] + t4[3]
    assert np.all(np.diff(key) >= 0)
    real = np.all([i < n for i, n in zip(idx, ns)], axis=0)
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    for _, xi, yi, *_ in STREAMS:
        win = (idx[xi] // 64) * 64 + idx[yi] // 64
        for a, b in zip(starts, np.r_[starts[1:], key.size]):
            wr = win[a:b][real[a:b]]
            assert (wr == wr[:1]).all()


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("B", [4096, 1 << 16])
def test_block_entry_rows_stay_near_the_top(S, B):
    """The block rows of a chunk, gslot*S*S + (jx % S)*S + jy % S for
    every output stream, lie in their group's S*S rows below nrows, with
    gslot from 0 and non-decreasing in the chunk and the group's tile
    base in ``tb4``: a row falls at most S*S - 1 rows below the largest
    row before it, inside kernel D's window."""
    classes = [_Class(n) for n in NSHELL]
    idx, w = _dense_tasks()
    e = block_entry(classes, S, B, (0, 0, 0, 0), (1, 1, 1, 1), "fp64",
                    (0, 1, 2, 3), idx, w, 1.0)
    assert e["accum"] == "block"
    idx, gslot = e["idx"].astype(np.int64), e["gslot"].astype(np.int64)
    for c0 in range(0, e["ntasks"], B):
        g = gslot[c0:c0 + B]
        assert g[0] == 0 and np.all(np.diff(g) >= 0)
        ix = idx[:, c0:c0 + B]
        assert np.array_equal(e["tb4"][c0 // B, g], ((ix // S) * S).T)
        for _, xi, yi, *_ in STREAMS:
            row = g * S * S + (ix[xi] % S) * S + ix[yi] % S
            assert np.all(row >= g * S * S) and np.all(row < (g + 1) * S * S)
            assert row.max() < e["nrows"]
            assert np.all(np.maximum.accumulate(row) - row < S * S)
