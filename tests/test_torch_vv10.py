"""Port VV10 against the JAX package, the float64 numpy oracle, and plain
torch autograd of the naive double sum.

The cloud of tests/test_vv10.py (512 points, blocks of 128).  Energies in
float32 agree with the JAX package's and the oracle's to rel 1e-5
(tests/test_vv10.py:29); the blocked custom backward of the pair sum
agrees with autograd of the unblocked sum to rtol 1e-10 in float64.
"""

import numpy as np
import pytest
import torch

from joltqc_tpu.dft import vv10 as jvv10
from joltqc_tpu_torch.dft import vv10 as tvv10

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    N = 512
    return (
        rng.uniform(-3, 3, (N, 3)),
        rng.uniform(0.001, 0.01, N),
        rng.uniform(1e-4, 2.0, N),
        rng.uniform(1e-6, 5.0, N),
    )


def test_energy_matches_jax_and_oracle(cloud):
    coords, w, rho, sigma = cloud
    e, vr, vs = tvv10.nlc_exc_vxc(coords, w, rho, sigma, block=128,
                                  device="cpu")
    e_jax, vr_jax, vs_jax = jvv10.nlc_exc_vxc(coords, w, rho, sigma,
                                              block=128)
    e_ref = tvv10.nlc_exc_vxc_np(coords, w, rho, sigma)
    assert e_ref == jvv10.nlc_exc_vxc_np(coords, w, rho, sigma)
    assert abs(e - e_jax) / abs(e_jax) < 1e-5
    assert abs(e - e_ref) / abs(e_ref) < 1e-5
    # float32 potentials on both sides
    for got, ref in ((vr, vr_jax), (vs, vs_jax)):
        assert got.dtype == np.float64 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_potential_fd(cloud):
    """dE/drho_i = w_i vr_i and dE/dsigma_i = w_i vs_i against central
    differences of the float64 oracle (tests/test_vv10.py bounds)."""
    coords, w, rho, sigma = cloud
    _, vr, vs = tvv10.nlc_exc_vxc(coords, w, rho, sigma, block=128,
                                  device="cpu")
    h = 1e-4
    for i in (7, 100):
        for arr, v in ((rho, vr), (sigma, vs)):
            p, m = arr.copy(), arr.copy()
            p[i] += h
            m[i] -= h
            args_p = (p, sigma) if arr is rho else (rho, p)
            args_m = (m, sigma) if arr is rho else (rho, m)
            fd = (tvv10.nlc_exc_vxc_np(coords, w, *args_p)
                  - tvv10.nlc_exc_vxc_np(coords, w, *args_m)) / (2 * h)
            np.testing.assert_allclose(w[i] * v[i], fd, rtol=2e-4)


def test_threshold_masks_tiny_rho(cloud):
    coords, w, rho, sigma = cloud
    rho2 = rho.copy()
    rho2[::2] = 1e-12  # below threshold: these points must drop out
    e, vr, vs = tvv10.nlc_exc_vxc(coords, w, rho2, sigma, block=128,
                                  device="cpu")
    e_ref = tvv10.nlc_exc_vxc_np(coords, w, rho2, sigma)
    assert abs(e - e_ref) / abs(e_ref) < 1e-5
    assert np.all(vr[::2] == 0) and np.all(vs[::2] == 0)


def _naive_pair_sum(omega0, kappa, wr, coords):
    R2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    gi = omega0[:, None] * R2 + kappa[:, None]
    gj = omega0[None, :] * R2 + kappa[None, :]
    phi = -1.5 / (gi * gj * (gi + gj))
    return wr @ phi @ wr


@pytest.mark.parametrize("block", [64, 100, 512])
def test_custom_backward_matches_autograd(cloud, block):
    """The pair sum's blocked forward and recomputing backward against
    autograd of the unblocked float64 sum (block 100 leaves a ragged last
    block)."""
    coords, w, rho, sigma = cloud
    rng = np.random.default_rng(1)
    f64 = dict(dtype=torch.float64)
    c = torch.tensor(coords, **f64)
    ins = [torch.tensor(rng.uniform(0.2, 2.0, len(w)), **f64),
           torch.tensor(rng.uniform(0.5, 3.0, len(w)), **f64),
           torch.tensor(w * rho, **f64)]
    a = [x.clone().requires_grad_(True) for x in ins]
    b = [x.clone().requires_grad_(True) for x in ins]
    p1 = tvv10._PairSum.apply(a[0], a[1], a[2], c, block)
    p2 = _naive_pair_sum(b[0], b[1], b[2], c)
    g1 = torch.autograd.grad(p1, a)
    g2 = torch.autograd.grad(p2, b)
    assert torch.allclose(p1, p2, rtol=1e-12, atol=0)
    for x, y in zip(g1, g2):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=0)


def test_energy_gradient_matches_naive_autograd(cloud):
    """rho/sigma gradients of the whole VV10 energy, float64, against
    autograd of the JAX package's formula written as one dense sum."""
    coords, w, rho, sigma = cloud
    b_, C = 5.9, 0.0093
    f64 = dict(dtype=torch.float64)
    mask = torch.tensor((rho > 1e-8) & (w != 0))
    c, wt = torch.tensor(coords, **f64), torch.tensor(w, **f64)
    r1 = torch.tensor(rho, **f64, requires_grad=True)
    s1 = torch.tensor(sigma, **f64, requires_grad=True)
    e1 = tvv10._vv10_energy(r1, s1, c, wt, mask, b_, C, 128)
    g1 = torch.autograd.grad(e1, (r1, s1))

    r2 = torch.tensor(rho, **f64, requires_grad=True)
    s2 = torch.tensor(sigma, **f64, requires_grad=True)
    beta = (1.0 / 32.0) * (3.0 / (b_ * b_)) ** 0.75
    omega0 = torch.sqrt(C * (s2 / r2**2) ** 2 + (4.0 * np.pi / 3.0) * r2)
    kappa = b_ * 1.5 * np.pi * (r2 / (9.0 * np.pi)) ** (1.0 / 6.0)
    wr = wt * r2
    e2 = beta * wr.sum() + 0.5 * _naive_pair_sum(omega0, kappa, wr, c)
    g2 = torch.autograd.grad(e2, (r2, s2))
    assert torch.allclose(e1, e2, rtol=1e-12, atol=0)
    for x, y in zip(g1, g2):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-300)
