"""Port scaled modified spherical Bessel functions (ops/bessel.py::ine)
against the JAX package: ``ine_np`` (scipy, float64) at rtol 1e-12 for
l <= 8 (d shells, the G channel and two derivative shifts), at both
sides of the x = 40 switch between the series and the closed form, and
the JAX ``ine_df64`` itself on the same points."""

import numpy as np
import pytest
import torch

from joltqc_tpu.ops.bessel import ine_df64, ine_np
from joltqc_tpu.ops import df64 as df
from joltqc_tpu_torch.ops.bessel import ine
from joltqc_tpu_torch.ops.bessel import ine_np as port_ine_np

torch.set_num_threads(1)

LMAX = 8
POINTS = [0.0, 1e-8, 0.5, 39.99, 40.0, 40.01, 200.0]


@pytest.mark.parametrize("x", POINTS)
def test_ine_matches_scipy_oracle(x):
    got = ine(LMAX, torch.tensor([x], dtype=torch.float64)).numpy()[:, 0]
    ref = ine_np(LMAX, np.array([x]))[:, 0]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_ine_sweep_matches_scipy_oracle():
    """A seeded sweep over [0, 120] plus far-field points, in a 2-D
    tensor (the engine's (tasks, nodes) layout)."""
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(0.0, 120.0, 4000),
                        [0.0, 1e-3, 39.999999, 40.000001, 1e3, 5e4]])
    x = x.reshape(2, -1)
    got = ine(LMAX, torch.as_tensor(x)).numpy()
    ref = ine_np(LMAX, x)
    assert got.shape == (LMAX + 1,) + x.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_ine_matches_jax_ine_df64():
    """The JAX function this ports (x64 emulation on the CPU).  DF64 is
    a pair of float32 values, whose exponent range ends near 1e-38, so
    values below 1e-30 (x = 1e-8, l >= 4) are held in absolute terms."""
    x = np.array(POINTS)
    ref = np.stack([df.to_f64(v) for v in ine_df64(LMAX, df.from_f64(x))])
    got = ine(LMAX, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-30)


def test_ine_np_copy_is_the_jax_oracle():
    x = np.array(POINTS + [3.3, 77.0])
    assert np.array_equal(port_ine_np(LMAX, x), ine_np(LMAX, x))


@pytest.mark.parametrize("lmax", [0, 1, 4])
def test_ine_low_orders(lmax):
    """Each order count builds its own coefficient tables."""
    x = np.array([0.0, 0.2, 12.5, 41.0, 90.0])
    got = ine(lmax, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ine_np(lmax, x), rtol=1e-12, atol=0)
