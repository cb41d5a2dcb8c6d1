"""Port XC functionals against the JAX package.

The same seeded points (rho log-uniform on 1e-12..1e2, with points on and
below the floors of rho, sigma and tau) go through ``joltqc_tpu`` and
``joltqc_tpu_torch`` ``eval_xc``; e, vrho, vsigma and vtau must agree to
rtol 1e-10, atol 1e-14, plus four ulps of the largest terms the
reference sums for that output.  A point may exceed the table's bound
only where that resolution term is the larger of the two, which happens
at two kinds of points:

 - PBE's vsigma at small reduced gradient and at the sigma floor, where
   exchange and correlation cancel (mu = beta pi^2 / 3 exactly): the
   result is the residue of terms of size ~1e2, a few ulps of which
   exceed 1e-14;
 - range-separated exchange at a = omega / (2 kF_sigma) > 1, where the
   reference's closed form of the attenuation factor F(a)
   (``joltqc_tpu/dft/xc.py::_sr_factor``) subtracts terms of size
   (32/3) a^4 to leave F ~ 1/(36 a^2): a relative rounding of about
   384 a^6 ulp in F, 3e-6 at its a = 20 switch.  The port keeps the
   formula, so the two agree only to that resolution there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from joltqc_tpu.dft import xc as jxc
from joltqc_tpu_torch.dft import xc as txc

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the synthetic meta-GGA of tests/test_xc_b97.py
_B97M_TEST = dict(
    family="mgga",
    series="mgga",
    x={(0, 0): 0.85, (1, 0): 1.0, (0, 1): 0.25},
    css={(0, 0): 0.44, (1, 0): -1.4, (0, 2): -4.5},
    cos={(0, 0): 1.0, (1, 0): 1.35, (2, 1): -8.8},
    hyb=0.15,
    alpha=1.0,
    omega=0.3,
    nlc=(6.0, 0.01),
)


@pytest.fixture(autouse=True)
def _register_b97m_test():
    for mod in (jxc, txc):
        mod._ALIASES["b97m-test"] = mod.XCInfo(
            "mgga", mod._make_b97(_B97M_TEST), 0.15, 1.0, 0.3, (6.0, 0.01))
    yield
    for mod in (jxc, txc):
        mod._ALIASES.pop("b97m-test", None)


def _points(n=4096, seed=11):
    rng = np.random.default_rng(seed)
    rho = 10.0 ** rng.uniform(-12, 2, n)
    sigma = rho ** (8.0 / 3.0) * 10.0 ** rng.uniform(-3, 2, n)
    tau = rho ** (5.0 / 3.0) * 10.0 ** rng.uniform(-1, 1.5, n)
    # on and below each floor (rho 1e-14, sigma 1e-28, tau 1e-20)
    rho[:4] = [1e-14, 0.5e-14, 1e-14, 1e-15]
    sigma[4:8] = [1e-28, 0.3e-28, 1e-28, 0.0]
    tau[8:12] = [1e-20, 0.2e-20, 1e-20, 0.0]
    return rho, sigma, tau


def _resolution(xc, rho, sigma, tau):
    """Per output: the sum over the functional's components of |the
    component's value|, the SR exchange's scaled by its cancellation
    384 a^6 where a > 1 (the largest terms the reference sums)."""
    info = txc.parse_xc(xc)
    total = [np.zeros_like(rho) for _ in range(4)]
    kf = (3.0 * np.pi**2 * np.maximum(rho, 1e-14)) ** (1.0 / 3.0)
    a = info.omega / (2.0 * kf)
    for k, (c, f) in enumerate(info.comps):
        txc._ALIASES["_component"] = txc.XCInfo(info.family, ((c, f),),
                                               0.0, 0.0, 0.0, None)
        try:
            outs = txc.eval_xc("_component", rho, sigma, tau, device="cpu")
        finally:
            txc._ALIASES.pop("_component")
        sr = info.omega > 0 and f.__name__ == "fx"
        amp = np.where(a > 1.0, 384.0 * a**6, 1.0) if sr else 1.0
        for q in range(4):
            total[q] += np.abs(outs[q]) * amp
    return total


@pytest.mark.parametrize(
    "xc", ["lda,vwn", "pbe", "b3lyp", "b97", "wb97x-v", "b97m-test"])
def test_eval_xc_matches_jax(xc):
    rho, sigma, tau = _points()
    ref = jxc.eval_xc(xc, rho, sigma, tau)
    got = txc.eval_xc(xc, rho, sigma, tau, device="cpu")
    res = _resolution(xc, rho, sigma, tau)
    for name, g, r, s in zip(("e", "vrho", "vsigma", "vtau"), got, ref, res):
        assert g.dtype == np.float64 and g.shape == r.shape
        strict = 1e-14 + 1e-10 * np.abs(r)
        d = np.abs(g - r)
        bad = d > strict + 4.0 * EPS * s
        assert not bad.any(), (name, np.nonzero(bad)[0][:5], d[bad][:5])
        # past the table's bound only where the reference's own rounding
        # is coarser than that bound
        odd = (d > strict) & (4.0 * EPS * s <= strict)
        assert not odd.any(), (name, np.nonzero(odd)[0][:5], d[odd][:5])
    # below the rho floor every output is exactly zero, as in the JAX
    # package; at a sigma or tau floor the gradient is halved there too
    for g in got:
        assert np.all(g[[0, 1, 2, 3]] == 0.0)


def test_floor_gradients():
    """At an exact floor tie the gradient is half the one above it, and
    zero below the floor (jnp.maximum's gradient, kept)."""
    rho = np.full(3, 0.3)
    sig = np.array([1e-28, 0.5e-28, 1e-28 * (1 + 2e-15)])
    _, _, vs, _ = txc.eval_xc("b88", rho, sig, device="cpu")
    _, _, vs_ref, _ = jxc.eval_xc("b88", rho, sig)
    assert vs[1] == 0.0 and vs[0] == pytest.approx(0.5 * vs[2], rel=1e-9)
    np.testing.assert_allclose(vs, vs_ref, rtol=1e-10, atol=1e-14)


def test_registry_matches_jax():
    """parse_xc / rsh_coeff / nlc_coeff / families for every registered
    name and the comma compositions: equal coefficients."""
    names = sorted(set(jxc._ALIASES) | set(jxc._COMPONENTS))
    assert names == sorted(set(txc._ALIASES) | set(txc._COMPONENTS))
    names += ["b88,lyp", "slater,vwn3", "pbe_x,pbe_c", "b88,", ",lyp"]
    for name in names:
        j, t = jxc.parse_xc(name), txc.parse_xc(name)
        assert (t.family, t.hyb, t.alpha, t.omega, t.nlc) == (
            j.family, j.hyb, j.alpha, j.omega, j.nlc), name
        assert [c for c, _ in t.comps] == [c for c, _ in j.comps], name
        assert [f.__name__ for _, f in t.comps] == [
            f.__name__ for _, f in j.comps], name
        assert txc.rsh_coeff(name) == jxc.rsh_coeff(name)
        assert txc.nlc_coeff(name) == jxc.nlc_coeff(name)
        assert txc.hybrid_coeff(name) == jxc.hybrid_coeff(name)
        assert (txc.xc_family(name), txc.is_gga(name), txc.needs_tau(name)) \
            == (jxc.xc_family(name), jxc.is_gga(name), jxc.needs_tau(name))
    for bad in ("wb97m-v", "m06", "nonsense", "wb97x-v,lyp"):
        for mod in (jxc, txc):
            with pytest.raises(NotImplementedError):
                mod.parse_xc(bad)


def test_unverified_gate_matches_jax():
    """JQC_ALLOW_UNVERIFIED_XC=1 registers the same M06 family in both
    packages, and their values agree on well-conditioned points."""
    code = (
        "import numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "from joltqc_tpu.dft import xc as j\n"
        "from joltqc_tpu_torch.dft import xc as t\n"
        "names = sorted(set(j._ALIASES) - {'b97m-test'})\n"
        "assert names == sorted(t._ALIASES), (names, sorted(t._ALIASES))\n"
        "assert 'm06' in names\n"
        "rng = np.random.default_rng(1)\n"
        "r = 10 ** rng.uniform(-3, 1, 256)\n"
        "s = r ** (8 / 3) * 10 ** rng.uniform(-2, 1, 256)\n"
        "u = r ** (5 / 3) * 10 ** rng.uniform(0, 1, 256)\n"
        "for a, b in zip(j.eval_xc('m06', r, s, u),\n"
        "                t.eval_xc('m06', r, s, u, device='cpu')):\n"
        "    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-14)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JQC_ALLOW_UNVERIFIED_XC="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_eval_xc_needs_a_device():
    """No card and no device: eval_xc raises (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txc.eval_xc("pbe", np.ones(4), np.ones(4))
