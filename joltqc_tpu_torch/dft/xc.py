"""Exchange-correlation functionals in PyTorch with autograd potentials.

Port of ``joltqc_tpu/dft/xc.py``.  The energy densities e(rho, sigma, tau)
are the JAX package's formulas written as torch functions, and the
potentials (vrho, vsigma, vtau) come from ``torch.autograd.grad`` of their
sum, in float64, on the device the caller names (the RKS's device).  The
JAX package pins this step to the host CPU only because a TPU has no
float64; an H100 has it.

The floors rho >= 1e-14, sigma >= 1e-28, tau >= 1e-20 are
``torch.maximum``, whose gradient is the JAX one: zero below the floor
and split in half at an exact tie.  Points with rho <= 1e-14 return zero
in every output, as in the JAX package.

Families: lda (rho), gga (+sigma), mgga (+tau; no laplacian).
Range-separated hybrids carry (omega, alpha=LR-HF, hyb=SR-HF) with the
PySCF composition  K_eff = hyb*K + (alpha-hyb)*K_lr(omega).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda import resolve_device

# ------------------------------------------------------------- constants
_CX = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)  # Slater exchange constant
_CX_SPIN = 0.75 * (6.0 / np.pi) ** (1.0 / 3.0)  # per-spin variant
_CF = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0)  # Thomas-Fermi kinetic const
_CF_SPIN = 0.3 * (6.0 * np.pi**2) ** (2.0 / 3.0)  # per-spin (zeta=1)

_RHO_FLOOR = 1e-14
_SIGMA_FLOOR = 1e-28
_TAU_FLOOR = 1e-20


class XCInfo(NamedTuple):
    family: str  # 'lda' | 'gga' | 'mgga'
    comps: tuple  # ((coef, fn(rho, sigma, tau)), ...)
    hyb: float  # full-range HF fraction (SR fraction when omega > 0)
    alpha: float  # long-range HF fraction (== hyb when omega == 0)
    omega: float  # range-separation parameter (0 = none)
    nlc: tuple | None  # VV10 (b, C) or None


def _floor(x, v):
    """max(x, v) with the JAX gradient (zero below, half at a tie)."""
    return torch.maximum(x, torch.full_like(x, v))


def _cap(x, v):
    """min(x, v) with the JAX gradient."""
    return torch.minimum(x, torch.full_like(x, v))


def _rs(rho):
    return (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)


# ----------------------------------------------------------- LDA pieces
def _ex_slater(rho, sigma, tau):
    return -_CX * rho ** (4.0 / 3.0)


def _sr_factor(a):
    """Attenuated-Slater factor F(a), a = omega / (2 kF_sigma).

    The UEG exchange energy with the SHORT-range kernel erfc(w*r)/r is
    F(a) times the full-Coulomb value (Gill/Adamson attenuated-Slater).
    """
    a = _floor(a, 1e-12)
    # exact form; f64 cancellation grows as ~32 a^4/3 * eps, still < 1e-9
    # relative at the a=20 switch
    a_s = _cap(a, 20.0)
    exact = 1.0 - (8.0 / 3.0) * a_s * (
        np.sqrt(np.pi) * torch.erf(0.5 / a_s)
        - 3.0 * a_s
        + 4.0 * a_s**3
        + (2.0 * a_s - 4.0 * a_s**3) * torch.exp(-0.25 / (a_s * a_s))
    )
    # large-a asymptote (cancellation-free): F -> 1/(36 a^2) - 1/(960 a^4)
    a_l = _floor(a, 20.0)
    asym = 1.0 / (36.0 * a_l * a_l) - 1.0 / (960.0 * a_l**4)
    return torch.where(a <= 20.0, exact, asym)


def _ex_slater_sr(rho, omega):
    """Closed-shell SR (erfc-attenuated) Slater exchange energy density."""
    rho_s = rho / 2.0
    kf = (6.0 * np.pi**2 * rho_s) ** (1.0 / 3.0)
    return -_CX * rho ** (4.0 / 3.0) * _sr_factor(omega / (2.0 * kf))


def _vwn_eps(rho, A, b, c, x0):
    """VWN correlation energy per particle (paramagnetic channel)."""
    x = torch.sqrt(_rs(rho))
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = np.sqrt(4.0 * c - b * b)
    atn = torch.atan(Q / (2.0 * x + b))
    return A * (
        torch.log(x * x / X)
        + (2.0 * b / Q) * atn
        - (b * x0 / X0)
        * (torch.log((x - x0) ** 2 / X) + (2.0 * (b + 2.0 * x0) / Q) * atn)
    )


def _ec_vwn5(rho, sigma, tau):
    return rho * _vwn_eps(rho, 0.0310907, 3.72744, 12.9352, -0.10498)


def _ec_vwn3(rho, sigma, tau):
    # VWN III (RPA fit) -- the parametrization inside Gaussian-style B3LYP
    return rho * _vwn_eps(rho, 0.0310907, 13.0720, 42.7198, -0.409286)


def _pw92_g(rs, A, a1, b1, b2, b3, b4):
    srs = torch.sqrt(rs)
    den = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2.0 * A * (1.0 + a1 * rs) * torch.log1p(1.0 / den)


def _pw92_eps(rho):
    """PW92 correlation energy per particle, unpolarized (zeta = 0)."""
    return _pw92_g(_rs(rho), 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)


def _pw92_eps_pol(rho):
    """PW92 correlation energy per particle, fully polarized (zeta = 1)."""
    return _pw92_g(_rs(rho), 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)


def _ec_pw92(rho, sigma, tau):
    return rho * _pw92_eps(rho)


# ----------------------------------------------------------- GGA pieces
def _ex_pbe(rho, sigma, tau):
    kappa, mu = 0.804, 0.2195149727645171
    kf = (3.0 * np.pi**2 * rho) ** (1.0 / 3.0)
    s2 = sigma / (4.0 * kf**2 * rho**2)
    fx = 1.0 + kappa - kappa / (1.0 + mu * s2 / kappa)
    return _ex_slater(rho, sigma, tau) * fx


def _ec_pbe(rho, sigma, tau):
    gamma = (1.0 - np.log(2.0)) / np.pi**2
    beta = 0.06672455060314922
    eps = _pw92_eps(rho)
    kf = (3.0 * np.pi**2 * rho) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / np.pi)
    t2 = sigma / (2.0 * ks * rho) ** 2
    expo = torch.exp(-eps / gamma)
    A = (beta / gamma) / (expo - 1.0 + 1e-30)
    num = 1.0 + A * t2
    den = 1.0 + A * t2 + (A * t2) ** 2
    H = gamma * torch.log1p((beta / gamma) * t2 * num / den)
    return rho * (eps + H)


def _ex_b88_spin(rs_, ss_):
    """B88 exchange for ONE spin channel (rho_s, sigma_ss)."""
    beta = 0.0042
    r43 = rs_ ** (4.0 / 3.0)
    x = torch.sqrt(ss_) / r43
    return -_CX_SPIN * r43 - beta * r43 * x * x / (
        1.0 + 6.0 * beta * x * torch.asinh(x)
    )


def _ex_b88(rho, sigma, tau):
    # closed shell: both spins rho/2, sigma_ss = sigma/4
    return 2.0 * _ex_b88_spin(rho / 2.0, sigma / 4.0)


def _ec_lyp_spin(ra, rb, saa, sab, sbb):
    """LYP correlation, Johnson-Gill-Pople form (general spin)."""
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    rho = ra + rb
    r13 = rho ** (-1.0 / 3.0)
    denom = 1.0 + d * r13
    omega = torch.exp(-c * r13) * rho ** (-11.0 / 3.0) / denom
    delta = c * r13 + d * r13 / denom
    sig = saa + 2.0 * sab + sbb
    G = ra * rb * (
        2.0 ** (11.0 / 3.0) * _CF * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
        + (47.0 / 18.0 - 7.0 * delta / 18.0) * sig
        - (2.5 - delta / 18.0) * (saa + sbb)
        - ((delta - 11.0) / 9.0) * ((ra / rho) * saa + (rb / rho) * sbb)
    ) - (2.0 / 3.0) * rho**2 * sig + (
        (2.0 / 3.0) * rho**2 - ra**2
    ) * sbb + ((2.0 / 3.0) * rho**2 - rb**2) * saa
    return -4.0 * a * ra * rb / (rho * denom) - a * b * omega * G


def _ec_lyp(rho, sigma, tau):
    return _ec_lyp_spin(rho / 2.0, rho / 2.0, sigma / 4.0, sigma / 4.0, sigma / 4.0)


# ------------------------------------------------------- B97 machinery
def _b97_u(gamma, x2):
    gx = gamma * x2
    return gx / (1.0 + gx)


def _b97_w(rho_s, tau_s):
    """w = (t-1)/(t+1), t = tau_unif/tau (MN12/wB97M-V convention)."""
    t_unif = _CF_SPIN * rho_s ** (5.0 / 3.0)
    tau_s = _floor(tau_s, 1e-14)
    t = t_unif / tau_s
    return (t - 1.0) / (t + 1.0)


def _b97_series(coeffs, u, w=None):
    """Power series: GGA list [c0,c1,..] in u, or mGGA {(i,j): c} w^i u^j."""
    if isinstance(coeffs, dict):
        imax = max(i for i, _ in coeffs)
        jmax = max(j for _, j in coeffs)
        wp = [torch.ones_like(u)]
        for _ in range(imax):
            wp.append(wp[-1] * w)
        up = [torch.ones_like(u)]
        for _ in range(jmax):
            up.append(up[-1] * u)
        return sum(c * wp[i] * up[j] for (i, j), c in coeffs.items())
    g = torch.zeros_like(u)
    for c in reversed(coeffs):
        g = g * u + c
    return g


def _make_b97(data):
    """Build closed-shell B97-family component fns from an xc_data entry.

    Exchange: per-spin (SR-)LSDA exchange times series in u (+ w).
    Correlation: Stoll partition of PW92 -- same-spin e_ss uses the
    fully-polarized eps_c at rho_s, opposite-spin the remainder -- each
    times its own series (Becke 1997 construction).
    """
    from .xc_data import B97_GAMMA

    gx, gss, gos = B97_GAMMA
    omega = data["omega"]
    is_mgga = data["series"] == "mgga"

    def fx(rho, sigma, tau):
        rho_s = rho / 2.0
        x2 = (sigma / 4.0) / rho_s ** (8.0 / 3.0)
        u = _b97_u(gx, x2)
        w = _b97_w(rho_s, tau / 2.0) if is_mgga else None
        g = _b97_series(data["x"], u, w)
        e_lda = (
            _ex_slater_sr(rho, omega) if omega > 0 else _ex_slater(rho, sigma, tau)
        )
        return e_lda * g

    def fc(rho, sigma, tau):
        rho_s = rho / 2.0
        x2 = (sigma / 4.0) / rho_s ** (8.0 / 3.0)
        w = _b97_w(rho_s, tau / 2.0) if is_mgga else None
        # same-spin (x2_ss = per-spin x2; two identical channels)
        u_ss = _b97_u(gss, x2)
        e_ss_lda = rho_s * _pw92_eps_pol(rho_s)
        e_ss = 2.0 * e_ss_lda * _b97_series(data["css"], u_ss, w)
        # opposite-spin (x2_os = avg of the two spin x2 = x2 here)
        u_os = _b97_u(gos, x2)
        e_os_lda = rho * _pw92_eps(rho) - 2.0 * e_ss_lda
        e_os = e_os_lda * _b97_series(data["cos"], u_os, w)
        return e_ss + e_os

    return ((1.0, fx), (1.0, fc))


# --------------------------------------------------------- M06 machinery
_CF_VSXC = 0.6 * (6.0 * np.pi**2) ** (2.0 / 3.0)  # (3/5)(6 pi^2)^(2/3)


def _vsxc_h(d, x2, z, alpha):
    """VSXC-style h(x^2, z) rational (Van Voorhis & Scuseria 1998 eq 8)."""
    g = 1.0 + alpha * (x2 + z)
    return (
        d[0] / g
        + (d[1] * x2 + d[2] * z) / (g * g)
        + (d[3] * x2 * x2 + d[4] * x2 * z + d[5] * z * z) / (g * g * g)
    )


def _poly(coeffs, u):
    g = torch.zeros_like(u)
    for c in reversed(coeffs):
        g = g * u + c
    return g


def _make_m06(data):
    """Closed-shell M06-family component fns from an xc_data.M06 entry.

    Exchange: PBE energy density times the 12-term f(w) series plus the
    LSDA energy density times the VSXC h term.  Correlation: Stoll
    partition of PW92 (as in _make_b97) with per-channel [g(u) + h] and
    the same-spin self-interaction factor D_sigma."""
    from .xc_data import M06_ALPHA, M06_GAMMA

    ax, ass_, aos_ = M06_ALPHA
    gam_ss, gam_os = M06_GAMMA
    a = data["a"]

    def fx(rho, sigma, tau):
        rho_s = rho / 2.0
        tau_s = tau / 2.0
        x2 = (sigma / 4.0) / rho_s ** (8.0 / 3.0)
        z = 2.0 * tau_s / rho_s ** (5.0 / 3.0) - _CF_VSXC
        w = _b97_w(rho_s, tau_s)
        fw = _poly(a, w)
        e_pbe = _ex_pbe(rho, sigma, tau)  # closed-shell spin sum
        e_lsda = _ex_slater(rho, sigma, tau)
        return e_pbe * fw + e_lsda * _vsxc_h(data["dx"], x2, z, ax)

    def fc(rho, sigma, tau):
        rho_s = rho / 2.0
        tau_s = _floor(tau / 2.0, 1e-20)
        x2 = (sigma / 4.0) / rho_s ** (8.0 / 3.0)
        z = 2.0 * tau_s / rho_s ** (5.0 / 3.0) - _CF_VSXC
        # D_s = 1 - x2/(4 (z + C_F)); z + C_F = 2 tau_s/rho_s^(5/3) > 0;
        # clipped to [0, 1] as jnp.clip is: max, then min
        D = _cap(_floor(1.0 - x2 / (4.0 * (z + _CF_VSXC)), 0.0), 1.0)
        e_ss_lda = rho_s * _pw92_eps_pol(rho_s)  # one spin channel
        u_ss = _b97_u(gam_ss, x2)
        e_ss = (
            2.0
            * e_ss_lda
            * (_poly(data["css"], u_ss) + _vsxc_h(data["dss"], x2, z, ass_))
            * D
        )
        x2o, zo = 2.0 * x2, 2.0 * z
        u_os = _b97_u(gam_os, x2o)
        e_os_lda = rho * _pw92_eps(rho) - 2.0 * e_ss_lda
        e_os = e_os_lda * (
            _poly(data["cos"], u_os) + _vsxc_h(data["dos"], x2o, zo, aos_)
        )
        return e_ss + e_os

    return ((1.0, fx), (1.0, fc))


# --------------------------------------------------------------- registry
def _info(family, comps, hyb=0.0, alpha=None, omega=0.0, nlc=None):
    return XCInfo(family, tuple(comps), hyb, hyb if alpha is None else alpha, omega, nlc)


_COMPONENTS = {
    "slater": _info("lda", [(1.0, _ex_slater)]),
    "vwn": _info("lda", [(1.0, _ec_vwn5)]),
    "vwn5": _info("lda", [(1.0, _ec_vwn5)]),
    "vwn3": _info("lda", [(1.0, _ec_vwn3)]),
    "pw92": _info("lda", [(1.0, _ec_pw92)]),
    "pbe_x": _info("gga", [(1.0, _ex_pbe)]),
    "pbe_c": _info("gga", [(1.0, _ec_pbe)]),
    "b88": _info("gga", [(1.0, _ex_b88)]),
    "lyp": _info("gga", [(1.0, _ec_lyp)]),
}

_ALIASES = {
    "hf": _info("lda", [], hyb=1.0),
    "lda": _info("lda", [(1.0, _ex_slater), (1.0, _ec_vwn5)]),
    "svwn": _info("lda", [(1.0, _ex_slater), (1.0, _ec_vwn5)]),
    "lda,vwn": _info("lda", [(1.0, _ex_slater), (1.0, _ec_vwn5)]),
    "pbe": _info("gga", [(1.0, _ex_pbe), (1.0, _ec_pbe)]),
    "pbe,pbe": _info("gga", [(1.0, _ex_pbe), (1.0, _ec_pbe)]),
    "blyp": _info("gga", [(1.0, _ex_b88), (1.0, _ec_lyp)]),
    "pbe0": _info("gga", [(0.75, _ex_pbe), (1.0, _ec_pbe)], hyb=0.25),
    # B3LYP (libxc convention: VWN-RPA in the 0.19 LDA-correlation slot)
    "b3lyp": _info(
        "gga",
        [(0.08, _ex_slater), (0.72, _ex_b88), (0.19, _ec_vwn3), (0.81, _ec_lyp)],
        hyb=0.20,
    ),
    "b3lyp5": _info(
        "gga",
        [(0.08, _ex_slater), (0.72, _ex_b88), (0.19, _ec_vwn5), (0.81, _ec_lyp)],
        hyb=0.20,
    ),
}


def _install_b97():
    from .xc_data import FUNCTIONALS

    for name, data in FUNCTIONALS.items():
        _ALIASES[name] = XCInfo(
            data["family"],
            _make_b97(data),
            data["hyb"],
            data["alpha"],
            data["omega"],
            data["nlc"],
        )


_install_b97()


def _install_m06():
    from .xc_data import M06_FUNCTIONALS

    allow = os.environ.get("JQC_ALLOW_UNVERIFIED_XC", "0") not in (
        "0", "", "off",
    )
    for name, data in M06_FUNCTIONALS.items():
        if data.get("unverified") and not allow:
            continue  # anchor-gated (see xc_data.py provenance notes)
        _ALIASES[name] = XCInfo(
            "mgga", _make_m06(data), data["hyb"], data["hyb"], 0.0, None
        )


_install_m06()

_FAM_ORDER = {"lda": 0, "gga": 1, "mgga": 2}


def parse_xc(xc_code: str) -> XCInfo:
    """Return the XCInfo for a functional code ('name' or 'x_part,c_part');
    unknown names raise NotImplementedError."""
    key = xc_code.strip().lower()
    if key in _ALIASES:
        return _ALIASES[key]
    if key in _COMPONENTS:
        return _COMPONENTS[key]
    if "," in key:  # "x_part,c_part"
        xk, ck = (p.strip() for p in key.split(",", 1))
        fam, comps, hyb = "lda", [], 0.0
        for part in (xk, ck):
            if not part:
                continue
            info = parse_xc(part)
            if info.omega or info.nlc:
                raise NotImplementedError(
                    "RSH/NLC functionals cannot be combined with ','"
                )
            comps += list(info.comps)
            hyb += info.hyb
            if _FAM_ORDER[info.family] > _FAM_ORDER[fam]:
                fam = info.family
        return XCInfo(fam, tuple(comps), hyb, hyb, 0.0, None)
    raise NotImplementedError(f"XC functional '{xc_code}' not implemented")


def xc_family(xc_code: str) -> str:
    return parse_xc(xc_code).family


def is_gga(xc_code: str) -> bool:
    return parse_xc(xc_code).family == "gga"


def needs_tau(xc_code: str) -> bool:
    return parse_xc(xc_code).family == "mgga"


def hybrid_coeff(xc_code: str) -> float:
    return parse_xc(xc_code).hyb


def rsh_coeff(xc_code: str):
    """(omega, alpha, hyb): K_eff = hyb*K + (alpha-hyb)*K_lr(omega)."""
    info = parse_xc(xc_code)
    return info.omega, info.alpha, info.hyb


def nlc_coeff(xc_code: str):
    return parse_xc(xc_code).nlc


# ----------------------------------------------------------- evaluation
def _e_density(info, rho, sigma, tau):
    rho = _floor(rho, _RHO_FLOOR)
    sigma = _floor(sigma, _SIGMA_FLOOR)
    tau = _floor(tau, _TAU_FLOOR)
    return sum(c * f(rho, sigma, tau) for c, f in info.comps)


def _f64(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def eval_xc(xc_code: str, rho, sigma=None, tau=None, device=None):
    """Evaluate e_xc (per volume), vrho, vsigma, vtau at grid points.

    rho, sigma, tau: (N,) numpy arrays or tensors.  Runs in float64 on
    ``device`` (``cuda`` unless the caller names another) and returns
    numpy float64 arrays.  Points below the density floor contribute
    exactly zero.
    """
    info = parse_xc(xc_code)
    dev = resolve_device(device)
    rho = _f64(rho, dev)
    sigma = torch.zeros_like(rho) if sigma is None else _f64(sigma, dev)
    tau = torch.zeros_like(rho) if tau is None else _f64(tau, dev)
    if not info.comps:
        outs = [torch.zeros_like(rho) for _ in range(4)]
    else:
        args = [x.detach().requires_grad_(True) for x in (rho, sigma, tau)]
        with torch.enable_grad():
            e = _e_density(info, *args)
            grads = torch.autograd.grad(e.sum(), args, allow_unused=True)
        outs = [e.detach()] + [
            torch.zeros_like(rho) if g is None else g for g in grads
        ]
    mask = rho <= _RHO_FLOOR
    return tuple(
        torch.where(mask, 0.0, x).cpu().numpy() for x in outs
    )


__all__ = [
    "eval_xc",
    "parse_xc",
    "xc_family",
    "is_gga",
    "needs_tau",
    "hybrid_coeff",
    "rsh_coeff",
    "nlc_coeff",
    "XCInfo",
]
