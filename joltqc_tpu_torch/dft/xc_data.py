"""Parameter tables for B97-family (incl. range-separated / meta-GGA) XC.

Copy of ``joltqc_tpu/dft/xc_data.py`` (data only).

The reference evaluates these functionals through libxc (GPU4PySCF
``ni.eval_xc_eff``, JoltQC jqc/pyscf/rks.py:341).  No libxc is
available in this environment, so the functionals are implemented from
their defining papers; this module isolates the *data* so it can be
audited/corrected independently of the machinery (dft/xc.py).

Conventions:
 - ``x``  : inhomogeneity coefficients for the exchange series
 - ``css``: same-spin correlation series
 - ``cos``: opposite-spin correlation series
 - GGA series (B97, wB97X-V): list [c0, c1, c2, ...] in powers of
   u = gamma*x^2/(1+gamma*x^2)
 - mGGA series (wB97M-V): dict {(i, j): c} for  c * w^i * u^j  with
   w = (t-1)/(t+1), t = tau_unif/tau
 - ``gamma``: (gamma_x, gamma_ss, gamma_os); B97-standard
   (0.004, 0.2, 0.006) for every member.

Provenance / verification status:
 - B97:      Becke, J. Chem. Phys. 107, 8554 (1997), Table II.  VERIFIED
             by the UEG-limit identities in tests/test_xc_b97.py.
 - wB97X-V:  Mardirossian & Head-Gordon, PCCP 16, 9904 (2014), Table 3.
             10-parameter form: 3 exchange + 2 css + 2 cos (+ cx_sr,
             omega, VV10 b, C).
 - wB97M-V:  REMOVED.  A from-memory reconstruction of the JCP 144,
             214110 (2016) Table 3 data was tested against the published
             H2O/def2-tzvpp SCF anchor -76.4334218842 (ref
             test_dft.py:105) with the full self-consistent pipeline
             (the B3LYP control on the same pipeline matched its anchor
             to 4.5e-8 Ha) and missed by +1.06 Ha -- the recalled term
             selection/coefficients are wrong.  Per the round-2 verdict
             (verify or delete), the alias was deleted rather than
             shipped; the mGGA B97 series machinery (dft/xc.py) remains
             and takes a verified parameter set whenever one can be
             sourced.
             Round 4: benchmarks/wb97mv_screen.py turns candidate
             verification into a seconds-cost check (Exc is linear in
             the series coefficients -> precomputed moment integrals at
             a frozen density; calibrated to ~1-2 mHa against a full
             SCF).  Every curated from-memory candidate missed by
             15-130 mHa, and a blind (i,j)-assignment search showed one
             anchor equation admits thousands of accidental matches --
             so the data CANNOT be reconstructed from memory + one
             anchor; no auditable source (libxc/pyscf/wheel) exists in
             this environment (verified by search).  The gate stands;
             the screen verifies any future externally-sourced set
             before it ships.
"""

B97_GAMMA = (0.004, 0.2, 0.006)

# --------------------------------------------------------------- M06 family
# Form (Zhao & Truhlar, Theor. Chem. Acc. 120, 215 (2008); VSXC terms
# from Van Voorhis & Scuseria, JCP 109, 400 (1998)):
#   E_x  = sum_s [ e_x^PBE_s * f(w_s) + e_x^LSDA_s * h(x_s^2, z_s; dx) ]
#   E_c  = e_ss^UEG [g(gam_ss x^2) + h(x^2, z; dss)] D_s   (per spin)
#        + e_os^UEG [g(gam_os x^2) + h(x^2, z; dos)]       (x^2/z spin-summed)
#   h(x2, z; d) = d0/g + (d1 x2 + d2 z)/g^2 + (d3 x2^2 + d4 x2 z + d5 z^2)/g^3,
#   g = 1 + alpha (x2 + z);  w = (t-1)/(t+1), t = tau^LSDA/tau;
#   z = 2 tau / rho_s^{5/3} - C_F;  D_s = 1 - x2/(4 (z + C_F)).
# The reference runs these through libxc (jqc/pyscf/rks.py:341); no libxc
# here, so data is from the defining papers and anchor-gated like the
# B97 family above.
#
# Verification status (round 5, benchmarks/m06_screen.py + m06_verify.py;
# the b3lyp control on the same oracle pipeline matches its anchor to
# 2.1e-8 Ha, so the pipeline itself is sound):
#  - m06: GATED (unverified=True).  The recalled set passes three exact
#    structural identities (per-channel c0+d0=1; a0+dx0=1-hyb,
#    tests/test_xc_m06.py) and NSC moment screening against the
#    reference anchor -76.4265870634 (ref test_dft.py:91-94) DECISIVELY
#    fixes sign(a1)=+ (the flip moves E by 178 mHa; every other
#    single-entry variant lands >40 mHa away) -- but the best candidate
#    still sits 2.38 mHa BELOW the anchor in NSC, and E_NSC >= E_SCF is
#    a strict variational bound, so the set is provably not yet exact.
#    Tau/D-convention variants were excluded experimentally (256-604
#    mHa off).  Residual error ~2-5 mHa is un-localizable from one
#    anchor equation (wB97M-V lesson); gated until an auditable source
#    exists -- the screen then verifies it in seconds.
#  - m06-l, m06-2x: same machinery; no in-environment anchor at all.
# All three require JQC_ALLOW_UNVERIFIED_XC=1 to resolve via parse_xc.
M06_ALPHA = (0.00186726, 0.00515088, 0.00304966)  # alpha_x, alpha_ss, alpha_os
M06_GAMMA = (0.06, 0.0031)  # gamma_ss, gamma_os

M06_FUNCTIONALS = {
    "m06": dict(
        hyb=0.27,
        a=[5.877943e-01, 1.371776e-01, 2.682367e-01, -2.515898e+00,
           -2.978892e+00, 8.710679e+00, 1.688195e+01, -4.489724e+00,
           -3.299983e+01, -1.449050e+01, 2.043747e+01, 1.256504e+01],
        dx=[1.422057e-01, 7.370319e-04, -1.601373e-02, 0.0, 0.0, 0.0],
        css=[5.094055e-01, -1.491085e+00, 1.723922e+01, -3.859018e+01,
             2.845044e+01],
        dss=[4.905945e-01, -1.437348e-02, 2.357824e-02, 1.871015e-03,
             -3.788963e-03, 0.0],
        cos=[3.741539e+00, 2.187098e+02, -4.531252e+02, 2.939479e+02,
             -6.276542e+01],
        dos=[-2.741539e+00, -6.720113e-01, -7.932688e-02, 1.918681e-03,
             -2.032902e-03, 0.0],
        unverified=True,
    ),
    "m06-l": dict(
        hyb=0.0,
        a=[3.987756e-01, 2.548219e-01, 3.923994e-01, -2.103655e+00,
           -6.302147e+00, 1.097615e+01, 3.097273e+01, -2.318489e+01,
           -5.673480e+01, 2.160364e+01, 3.421814e+01, -9.049762e+00],
        dx=[6.012244e-01, 4.748822e-03, -8.635108e-03, -9.308062e-06,
            4.482811e-05, 0.0],
        css=[5.349466e-01, 5.396620e-01, -3.161217e+01, 5.149592e+01,
             -2.919613e+01],
        dss=[4.650534e-01, 1.617589e-01, 1.833657e-01, 4.692100e-04,
             -4.990573e-03, 0.0],
        cos=[6.042374e-01, 1.776783e+02, -2.513252e+02, 7.635173e+01,
             1.255699e+01],
        dos=[3.957626e-01, -5.614546e-01, 1.403963e-02, 9.831442e-04,
             -3.577176e-03, 0.0],
        unverified=True,
    ),
    "m06-2x": dict(
        hyb=0.54,
        a=[4.600000e-01, -2.206052e-01, -9.431788e-02, 2.164494e+00,
           -2.556466e+00, -1.422133e+01, 1.555044e+01, 3.598078e+01,
           -2.722754e+01, -3.924093e+01, 1.522808e+01, 1.522227e+01],
        dx=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        css=[3.097855e-01, -5.528642e+00, 1.347420e+01, -3.213623e+01,
             2.846742e+01],
        dss=[6.902145e-01, 9.847204e-02, 2.214797e-01, -1.968264e-03,
             -6.775479e-03, 0.0],
        cos=[8.833596e-01, 3.357972e+01, -7.043548e+01, 4.978271e+01,
             -1.852891e+01],
        dos=[1.166404e-01, -9.120847e-02, -6.726189e-02, 6.720580e-05,
             8.448011e-04, 0.0],
        unverified=True,
    ),
}

FUNCTIONALS = {
    # Becke 1997 hybrid GGA: 19.43% exact exchange.
    "b97": dict(
        family="gga",
        series="gga",
        x=[0.8094, 0.5073, 0.7481],
        css=[0.1737, 2.3487, -2.4868],
        cos=[0.9454, 0.7471, -4.5961],
        hyb=0.1943,
        alpha=0.1943,
        omega=0.0,
        nlc=None,
    ),
    # wB97X-V: RSH GGA + VV10. SR-HF 16.7%, LR-HF 100%, omega=0.3.
    "wb97x-v": dict(
        family="gga",
        series="gga",
        x=[0.833, 0.603, 1.194],
        css=[0.556, -0.257],
        cos=[1.219, -1.850],
        hyb=0.167,
        alpha=1.0,
        omega=0.3,
        nlc=(6.0, 0.01),
    ),
}
