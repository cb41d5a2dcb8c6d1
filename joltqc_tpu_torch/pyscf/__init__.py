"""PySCF adapter: ``joltqc_tpu_torch.pyscf.apply(mf, config, device)``.

Port of ``joltqc_tpu/pyscf/__init__.py``.  ``apply`` patches a PySCF
mean-field object so that its Fock builds run on the card through the
port's engines (``JKEngine``, ``dft.numint`` / ``mixed`` / ``vv10`` /
``xc``, ``ECPEngine``), while PySCF keeps the SCF loop:

    import pyscf, joltqc_tpu_torch.pyscf as jqc
    mf = jqc.apply(pyscf.scf.RHF(mol))
    mf.kernel()

``pyscf`` is imported only inside ``apply``: without it ``apply`` raises
ImportError (the standalone drivers ``joltqc_tpu_torch.scf.RHF`` / ``RKS``
cover the same work), and the patches themselves run through
``_apply_patches`` on any object shaped like a PySCF RHF/RKS.  Engines
run on ``cuda`` unless ``device='cpu'`` is passed.

Two behaviours differ from the JAX package's adapter, whose behaviour is
a defect there:
 - the RHF ``get_veff`` adds ``vhf_last`` only when J/K ran on the delta
   density (``direct_scf`` and a ``dm_last``); the reference adds it also
   after a build on the full density;
 - the RKS ``get_veff`` runs the nonlocal (VV10) correction when either
   the xc string or a non-empty ``mf.nlc`` asks for it (PySCF's rule,
   ``mf.nlc`` naming the nonlocal part, e.g. ``'vv10'``); the reference
   reads only the xc string.
"""

from __future__ import annotations

import numpy as np

VV10_PARAMS = (5.9, 0.0093)  # VV10's (b, C)


def get_default_config() -> dict:
    """Mixed-precision defaults (JoltQC jqc/pyscf/__init__.py:100-118)."""
    return {
        "jk": {"cutoff_fp32": 1e-13, "cutoff_fp64": 1e-6},
        "dft": {"cutoff_fp32": 1e-13, "cutoff_fp64": 1e-6},
    }


def merge_config(config: dict | None) -> dict:
    """Overlay a user config onto the defaults (nested, per domain)."""
    out = get_default_config()
    for domain, vals in (config or {}).items():
        if domain not in out:
            out[domain] = dict(vals)
        else:
            out[domain].update(vals)
    return out


def molecule_from_pyscf(pmol):
    """The port's Molecule of a built pyscf ``gto.Mole``, read through
    public Mole accessors only (plus ``_ecp``, PySCF's parsed ECP
    table)."""
    from ..mol.ecp import ECPChannel, ECPData
    from ..mol.molecule import Molecule, Shell

    mol = Molecule(
        atom_symbols=[pmol.atom_symbol(i) for i in range(pmol.natm)],
        coords=np.asarray(pmol.atom_coords()),  # Bohr
        charge=int(pmol.charge),
        spin=int(pmol.spin),
        cart=bool(pmol.cart),
        basis=str(pmol.basis),
    )
    # shells straight from the built _bas table via public accessors
    for ib in range(pmol.nbas):
        l = pmol.bas_angl(ib)
        ia = pmol.bas_atom(ib)
        exps = np.asarray(pmol.bas_exp(ib), np.float64)
        ctr = np.asarray(pmol.bas_ctr_coeff(ib), np.float64)  # (nprim, nctr)
        for c in range(ctr.shape[1]):
            mol.shells.append(
                Shell(l, exps.copy(), ctr[:, c].copy(), mol.coords[ia], ia)
            )
    # ECP blocks (semi-local, PySCF's _ecp layout)
    if getattr(pmol, "_ecp", None):
        ecp = {}
        for sym in set(mol.atom_symbols):
            if sym not in pmol._ecp:
                continue
            ncore, chans = pmol._ecp[sym]
            channels = []
            for l, prims in chans:
                # prims: one list per r power of [exp, [c0, c1, ...]]
                powers, exps, coefs = [], [], []
                for n, grp in enumerate(prims):
                    for e_c in grp:
                        powers.append(n)
                        exps.append(e_c[0])
                        coefs.append(e_c[1][0]
                                     if isinstance(e_c[1], (list, tuple))
                                     else e_c[1])
                channels.append(ECPChannel(l, np.array(powers, int),
                                           np.array(exps), np.array(coefs)))
            ecp[sym] = ECPData(ncore=ncore, channels=channels)
        mol.ecp = ecp
    return mol


def patch_ecp_integrals(pmol, matrix_fn):
    """Route ``mol.intor('ECPscalar')`` (and ``intor_symmetric``, through
    which PySCF's ``hf.get_hcore`` fetches it) to ``matrix_fn()``, a
    zero-argument callable returning the (nao, nao) mol-basis matrix
    (JoltQC jqc/pyscf/ecp.py:74)."""
    # the molecule's own intor, kept at the first patch, so that a
    # re-patch (``reset``) routes it once
    orig = pmol.__dict__.setdefault("_joltqc_orig_intor", (
        pmol.intor, getattr(pmol, "intor_symmetric", None)))
    orig_intor, orig_intor_symmetric = orig

    def _route(orig, key, *args, **kw):
        base = key.replace("_sph", "").replace("_cart", "")
        if base == "ECPscalar":
            return matrix_fn()
        return orig(key, *args, **kw)

    pmol.intor = lambda key, *a, **k: _route(orig_intor, key, *a, **k)
    if orig_intor_symmetric is not None:
        pmol.intor_symmetric = lambda key, *a, **k: _route(
            orig_intor_symmetric, key, *a, **k
        )
    return pmol


def _nlc_params(xc_code: str):
    """VV10 (b, C) of ``xc_code``: the functional's own, VV10's where the
    code names only the nonlocal part (``'vv10'``, as ``mf.nlc`` does) or
    carries none."""
    from ..dft.xc import nlc_coeff

    if xc_code.strip().lower() == "vv10":
        return VV10_PARAMS
    return nlc_coeff(xc_code) or VV10_PARAMS


def _patch_rks(mf, mol, layout, cfg, device=None):
    """Install the grid and numint patches on an RKS-like object:
    ``_numint.nr_rks``, ``_numint.get_rho``, ``_numint.nr_nlc_vxc`` and
    ``grids.build`` (JoltQC jqc/pyscf/__init__.py:191-206)."""
    from ..dft.grids import Grids
    from ..dft.mixed import eval_rho_mixed, eval_vxc_mixed
    from ..dft.numint import NumInt, eval_rho_all, eval_vxc_mat
    from ..dft.vv10 import nlc_exc_vxc
    from ..dft.xc import eval_xc, xc_family

    ni = NumInt(layout, device=device)
    dft_cut64 = cfg["dft"]["cutoff_fp64"]

    class _GridShim:
        def __init__(self, coords):
            self.coords = np.asarray(coords, np.float64)

    def _grid_of(grids_obj):
        if getattr(grids_obj, "coords", None) is None:
            grids_obj.build()
        return (
            _GridShim(grids_obj.coords),
            np.asarray(grids_obj.weights, np.float64),
        )

    def build_grids(*a, **k):
        """The port's box-sorted grid in place of PySCF's build
        (JoltQC jqc/pyscf/rks.py:100-177)."""
        g = Grids(mol)
        g.build()
        mf.grids.coords = g.coords
        mf.grids.weights = g.weights
        return mf.grids

    def get_rho(mol_=None, dm=None, grids=None, *a, **k):
        shim, _w = _grid_of(grids if grids is not None else mf.grids)
        dm_int = layout.dm_to_internal(np.asarray(dm, np.float64))
        return eval_rho_all(ni, shim, dm_int, "lda")[0]

    def nr_rks(mol_=None, grids=None, xc_code=None, dms=None, *a, **k):
        """(nelec, excsum, vxcmat): PySCF's numint contract."""
        xc_code = xc_code if xc_code is not None else mf.xc
        fam = xc_family(xc_code)
        shim, w = _grid_of(grids if grids is not None else mf.grids)
        dm_int = layout.dm_to_internal(np.asarray(dms, np.float64))
        rho = eval_rho_mixed(ni, shim, dm_int, fam, layout, dft_cut64)
        sigma = (rho[1:4] ** 2).sum(axis=0) if fam != "lda" else None
        tau = rho[4] if fam == "mgga" else None
        e, vr, vs, vt = eval_xc(xc_code, rho[0], sigma, tau, device=device)
        nelec = float(np.sum(w * rho[0]))
        excsum = float(np.sum(w * e))
        if fam == "lda":
            wv = (w * vr)[None, :]
        else:
            rows = [(w * vr)[None, :], 2.0 * (w * vs)[None, :] * rho[1:4]]
            if fam == "mgga":
                rows.append((w * vt)[None, :])
            wv = np.concatenate(rows)
        vmat = layout.mat_to_mol(
            eval_vxc_mixed(ni, shim, wv, fam, layout, dft_cut64)
        )
        return nelec, excsum, vmat

    def nr_nlc_vxc(mol_=None, grids=None, xc_code=None, dms=None, *a, **k):
        """(nelec, e_nlc, vmat) of the VV10 nonlocal correction."""
        xc_code = xc_code if xc_code is not None else mf.xc
        b, c = _nlc_params(xc_code)
        shim, w = _grid_of(grids if grids is not None else mf.grids)
        dm_int = layout.dm_to_internal(np.asarray(dms, np.float64))
        rho = eval_rho_all(ni, shim, dm_int, "gga")
        sigma = (rho[1:4] ** 2).sum(axis=0)
        e_nlc, vr, vs = nlc_exc_vxc(shim.coords, w, rho[0], sigma, b, c,
                                    device=device)
        wv = np.concatenate(
            [(w * vr)[None, :], 2.0 * (w * vs)[None, :] * rho[1:4]]
        )
        vmat = layout.mat_to_mol(eval_vxc_mat(ni, shim, wv, "gga"))
        return float(np.sum(w * rho[0])), e_nlc, vmat

    if hasattr(mf, "grids"):
        mf.grids.build = build_grids
    numint = getattr(mf, "_numint", None)
    if numint is not None:
        numint.nr_rks = nr_rks
        numint.get_rho = get_rho
        numint.nr_nlc_vxc = nr_nlc_vxc
    return ni


def apply(mf, config: dict | None = None, device=None):
    """Patch a PySCF mean-field object to run its Fock builds on the card
    (``device``, default ``cuda``): ``get_jk`` / ``get_j`` / ``get_k`` and
    ``get_veff`` on every RHF-type object; ``_numint.nr_rks`` /
    ``get_rho`` / ``nr_nlc_vxc`` and ``grids.build`` on RKS objects; the
    ECP integrals when the molecule carries an ECP; ``reset`` /
    ``as_scanner`` wrapped so that a geometry change re-applies them
    (JoltQC jqc/pyscf/__init__.py:191-252)."""
    try:
        import pyscf  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "joltqc_tpu_torch.pyscf.apply requires pyscf; use the standalone "
            "drivers joltqc_tpu_torch.scf.RHF / RKS instead"
        ) from e
    return _apply_patches(mf, config, device)


class _Tagged(np.ndarray):
    """ndarray carrying PySCF-style tags (ecoul / exc / vj / vk
    attributes): the numpy stand-in for gpu4pyscf's ``tag_array`` of the
    reference's RKS veff (JoltQC jqc/pyscf/rks.py:251-263)."""


def _tag(arr, **tags):
    out = np.asarray(arr).view(_Tagged)
    for k, v in tags.items():
        setattr(out, k, v)
    return out


def _make_rhf_get_veff(mf, get_jk):
    """Incremental direct-SCF veff of RHF objects (JoltQC
    jqc/pyscf/jk.py:78-90): with ``mf.direct_scf`` and a ``dm_last`` the
    J/K build runs on the delta density only (J and K are linear in dm)
    and ``vhf_last`` is added back; otherwise J/K run on the full density
    and ``vhf_last`` is not added (where the JAX package adds it)."""

    def get_veff(mol_=None, dm=None, dm_last=None, vhf_last=None,
                 hermi=1, **kw):
        if dm is None:
            dm = mf.make_rdm1()
        incr = dm_last is not None and getattr(mf, "direct_scf", False)
        if incr:
            dm = np.asarray(dm) - np.asarray(dm_last)
        vj, vk = get_jk(mol_, dm, hermi)
        vhf = vj - 0.5 * vk
        if incr and vhf_last is not None:
            vhf = vhf + np.asarray(vhf_last)
        return vhf

    return get_veff


def _make_rks_get_veff(mf, get_jk, get_j, get_k):
    """RKS veff: vxc plus the (incremental) J/K terms, with PySCF-style
    tags (ecoul / exc / vj / vk; JoltQC jqc/pyscf/rks.py:180-263).
    hermi=2 skips vxc (an antisymmetric dm has rho = 0); the nonlocal
    correction runs on ``nlcgrids`` when the xc string or a non-empty
    ``mf.nlc`` asks for it (module docstring); hybrids compose hyb*K +
    (alpha - hyb)*K_lr(omega); with ``mf.direct_scf`` and a tagged
    ``vhf_last`` J/K run on the delta density."""
    from ..dft.xc import nlc_coeff, rsh_coeff

    def get_veff(mol_=None, dm=None, dm_last=0, vhf_last=0, hermi=1, **kw):
        if dm is None:
            dm = mf.make_rdm1()
        dm = np.asarray(dm, np.float64)
        xc = mf.xc
        if hermi == 2:  # rho = 0: antisymmetric dm contributes no vxc
            nelec, exc, vxc = 0.0, 0.0, 0.0
        else:
            nelec, exc, vxc = mf._numint.nr_rks(mol_, mf.grids, xc, dm)
            nlc = getattr(mf, "nlc", None)
            xc_nlc = nlc_coeff(xc) is not None
            if (xc_nlc or nlc) and getattr(mf, "nlcgrids", None) is not None:
                code = xc if xc_nlc else (nlc if isinstance(nlc, str)
                                          else "vv10")
                _, enlc, vnlc = mf._numint.nr_nlc_vxc(mol_, mf.nlcgrids,
                                                      code, dm)
                exc += enlc
                vxc = vxc + vnlc
        omega, alpha, hyb = rsh_coeff(xc)
        incr = (
            getattr(mf, "direct_scf", False)
            and getattr(vhf_last, "vj", None) is not None
        )
        if hyb == 0.0 and alpha == 0.0:  # pure functional: J only
            vk = None
            if incr:
                ddm = dm - np.asarray(dm_last)
                vj = get_j(mol_, ddm, hermi) + vhf_last.vj
            else:
                vj = get_j(mol_, dm, hermi)
            vxc = vxc + vj
        else:
            incr = incr and getattr(vhf_last, "vk", None) is not None
            dm_eval = dm - np.asarray(dm_last) if incr else dm
            vj, vk = get_jk(mol_, dm_eval, hermi)
            vk = vk * hyb
            if abs(omega) > 1e-10 and abs(alpha - hyb) > 1e-12:
                vk = vk + (alpha - hyb) * get_k(
                    mol_, dm_eval, hermi, omega=omega
                )
            if incr:
                vj = vj + vhf_last.vj
                vk = vk + vhf_last.vk
            vxc = vxc + vj - 0.5 * vk
        ground_state = dm.ndim == 2
        ecoul = exc_tag = None
        if ground_state:
            ecoul = 0.5 * float(np.einsum("ij,ij->", dm, np.asarray(vj)))
            exc_tag = exc
            if vk is not None:
                exc_tag = exc_tag - 0.25 * float(
                    np.einsum("ij,ij->", dm, np.asarray(vk))
                )
        return _tag(vxc, ecoul=ecoul, exc=exc_tag, vj=vj, vk=vk)

    return get_veff


def _apply_patches(mf, config: dict | None = None, device=None):
    """The patch wiring behind ``apply`` (apart, so that it runs on
    objects shaped like PySCF's without pyscf installed)."""
    from ..mol.layout import BasisLayout
    from ..scf.jk_contracted import JKEngine

    cfg = merge_config(config)
    mol = (
        molecule_from_pyscf(mf.mol)
        if not hasattr(mf.mol, "shells")
        else mf.mol
    )
    layout = BasisLayout(mol)
    engine = JKEngine(
        layout,
        device=device,
        cutoff_fp32=cfg["jk"]["cutoff_fp32"],
        cutoff_fp64=cfg["jk"]["cutoff_fp64"],
    )

    def get_jk(mol_=None, dm=None, hermi=1, with_j=True, with_k=True,
               omega=None, **kw):
        # hermi is forwarded: hermi=0 callers (newton/SOSCF, CPHF, TDDFT
        # response) rely on the engine's non-symmetric-dm path
        return engine.get_jk(
            np.asarray(dm), with_j=with_j, with_k=with_k,
            omega=omega or 0.0, hermi=hermi,
        )

    # PySCF calls these positionally: self.get_j(mol, dm, hermi, ...)
    def get_j(mol_=None, dm=None, hermi=1, *a, **k):
        return get_jk(mol_, dm, hermi, True, False, k.get("omega"))[0]

    def get_k(mol_=None, dm=None, hermi=1, *a, **k):
        return get_jk(mol_, dm, hermi, False, True, k.get("omega"))[1]

    mf.get_jk = get_jk
    mf.get_j = get_j
    mf.get_k = get_k

    ni = None
    if hasattr(mf, "xc"):  # RKS-type object
        ni = _patch_rks(mf, mol, layout, cfg, device)
        mf.get_veff = _make_rks_get_veff(mf, get_jk, get_j, get_k)
    else:
        mf.get_veff = _make_rhf_get_veff(mf, get_jk)

    if getattr(mol, "ecp", None):
        from ..scf.ecp import ECPEngine

        ecp_engine = ECPEngine(layout, device=device)
        _cache: dict = {}

        def ecp_matrix():
            if "mat" not in _cache:
                _cache["mat"] = ecp_engine.build()
            return _cache["mat"]

        patch_ecp_integrals(mf.mol, ecp_matrix)

    # reset / as_scanner wrapping (JoltQC jqc/pyscf/__init__.py:239-252).
    # The wrappers call the object's own methods, kept at the first patch:
    # a reset re-applies the patches once, and does not wrap its own
    # wrapper (the JAX adapter's chain grows by one wrapper, and one more
    # re-application, per reset)
    orig = mf.__dict__.setdefault("_joltqc_orig", {
        "reset": getattr(mf, "reset", None),
        "as_scanner": getattr(mf, "as_scanner", None)})
    if orig["reset"] is not None:
        def reset(mol_new=None, *a, **k):
            out = (orig["reset"](mol_new, *a, **k) if mol_new is not None
                   else orig["reset"]())
            _apply_patches(mf, config, device)  # new geometry, new layout
            return out

        mf.reset = reset
    if orig["as_scanner"] is not None:
        def as_scanner(*a, **k):
            return orig["as_scanner"](*a, **k)  # it drives mf.reset

        mf.as_scanner = as_scanner

    mf._joltqc_wrapped = True
    mf._joltqc_torch = dict(engine=engine, layout=layout, config=cfg,
                            numint=ni, device=engine.device)
    return mf


__all__ = [
    "apply",
    "get_default_config",
    "merge_config",
    "molecule_from_pyscf",
    "patch_ecp_integrals",
]
