"""Restricted Kohn-Sham DFT driver.

Port of ``joltqc_tpu/scf/rks.py``.  It reuses the RHF SCF loop
(scf/hf.py) and overrides ``get_veff``/``energy_elec`` with grid XC + J
(+ hybrid / range-separated K), K_eff = hyb*K + (alpha-hyb)*K_lr(omega).
The Fock builds go through the port's ``JKEngine`` (J only for pure
functionals, J+K for hybrids, omega plans for range-separated hybrids).

Supports LDA / GGA / meta-GGA (tau) functionals, global hybrids,
range-separated hybrids, and VV10 nonlocal correlation (defaults pulled
from the functional's own nlc metadata, e.g. wb97x-v).

The defaults are the JAX package's: mixed float32/float64 numint
(``dft_cutoff_fp64 = 1e-6``, dft/mixed.py), AO-value screening
(``screen_thresh = 1e-12``, dft/screening.py) whenever it drops more than
40% of the AO work, and, with ``incremental=True``, rho / wv / vxcmat
cached and re-evaluated only on delta-dm / delta-wv over AABB-selected
grid blocks.  The three compose: the mixed tier takes the screened
evaluator as its float32 bulk, and both screened evaluators accept the
incremental block selection.  The host logic (block bounds, selection,
the 0.6 fill rule) is the JAX package's numpy code.
"""

from __future__ import annotations

import time

import numpy as np

from ..dft.grids import Grids
from ..dft.mixed import eval_rho_mixed, eval_vxc_mixed, shell_value_bound
from ..dft.numint import NumInt, _blocked, eval_rho_all, eval_vxc_mat
from ..dft.screening import GridScreening, eval_rho_screened, eval_vxc_screened
from ..dft.vv10 import nlc_exc_vxc
from ..dft.xc import eval_xc, nlc_coeff, rsh_coeff, xc_family
from .hf import RHF


class RKS(RHF):
    def __init__(
        self,
        mol,
        xc: str = "lda,vwn",
        grids: Grids | None = None,
        nlc=None,
        nlcgrids: Grids | bool | None = None,
        **kw,
    ):
        super().__init__(mol, **kw)
        self.xc = xc
        self.family = xc_family(xc)
        self.omega, self.alpha, self.hyb = rsh_coeff(xc)
        # nlc: None (functional default) | False (off) | True (VV10
        # b=5.9, C=0.0093) | (b, C)
        if nlc is None:
            self.nlc = nlc_coeff(xc)
        elif nlc is True:
            self.nlc = (5.9, 0.0093)
        elif nlc is False:
            self.nlc = None
        else:
            self.nlc = nlc
        self.grids = grids if grids is not None else Grids(mol)
        # separate (coarser) grid for the VV10 nonlocal term: None = share
        # self.grids; True = a level-2-like coarse grid
        if nlcgrids is True:
            nlcgrids = Grids(mol, n_ang=194)
        self.nlcgrids = nlcgrids or None
        self.ni = NumInt(self.layout, device=self.device)
        # DFT precision window: AO pairs whose log bound exceeds
        # dft_cutoff_fp64 are evaluated in float64 (dft/mixed.py); the rest
        # run the float32 bulk path.  None disables the float64 tier.
        self.dft_cutoff_fp64 = 1e-6
        self.dft_cutoff_fp32 = 1e-13
        # incremental DFT: with self.incremental, rho/vxcmat are cached and
        # re-evaluated only on delta-dm / delta-wv over grid blocks whose
        # AABB AO bound x delta magnitude is significant; exact by
        # linearity
        self.incr_dft_thresh = 1e-13
        self.dft_block_evals = 0  # evaluated-block counter (tests/logs)
        self._dft_cache = None
        self._blk_bounds = None
        # AO-value screening: a float threshold (default 1e-12; None
        # selects the same default) enables the sparse path when it drops
        # >40% of the AO work; False = always dense
        self.screen_thresh = 1e-12
        self._scr = None
        self._ecoul = 0.0
        self._exc = 0.0
        # host wall seconds of get_veff's DFT layer and of its J/K calls
        self.veff_time = {"dft": 0.0, "jk": 0.0}

    def _block_bounds(self):
        """(nblk,) log bound on max |ao_i ao_j| per grid block (AABB)."""
        if getattr(self, "_blk_bounds", None) is not None:
            return self._blk_bounds
        blocks, _ = _blocked(self.grids.coords, self.ni.block)
        lo = blocks.min(axis=1)
        hi = blocks.max(axis=1)
        diam = np.linalg.norm(hi - lo, axis=1)
        best = np.full(len(blocks), -np.inf)
        for sh in self.mol.shells:
            c = sh.coord[None, :]
            d = np.maximum(lo - c, 0.0) + np.maximum(c - hi, 0.0)
            dist = np.linalg.norm(d, axis=1)
            rmax = dist + diam
            emin = float(sh.exps.min())
            cmax = float(np.abs(sh.coeffs).max() * max(sh.nprim, 1))
            b = (
                np.log(max(cmax, 1e-300))
                + sh.l * np.log(np.maximum(rmax, 1.0))
                - emin * dist**2
            )
            best = np.maximum(best, b)
        self._blk_bounds = 2.0 * best  # |ao_i ao_j| <= exp(2 max log ao)
        return self._blk_bounds

    def _screening(self):
        """Build (once) and return the grid screening, or None for dense."""
        if self._scr is None:
            if self.screen_thresh is False:
                self._scr = False
            else:
                thresh = (
                    self.screen_thresh
                    if isinstance(self.screen_thresh, float)
                    else 1e-12
                )
                scr = GridScreening(self.ni, self.grids, thresh)
                self._scr = scr if scr.fill_fraction < 0.6 else False
        return self._scr or None

    # ------------------------------------------------------- evaluators
    def _rho_eval(self, d, family, sel=None):
        """rho rows of internal dm ``d``: float32 bulk (screened when
        screening pays, dense otherwise) + the float64 tier when mixed."""
        scr = self._screening()

        def bulk(dd, s):
            if scr is not None:
                return eval_rho_screened(self.ni, scr, dd, family, block_sel=s)
            return eval_rho_all(self.ni, self.grids, dd, family, block_sel=s)

        if self.dft_cutoff_fp64 is not None:
            return eval_rho_mixed(
                self.ni, self.grids, d, family, self.layout,
                self.dft_cutoff_fp64, block_sel=sel, bulk=bulk,
            )
        return bulk(d, sel)

    def _vxc_eval(self, wv, family, sel=None):
        """V_xc (internal basis) of potential rows ``wv``, routed as
        ``_rho_eval``."""
        scr = self._screening()

        def bulk(w, s):
            if scr is not None:
                return eval_vxc_screened(self.ni, scr, w, family, block_sel=s)
            return eval_vxc_mat(self.ni, self.grids, w, family, block_sel=s)

        if self.dft_cutoff_fp64 is not None:
            return eval_vxc_mixed(
                self.ni, self.grids, wv, family, self.layout,
                self.dft_cutoff_fp64, block_sel=sel, bulk=bulk,
            )
        return bulk(wv, sel)

    def get_veff(self, dm):
        t0 = time.perf_counter()
        if self.grids.coords is None:
            self.grids.build()
        lay = self.layout
        dm = np.asarray(dm, np.float64)
        dm_int = lay.dm_to_internal(dm)

        fam = self.family
        need_grad = fam != "lda" or self.nlc is not None
        rho_fam = fam if fam != "lda" or self.nlc is None else "gga"

        cache = self._dft_cache if self.incremental else None
        if cache is not None and cache.get("fam") != rho_fam:
            cache = None
        if cache is not None:
            ddm = dm_int - cache["dm_int"]
            bb = self._block_bounds()
            dlog = np.log(max(np.abs(ddm).max(), 1e-300)) + np.log(
                max(self.layout.nao_int, 1)
            )
            sel = np.nonzero(bb + dlog > np.log(self.incr_dft_thresh))[0]
            self.dft_block_evals += len(sel)
            rho = cache["rho"] + (
                self._rho_eval(ddm, rho_fam, sel) if len(sel) else 0.0)
        else:
            rho = self._rho_eval(dm_int, rho_fam)
            if self.incremental:
                self.dft_block_evals += len(self._block_bounds())
        sigma = (rho[1:4] ** 2).sum(axis=0) if need_grad else None
        tau = rho[4] if fam == "mgga" else None
        e, vr, vs, vt = eval_xc(
            self.xc, rho[0], sigma if fam != "lda" else None, tau,
            device=self.device,
        )
        if fam == "lda":
            vs = np.zeros_like(vr)

        w = self.grids.weights
        exc = float(np.sum(w * e))
        self._nelec_grid = float(np.sum(w * rho[0]))

        vxc_nlc_int = None
        if self.nlc is not None:
            b, C = self.nlc
            if self.nlcgrids is not None:
                # VV10 on its own (coarse) grid: GGA rho rows there, its
                # energy + a separate vxc matrix integrated on that grid,
                # dense (the nlc grid is small and VV10 potentials smooth)
                if self.nlcgrids.coords is None:
                    self.nlcgrids.build()
                rho_n = eval_rho_all(self.ni, self.nlcgrids, dm_int, "gga")
                sigma_n = (rho_n[1:4] ** 2).sum(axis=0)
                w_n = self.nlcgrids.weights
                e_nlc, vr_n, vs_n = nlc_exc_vxc(
                    self.nlcgrids.coords, w_n, rho_n[0], sigma_n, b, C,
                    device=self.device,
                )
                exc += e_nlc
                wv_n = np.concatenate(
                    [
                        (w_n * vr_n)[None, :],
                        2.0 * (w_n * vs_n)[None, :] * rho_n[1:4],
                    ]
                )
                vxc_nlc_int = eval_vxc_mat(
                    self.ni, self.nlcgrids, wv_n, "gga"
                )
            else:
                # shared grid: fold VV10 potentials into the XC rows
                e_nlc, vr_n, vs_n = nlc_exc_vxc(
                    self.grids.coords, w, rho[0], sigma, b, C,
                    device=self.device,
                )
                exc += e_nlc
                vr = vr + vr_n
                vs = vs + vs_n

        if need_grad:
            wv_rows = [(w * vr)[None, :], 2.0 * (w * vs)[None, :] * rho[1:4]]
            if fam == "mgga":
                wv_rows.append((w * vt)[None, :])
            wv = np.concatenate(wv_rows)
            vxc_fam = "mgga" if fam == "mgga" else "gga"
        else:
            wv = (w * vr)[None, :]
            vxc_fam = "lda"

        if cache is not None and cache.get("vxc_fam") == vxc_fam:
            dwv = wv - cache["wv"]
            bb = self._block_bounds()
            B = self.ni.block
            nblk = len(bb)
            dpad = np.zeros((dwv.shape[0], nblk * B))
            dpad[:, : dwv.shape[1]] = np.abs(dwv)
            blk_max = dpad.reshape(dwv.shape[0], nblk, B).max(axis=(0, 2))
            wlog = np.log(np.maximum(blk_max * B, 1e-300))
            selv = np.nonzero(bb + wlog > np.log(self.incr_dft_thresh))[0]
            self.dft_block_evals += len(selv)
            vxc_int = cache["vxc"] + (
                self._vxc_eval(dwv, vxc_fam, selv) if len(selv) else 0.0
            )
        else:
            vxc_int = self._vxc_eval(wv, vxc_fam)
        if self.incremental:
            # cache holds the MAIN-grid vxc only; the separate-grid VV10
            # term is recomputed in full each iteration (coarse = cheap)
            self._dft_cache = dict(
                dm_int=dm_int, rho=rho, wv=wv, vxc=vxc_int,
                fam=rho_fam, vxc_fam=vxc_fam,
            )
        if vxc_nlc_int is not None:
            vxc_int = vxc_int + vxc_nlc_int
        vxc = lay.mat_to_mol(vxc_int)
        t1 = time.perf_counter()

        jk_call = self.jk.get_jk_incr if self.incremental else self.jk.get_jk
        if self.hyb > 0 or self.omega > 0:
            vj, vk = jk_call(dm)
            vk_eff = self.hyb * vk
            if self.omega > 0 and abs(self.alpha - self.hyb) > 1e-12:
                _, vk_lr = jk_call(dm, with_j=False, omega=self.omega)
                vk_eff = vk_eff + (self.alpha - self.hyb) * vk_lr
            veff = vxc + vj - 0.5 * vk_eff
            exc -= 0.25 * float(np.einsum("ij,ij->", dm, vk_eff))
        else:
            vj, _ = jk_call(dm, with_k=False)
            veff = vxc + vj
        self._ecoul = 0.5 * float(np.einsum("ij,ij->", dm, vj))
        self._exc = exc
        self.veff_time["dft"] += t1 - t0
        self.veff_time["jk"] += time.perf_counter() - t1
        return veff

    def energy_elec(self, dm, h, veff):
        return float(np.einsum("ij,ij->", dm, h)) + self._ecoul + self._exc

    def reset_incremental(self):
        super().reset_incremental()
        self._dft_cache = None
        self.dft_block_evals = 0
        self.veff_time = {"dft": 0.0, "jk": 0.0}

    def _regrid(self, g):
        """Rebuild a Grids object for the (possibly new) molecule with
        the SAME quadrature spec the user configured."""
        return Grids(
            self.mol, n_rad=g.n_rad, n_theta=g.n_theta, n_phi=g.n_phi,
            block=g.block, prune=g.prune, n_ang=g.n_ang, angular=g.angular,
        )

    def reset(self, mol=None):
        super().reset(mol)
        self.grids = self._regrid(self.grids)
        if self.nlcgrids is not None:
            self.nlcgrids = self._regrid(self.nlcgrids)
        self.ni = NumInt(self.layout, device=self.device)
        self._scr = None
        self._dft_cache = None
        self._blk_bounds = None
        return self


__all__ = ["RKS"]
