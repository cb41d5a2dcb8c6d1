"""Pair-algorithm J/K engine: Hermite-density Coulomb, E·M·Eᵀ exchange.

Port of ``joltqc_tpu/scf/jk_pair.py`` (``PairJEngine`` / ``PairJKEngine``).
The McMurchie-Davidson factorisation of the Coulomb matrix,

    J_ab     = sum_t E^ab_t JH[P_ab, t]
    JH[P, t] = sum_Q pref(P, Q) sum_u (-1)^|u| R_{t+u}(P - Q) D[Q, u]
    D[Q, u]  = sum_cd E^cd_u dm_cd              (Hermite-space density)

computes the E rows once per primitive pair instead of once per shell
quartet, and collapses the work of a (bra pair, ket pair) task to an
NT_ab x NT_cd Hermite matrix-vector product: the right algorithm when only
J is needed (pure-functional DFT).  Exchange factors each task's ERI block
as G = sum_combos E_bra · M · E_ketᵀ.

Stages, as the reference's, with the primitive pairs of a shell pair on a
tensor axis (``npp`` = nprim_a * nprim_b) instead of unrolled loops:

 - tables (once per engine, pair class and tier, after the Schwarz sort):
   per shell pair and primitive pair the exponent sum p, the centre P, the
   coefficient product and the E rows (P, npp, nf_ab, NT_ab), which carry
   no coefficient (it goes into the prefactor);
 - stage A (per call): D[P, combo, u] = sum_f wpair dm_f E[f, u], with the
   x2 weight of an off-diagonal pair folded in;
 - stage B: the screened tasks of every (bra class, ket class, tier) in
   chunks; a chunk's npp_b x npp_k combos are a tensor axis; M = R_{t+u}
   times the prefactor 2 pi^{5/2} / (p q sqrt(p + q)) c_b c_k w, then the
   forward M·(sgn D_k) into the bra's JH and the reverse sgn (D_bᵀ·M)
   into the ket's JH (w = 0.5 when bra == ket);
 - stage C: blk = sum_{combo, t} E_t JH[pair, combo, t] with unit
   coefficients, 0.5 on shell-diagonal pairs, into vj; then V + Vᵀ;
 - ``get_k``: per chunk X = sum_ket-combos M·E_ketᵀ, G = sum_bra-combos
   E_bra·X, weighted by ``build_quartet_tasks``' w, then the K streams of
   ``jk_contracted._contract_blocks`` into vk; then V + Vᵀ.

Screening and tiers are the reference's: ``build_quartet_tasks`` over
p2 <= p1 with the cutoffs shifted by log max|dm|, fp64 (the reference's
"df64") and f32 tasks, each stage in its tier's dtype.  The f32 tier runs
float32 at full precision: on the card the engine raises when TF32
matmuls are enabled.  The task lists are rebuilt on every call, as the
reference does.

Accumulation is exact, in the integer limbs of ``ops/accum.py``, so a
repeated call is bit-identical and the sum does not depend on the order
of the chunks or on how they group the tasks.  (A task's own values come
from batched products, which a library may round differently for a very
small batch: the CPU's does for one- or two-task chunks of (dd|dd)
shape.)  Every accumulator has one exponent e for all its contributions,
fixed before its scatter loop; no value is read back to the host inside
a chunk loop:

 - JH (per pair class and tier): an analytic bound read once per call
   (one device-to-host copy of all of them) after stage A.  A
   contribution is at most |c_b| sum_combos g(p, q) Rmax(p, q) |c_k| sum_u
   |D_k| (forward; the reverse swaps the sides), where g = 2 pi^{5/2} /
   (p q sqrt(p + q)) and, by Cramér's inequality on Hermite functions,
   |R_tuv| <= 1.29 sqrt(L!) max(1, 2 theta)^{L/2}.  The primitive pairs
   are binned by the binary exponent of p; the bound is the largest
   product over the bins' (p, q) boxes (g at the boxes' small corner,
   theta at the large one), times 2;
 - vj: the largest |value| of all stage-C blocks (one read, then one
   scatter);
 - vk: the quartet engine's Schwarz bound, nf_sum * 2 exp(q_ab + q_cd +
   log max|dm| + 0.5), from the host's q.
The reference decodes each chunk's limbs and adds them in floating point,
so its accumulators cannot overflow; these sum all chunks as int64, which
holds below 2^23 contributions of the bound's size per element.  A JH
element takes at most one contribution per partner pair and direction,
a vk element four per shell-segment pair for each pair of segments that
share its AOs; the engine raises before that count could reach
``LIMB_TERMS_MAX`` (``tests/test_torch_jk_pair.py``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..mol.layout import BasisLayout
from ..ops.accum import NLIMB, add_limbs_, bound_exponent, limbs_to_f64, \
    scatter_limbs
from ..ops.boys import boys
from ..ops.cuda import check_fp32_matmul
from ..ops.harmonics import cart_components
from ..ops.md import (coupling_index, e_rows, e_table, ket_signs,
                      make_pair_data, r_table, tri_set)
from .jk_contracted import JKEngine, _contract_blocks
from .tasks import build_quartet_tasks

# elements of the largest stacked intermediate of one chunk
PAIR_CHUNK_ELEMS = 1 << 26
# contributions one int64 limb sum takes at the bound's size (2^63 / 2^40)
LIMB_TERMS_MAX = 1 << 23
TIERS = ("fp64", "f32")
PREF = 2.0 * math.pi ** 2.5
# Cramér: |H_n(x)| exp(-x^2/2) <= 1.0865 sqrt(2^n n!), cubed
R_CONST = 1.29
NBIN = 128   # binary-exponent bins of p, offset by NBIN // 2


def _nt(l):
    return len(tri_set(l)[0])


def _nf(l):
    return len(cart_components(l))


class PairJEngine:
    """Pair-algorithm J/K engine over a BasisLayout (reference:
    pyscf/jk_pair.py).

    Built on a ``JKEngine`` of the same device and cutoffs, whose shell
    classes, pair classes and Schwarz q it uses (q through kernel A on the
    card).  Runs on ``cuda`` unless ``device`` says otherwise.
    ``last_run[call]`` holds the tasks and primitive quartets per tier,
    the chunks, the host seconds of the screening and the host wall of
    the latest ``get_j`` / ``get_k``."""

    def __init__(self, layout: BasisLayout, device=None, cutoff_fp32=1e-13,
                 cutoff_fp64=1e-6):
        self.jk = JKEngine(layout, device=device, cutoff_fp32=cutoff_fp32,
                           cutoff_fp64=cutoff_fp64)
        self.device = self.jk.device
        self.layout = layout
        self.nao = layout.nao_int
        self._tabs = {}
        self.last_run: dict = {}

    # ------------------------------------------------------------ tables
    def _pair_tables(self, pci, tier):
        """Density-independent tables of one pair class in one tier (on
        the device, after the Schwarz sort of its pairs)."""
        key = (pci, tier)
        if key in self._tabs:
            return self._tabs[key]
        eng = self.jk
        pc = eng.pair_classes[pci]
        eng._ensure_q(pc)
        c1, c2 = eng.classes[pc.ci], eng.classes[pc.cj]
        tb1, tb2 = eng._tables(tier)[pc.ci], eng._tables(tier)[pc.cj]
        dev = self.device
        il = torch.as_tensor(pc.i_loc, dtype=torch.long, device=dev)
        jl = torch.as_tensor(pc.j_loc, dtype=torch.long, device=dev)
        pa = torch.as_tensor(np.repeat(np.arange(c1.nprim), c2.nprim),
                             device=dev)
        pb = torch.as_tensor(np.tile(np.arange(c2.nprim), c1.nprim),
                             device=dev)
        A = tb1["coord"][il][:, None, :]
        B = tb2["coord"][jl][:, None, :]
        a = tb1["exps"][il][:, pa]
        b = tb2["exps"][jl][:, pb]
        cc = tb1["coefs"][il][:, pa] * tb2["coefs"][jl][:, pb]
        pd = make_pair_data(A, B, a, b, cc)
        E = e_rows(c1.l, c2.l, e_table(c1.l, c2.l, 0.5 / pd["p"], pd["xpa"],
                                       pd["xpb"], pd["epref"]))
        ao_a, ao_b = tb1["ao"].long()[il], tb2["ao"].long()[jl]
        fa = torch.arange(_nf(c1.l), device=dev)
        fb = torch.arange(_nf(c2.l), device=dev)
        t = dict(l=(c1.l, c2.l), p=pd["p"], P=pd["P"], coef=cc, E=E,
                 ao_a=ao_a, ao_b=ao_b, npp=c1.nprim * c2.nprim,
                 NT=_nt(c1.l + c2.l),
                 # flat nao*nao index of every pair's AO block (P, nf_ab)
                 blk=((ao_a[:, None, None] + fa[:, None]) * self.nao
                      + ao_b[:, None, None] + fb).reshape(len(il), -1))
        self._tabs[key] = t
        return t

    # ------------------------------------------------------------- tasks
    def _cutoffs(self, dm_int):
        logdm = float(np.log(max(np.abs(dm_int).max(), 1e-30)))
        eng = self.jk
        return (logdm, np.log(eng.cutoff_fp32) - logdm,
                np.log(eng.cutoff_fp64) - logdm)

    def _prepare(self, dm_mol):
        """Checks, Schwarz q of every pair class, the screening cutoffs
        (logdm, log32, log64) and the flat internal density per tier."""
        check_fp32_matmul(self.device, "PairJEngine")
        for pc in self.jk.pair_classes:
            self.jk._ensure_q(pc)
        self._check_terms()
        dm_int = self.layout.dm_to_internal(np.asarray(dm_mol, np.float64))
        dm64 = torch.as_tensor(dm_int, dtype=torch.float64,
                               device=self.device).reshape(-1)
        return self._cutoffs(dm_int), {"fp64": dm64, "f32": dm64.float()}

    def task_sets(self, log32, log64, run=None):
        """Yield (p1i, p2i, tier, t1, t2, w, wj) over p2i <= p1i: the
        screened tasks of ``build_quartet_tasks`` split by tier (t1, t2
        pair indices, w its symmetry weights for K, wj the J weights:
        0.5 where the bra pair is the ket pair).  ``run``: a ``last_run``
        record whose ``screen_s`` gets the host seconds spent here."""
        pcs = self.jk.pair_classes
        for p1i in range(len(pcs)):
            for p2i in range(p1i + 1):
                t0 = time.perf_counter()
                same = p1i == p2i
                t1, t2, w, tier64 = build_quartet_tasks(
                    pcs[p1i], pcs[p2i], same, log32, log64)
                wj = np.where(same & (t1 == t2), 0.5, 1.0)
                sets = [(p1i, p2i, tier, t1[sel], t2[sel], w[sel], wj[sel])
                        for tier, sel in (("fp64", tier64), ("f32", ~tier64))
                        if sel.any()]
                if run is not None:
                    run["screen_s"] += time.perf_counter() - t0
                yield from sets

    @staticmethod
    def _chunk(tb, tk, with_k):
        """Tasks per chunk: the largest stacked intermediate (M, R, the
        Boys stack; for K also X, the gathered E rows and G) within
        PAIR_CHUNK_ELEMS elements, at most 2^21 tasks (the result does not
        depend on it)."""
        nb, nk, ntb, ntk = tb["npp"], tk["npp"], tb["NT"], tk["NT"]
        L = sum(tb["l"]) + sum(tk["l"])
        per = [nb * nk * ntb * ntk, nb * nk * _nt(L), nb * nk * (L + 1)]
        if with_k:
            nf12, nf34 = tb["E"].shape[2], tk["E"].shape[2]
            per += [nb * ntb * nf34, nb * nf12 * ntb, nk * nf34 * ntk,
                    nf12 * nf34]
        return max(1, min(1 << 21, PAIR_CHUNK_ELEMS // max(per)))

    @staticmethod
    def _upload(dev, *arrays):
        return [torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for a in arrays]

    # ----------------------------------------------------------- stage B
    def _coupling(self, tb, tk, i, j, w):
        """M (c, npp_b, npp_k, NT_b, NT_k) of a chunk: R_{t+u}(P - Q) times
        2 pi^{5/2} / (p q sqrt(p + q)) c_b c_k w, every combo at once."""
        lab, lcd = sum(tb["l"]), sum(tk["l"])
        L = lab + lcd
        pb, pk = tb["p"][i][:, :, None], tk["p"][j][:, None, :]
        psum = pb + pk
        ppq = pb * pk
        theta = ppq / psum
        PQ = tb["P"][i][:, :, None, :] - tk["P"][j][:, None, :, :]
        R = r_table(L, theta, PQ, boys(L, theta * (PQ * PQ).sum(-1)))
        pref = PREF / (ppq * torch.sqrt(psum))
        pref = pref * (tb["coef"][i][:, :, None] * tk["coef"][j][:, None, :])
        pref = pref * w.to(pref.dtype)[:, None, None]
        cidx = torch.as_tensor(coupling_index(lab, lcd), device=R.device)
        return R[..., cidx] * pref[..., None, None]

    def _class_pairs(self):
        """(p1i, p2i, tier) of every accumulation: p2i <= p1i."""
        n = len(self.jk.pair_classes)
        return [(p1i, p2i, tier) for p1i in range(n) for p2i in range(p1i + 1)
                for tier in TIERS]

    def _jh_bounds(self, tabs, D):
        """Exponent of every JH accumulator (module docstring), over every
        class pair whether it has tasks or not: one device-to-host copy
        for all of them."""
        dev = self.device
        stats = {}
        for key, t in tabs.items():
            p = t["p"].double().reshape(-1)
            b = (torch.frexp(p)[1].long() + NBIN // 2).clamp(0, NBIN - 1)
            c = t["coef"].double().abs().reshape(-1)
            s = c * D[key].double().abs().sum(-1).reshape(-1)

            def amax(v, init=0.0):
                out = torch.full((NBIN,), init, dtype=torch.float64,
                                 device=dev)
                return out.scatter_reduce(0, b, v, "amax")

            pmax = amax(p)
            pmin = -amax(-p, -np.inf)
            empty = pmax == 0
            stats[key] = (amax(c), amax(s), torch.where(empty, 1.0, pmin),
                          torch.where(empty, 1.0, pmax))
        bounds = {key: [] for key in tabs}
        for p1i, p2i, tier in self._class_pairs():
            kb, kk = (p1i, tier), (p2i, tier)
            cb, sb, bmin, bmax = stats[kb]
            ck, sk, kmin, kmax = stats[kk]
            L = sum(tabs[kb]["l"]) + sum(tabs[kk]["l"])
            qmin, qmax = kmin[None, :], kmax[None, :]
            g = PREF / (bmin[:, None] * qmin * torch.sqrt(bmin[:, None]
                                                          + qmin))
            th = bmax[:, None] * qmax / (bmax[:, None] + qmax)
            H = g * R_CONST * math.sqrt(math.factorial(L)) * torch.clamp(
                2.0 * th, min=1.0) ** (0.5 * L)
            bounds[kb].append(tabs[kk]["npp"]
                              * (cb[:, None] * H * sk[None, :]).amax())
            bounds[kk].append(tabs[kb]["npp"]
                              * (sb[:, None] * H * ck[None, :]).amax())
        keys = list(tabs)
        top = torch.stack([torch.stack(bounds[k]).amax() for k in keys])
        return {k: bound_exponent(2.0 * float(v))
                for k, v in zip(keys, top.cpu().tolist())}

    # --------------------------------------------------------------- J
    def get_j(self, dm_mol):
        """Coulomb matrix (mol AO basis) of one symmetric density."""
        t0 = time.perf_counter()
        nao, dev = self.nao, self.device
        (_, log32, log64), dms = self._prepare(dm_mol)
        pcs = self.jk.pair_classes

        # ---- stage A: Hermite densities
        tabs, D = {}, {}
        for pci, pc in enumerate(pcs):
            for tier in TIERS:
                t = tabs[(pci, tier)] = self._pair_tables(pci, tier)
                wpair = torch.as_tensor(np.where(pc.diag, 1.0, 2.0),
                                        dtype=t["E"].dtype, device=dev)
                dmv = dms[tier][t["blk"]] * wpair[:, None]
                D[(pci, tier)] = torch.einsum("pf,pkft->pkt", dmv, t["E"])
        e = self._jh_bounds(tabs, D)
        JH = {k: torch.zeros((t["p"].numel() * t["NT"] + 1, NLIMB),
                             dtype=torch.int64, device=dev)
              for k, t in tabs.items()}

        # ---- stage B: both directions of every screened task
        run = self._new_run()
        for p1i, p2i, tier, t1, t2, _, wj in self.task_sets(log32, log64,
                                                             run):
            kb, kk = (p1i, tier), (p2i, tier)
            tb, tk = tabs[kb], tabs[kk]
            ntb, ntk = tb["NT"], tk["NT"]
            sgn = torch.as_tensor(ket_signs(sum(tk["l"])),
                                  dtype=tb["E"].dtype, device=dev)
            Dks, Db = D[kk] * sgn, D[kb]
            ab = torch.arange(tb["npp"] * ntb, device=dev)
            ak = torch.arange(tk["npp"] * ntk, device=dev)
            T1, T2, W = self._upload(dev, t1, t2, wj.astype(np.float32))
            B = self._chunk(tb, tk, False)
            self._count(run, tier, len(t1), tb["npp"] * tk["npp"], B)
            for s in range(0, len(t1), B):
                i, j = T1[s:s + B], T2[s:s + B]
                M = self._coupling(tb, tk, i, j, W[s:s + B])
                fwd = torch.einsum("cbktu,cku->cbt", M, Dks[j])
                rev = torch.einsum("cbktu,cbt->cku", M, Db[i]) * sgn
                add_limbs_(JH[kb], fwd, i[:, None] * ab.numel() + ab,
                           e[kb])
                add_limbs_(JH[kk], rev, j[:, None] * ak.numel() + ak,
                           e[kk])

        # ---- stage C: E rows of the bra, AO blocks
        vals, idx = [], []
        for (pci, tier), acc in JH.items():
            t = tabs[(pci, tier)]
            jh = limbs_to_f64(acc[:-1], e[(pci, tier)]).to(t["E"].dtype)
            blk = torch.einsum("pkft,pkt->pf", t["E"],
                               jh.view(*t["p"].shape, t["NT"]))
            wd = torch.as_tensor(np.where(pcs[pci].diag, 0.5, 1.0),
                                 dtype=blk.dtype, device=dev)
            vals.append((blk * wd[:, None]).reshape(-1))
            idx.append(t["blk"].reshape(-1))
        limbs, ev = scatter_limbs(torch.cat([v.double() for v in vals]),
                                  torch.cat(idx), nao * nao)
        vj = limbs_to_f64(limbs, ev).view(nao, nao).cpu().numpy()
        self._done(run, "get_j", t0)
        return self.layout.mat_to_mol(vj + vj.T)

    # --------------------------------------------------------------- K
    def get_k(self, dm_mol):
        """Exchange matrix (mol AO basis) of one symmetric density: the
        quartet engine's screening, tiers and symmetry weights, each
        task's ERI block as sum_combos E_bra · M · E_ketᵀ."""
        t0 = time.perf_counter()
        eng, nao, dev = self.jk, self.nao, self.device
        (logdm, log32, log64), dms = self._prepare(dm_mol)
        pcs = eng.pair_classes
        # the quartet engine's static bound (jk_contracted._build_plan),
        # over every class pair
        e = 0
        for p1i, p2i, _ in self._class_pairs():
            nf = [_nf(eng.classes[c].l) for c in
                  (pcs[p1i].ci, pcs[p1i].cj, pcs[p2i].ci, pcs[p2i].cj)]
            nf_sum = max(nf[0] * nf[1], nf[2] * nf[3], nf[0] * nf[2],
                         nf[0] * nf[3], nf[1] * nf[2], nf[1] * nf[3])
            qmax = float(pcs[p1i].q_log.max() + pcs[p2i].q_log.max())
            e = max(e, bound_exponent(np.exp(min(
                qmax + logdm + np.log(2.0 * nf_sum) + 0.5, 80.0))))
        acc = torch.zeros((nao * nao + 1, NLIMB), dtype=torch.int64,
                          device=dev)
        run = self._new_run()
        for p1i, p2i, tier, t1, t2, w, _ in self.task_sets(log32, log64,
                                                            run):
            tb, tk = self._pair_tables(p1i, tier), self._pair_tables(p2i, tier)
            sgn = torch.as_tensor(ket_signs(sum(tk["l"])),
                                  dtype=tb["E"].dtype, device=dev)
            nfs = (_nf(tb["l"][0]), _nf(tb["l"][1]), _nf(tk["l"][0]),
                   _nf(tk["l"][1]))
            T1, T2, W = self._upload(dev, t1, t2, w.astype(np.float32))
            B = self._chunk(tb, tk, True)
            self._count(run, tier, len(t1), tb["npp"] * tk["npp"], B)
            for s in range(0, len(t1), B):
                i, j = T1[s:s + B], T2[s:s + B]
                M = self._coupling(tb, tk, i, j, W[s:s + B]) * sgn
                X = torch.einsum("cbktu,ckgu->cbtg", M, tk["E"][j])
                G = torch.einsum("cbft,cbtg->cfg", tb["E"][i], X)
                aos = (tb["ao_a"][i], tb["ao_b"][i], tk["ao_a"][j],
                       tk["ao_b"][j])
                _, ks = _contract_blocks(G, aos, nfs, dms[tier], nao,
                                         False, True)
                for _, v, vidx in ks:
                    add_limbs_(acc, v, vidx, e)
        vk = limbs_to_f64(acc[:-1], e).view(nao, nao).cpu().numpy()
        self._done(run, "get_k", t0)
        return self.layout.mat_to_mol(vk + vk.T)

    def get_jk(self, dm_mol):
        """(vj, vk) through the pair algorithm (reference:
        jqc/pyscf/jk_pair.py generate_jk_kernel)."""
        return self.get_j(dm_mol), self.get_k(dm_mol)

    # ------------------------------------------------------- bookkeeping
    def _check_terms(self):
        """Raise before an int64 limb sum could overflow: a JH element
        takes one contribution per partner pair and direction (at most
        twice the shell-segment pairs), a vk element at most four per
        shell-segment pair for each pair of segments sharing its AOs."""
        ids = np.concatenate([c.shell_ids for c in self.jk.classes])
        nseg = len(ids)
        smax = int(np.bincount(ids[ids >= 0]).max(initial=1))
        worst = 4 * smax * smax * nseg * nseg
        if worst >= LIMB_TERMS_MAX:
            raise ValueError(
                f"PairJEngine: up to {worst} contributions per accumulator "
                f"element, beyond the int64 limbs' {LIMB_TERMS_MAX}")

    @staticmethod
    def _new_run():
        return dict(tasks=dict.fromkeys(TIERS, 0),
                    quartets=dict.fromkeys(TIERS, 0), chunks=0, screen_s=0.0)

    @staticmethod
    def _count(run, tier, n, npp, B):
        run["tasks"][tier] += n
        run["quartets"][tier] += n * npp
        run["chunks"] += -(-n // B)

    def _done(self, run, call, t0):
        run["wall_s"] = time.perf_counter() - t0
        self.last_run[call] = run


# Reference naming: the pair engine provides both vj and vk
# (jqc/backend/jk_pair.py gen_vj_kernel/gen_vk_kernel).
PairJKEngine = PairJEngine

__all__ = ["PairJEngine", "PairJKEngine"]
