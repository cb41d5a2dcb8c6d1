#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (joltqc_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed with its result and wall time on its own line:
  1. build      nvcc builds every kernel (csrc/*.cu, all at once); the
                card's name and power limit from nvidia-smi;
  2. eri        kernel A (csrc/eri.cu) against its plain PyTorch version
                on the card, both tiers and omega > 0;
  3. accum      kernel B (csrc/accum_tile.cu) against its plain version;
                bit-identical limbs across runs and task permutations;
  4. anchors    RHF H2O/sto-3g and H2O/6-31g against their energies;
  5. full       RHF 0029-elongated-halogenated/6-31g* (302 AO) to
                convergence against its recorded energy, with every
                kernel launch counted; get_jk twice on the converged
                density must be bit-identical; then every kernel template
                the plan launches is held against its plain version on a
                chunk of that path, and each kernel and its plain version
                are timed at the shapes of that path;
  6. a "kernels" JSON line; the last line is the device JSON.
Any failed phase makes the script exit nonzero.  Options: --only PHASES
(comma list, for debugging: build,eri,accum,anchors,full).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H2O = """O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000"""
E_STO3G = -74.9630631297
E_631G = -75.9839484981
XYZ_0029 = os.path.join(HERE, "benchmarks", "molecules",
                        "0029-elongated-halogenated.xyz")
E_0029 = -1402.5884858139

# peak rates of one H100 SXM at 700 W (NVIDIA data sheet): HBM bytes/s,
# and FLOP/s for fp32 outside the tensor cores and fp64 (tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "fp64": 67e12}

ERI_CASES = [  # (ls, nprims)
    ((0, 0, 0, 0), (3, 3, 3, 3)),
    ((1, 0, 1, 0), (2, 1, 2, 1)),
    ((1, 1, 1, 1), (1, 3, 1, 1)),
    ((2, 1, 1, 0), (1, 1, 3, 1)),
    ((2, 2, 2, 2), (1, 1, 1, 1)),
    ((3, 2, 1, 0), (1, 1, 1, 1)),
    ((4, 2, 1, 0), (1, 1, 1, 1)),
]
ERI_TOL = {"f32": 2e-5, "fp64": 1e-12}  # of the block's max |value|
ACC_TOL = {"f32": 1e-6, "fp64": 1e-13}  # of the static bound 2^e


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def say(line):
    print(line, flush=True)


# ------------------------------------------------------------- timing
def cuda_ms(fn, reps=5, warm=1):
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ------------------------------------------------------------ phase 1
def phase_build(ctx):
    from joltqc_tpu_torch.ops import cuda

    logs = cuda.build_all(verbose=True)
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                say(f"  ptxas {name}: {ln.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    return f"built {sorted(logs) or 'cached'}; card {smi}"


# ------------------------------------------------------------ phase 2
def _rand_quartet(nprims, T, tier, seed, dev):
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops.eri import tier_dtype

    rng = np.random.default_rng(seed)
    dt = tier_dtype(tier)
    q = {}
    for x, npx in zip("abcd", nprims):
        q[f"coord_{x}"] = rng.standard_normal((T, 3))
        q[f"exps_{x}"] = rng.uniform(0.3, 3.0, (T, npx))
        q[f"coefs_{x}"] = rng.standard_normal((T, npx))
    return {k: torch.as_tensor(v, dtype=dt, device=dev) for k, v in q.items()}


def phase_eri(ctx):
    import torch
    from joltqc_tpu_torch.ops.eri import eri_chunk
    from joltqc_tpu_torch.ops.md import eri_plain

    dev = torch.device("cuda")
    worst = {"f32": 0.0, "fp64": 0.0}
    cases = [(ls, npr, 0.0) for ls, npr in ERI_CASES]
    cases.append(((1, 0, 1, 0), (2, 1, 2, 1), 0.33))
    cases.append(((2, 1, 1, 0), (1, 1, 3, 1), 0.2))
    for tier in ("f32", "fp64"):
        for ls, nprims, omega in cases:
            T = 256
            q = _rand_quartet(nprims, T, tier, seed=sum(ls) + 7, dev=dev)
            got = eri_chunk(tier, ls, nprims, q, omega)
            ref = eri_plain(ls, nprims, q, omega)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max() / ref.abs().max())
            worst[tier] = max(worst[tier], err)
            check(torch.isfinite(got).all(), f"eri {tier} {ls}: non-finite")
            check(err < ERI_TOL[tier],
                  f"eri {tier} {ls} omega={omega}: rel err {err:.3e}")
    # engine form: per-class tables + int32 row indices, gathered inside
    ls, nprims = (2, 1, 1, 0), (1, 1, 3, 1)
    tab = _rand_quartet(nprims, 50, "fp64", seed=3, dev=dev)
    idx = torch.randint(0, 50, (4, 4096), generator=torch.Generator(
        device="cpu").manual_seed(5)).to(torch.int32).to(dev)
    got = eri_chunk("fp64", ls, nprims, tab, 0.0, idx=tuple(idx))
    gq = {f"{n}_{x}": tab[f"{n}_{x}"][idx[k].long()]
          for k, x in enumerate("abcd") for n in ("coord", "exps", "coefs")}
    ref = eri_plain(ls, nprims, gq, 0.0)
    err = float((got - ref).abs().max() / ref.abs().max())
    check(err < ERI_TOL["fp64"], f"eri indexed form: rel err {err:.3e}")
    worst["fp64"] = max(worst["fp64"], err)
    return (f"{len(cases)} cases x 2 tiers + indexed form; max rel err "
            f"f32 {worst['f32']:.3e} (tol 2e-5) fp64 {worst['fp64']:.3e} "
            f"(tol 1e-12)")


# ------------------------------------------------------------ phase 3
def phase_accum(ctx):
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops.accum_tile import (
        _supertile, accum_tile_plain, fused_contract_tile, tile_limbs_to_f64,
    )
    from joltqc_tpu_torch.ops.eri import tier_dtype

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    W = 64
    worst = 0.0
    for tier, T, nfxy, nfo in (("fp64", 8192, 9, 36), ("fp64", 4096, 36, 36),
                               ("f32", 8192, 6, 9)):
        dt, tol = tier_dtype(tier), ACC_TOL[tier]
        G = rng.standard_normal((T, nfxy, nfo)) * np.exp(
            rng.uniform(-10, 0, (T, 1, 1)))
        d = rng.standard_normal((T, nfo))
        lx = rng.integers(0, W, T).astype(np.int32)
        ly = rng.integers(0, W, T).astype(np.int32)
        bound = float(np.abs(G).max() * np.abs(d).max() * nfo * 2)
        Gt = torch.as_tensor(G, dtype=dt, device=dev)
        dtt = torch.as_tensor(d, dtype=dt, device=dev)
        lxt = torch.as_tensor(lx, device=dev)
        lyt = torch.as_tensor(ly, device=dev)
        limbs, e = fused_contract_tile(Gt, dtt, lxt, lyt, W, W, bound)
        got = tile_limbs_to_f64(limbs, e)
        limbs_p, _ = _supertile(accum_tile_plain, Gt, dtt, lxt, lyt, W, W,
                                bound)
        want = tile_limbs_to_f64(limbs_p, e)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) / bound
        worst = max(worst, err if tier == "fp64" else 0.0)
        check(err < tol, f"accum {tier} nfxy={nfxy}: err/bound {err:.3e}")
        # bit-identical limbs: a second run, and permuted tasks
        limbs2, _ = fused_contract_tile(Gt, dtt, lxt, lyt, W, W, bound)
        perm = torch.as_tensor(rng.permutation(T), device=dev)
        limbs3, _ = fused_contract_tile(Gt[perm].contiguous(),
                                        dtt[perm].contiguous(), lxt[perm],
                                        lyt[perm], W, W, bound)
        check(torch.equal(limbs, limbs2), "accum: runs differ")
        check(torch.equal(limbs, limbs3), "accum: permutation changes bits")
    return (f"max |kernel - plain| / bound {worst:.3e} (fp64, tol 1e-13); "
            "repeat and permuted runs bit-identical")


# ------------------------------------------------------------ phase 4
def phase_anchors(ctx):
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.scf import RHF

    out = []
    for basis, ref, tol in (("sto-3g", E_STO3G, 1e-7),
                            ("6-31g", E_631G, 1e-6)):
        mol = Molecule.from_atom_string(H2O, basis=basis)
        mf = RHF(mol, conv_tol=1e-11)
        e = mf.kernel()
        check(mf.converged, f"H2O/{basis}: not converged")
        check(abs(e - ref) < tol,
              f"H2O/{basis}: E {e:.10f} vs {ref} (|dE| {abs(e - ref):.2e})")
        out.append(f"H2O/{basis} E={e:.10f} |dE|={abs(e - ref):.1e}")
    return "; ".join(out)


# ------------------------------------------------------------ phase 5
def phase_full(ctx):
    import numpy as np
    import torch
    from joltqc_tpu_torch import native
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.ops.accum_tile import accum_tile_chunk as acc_k
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.scf import RHF

    # the plan-build time below is the C++ screen's, never numpy's
    check(native.get_lib() is not None, "native screen did not build")
    mol = Molecule.from_xyz_file(XYZ_0029, basis="6-31g*")
    check(mol.nao == 302, f"0029: nao {mol.nao}, want 302")
    mf = RHF(mol, verbose=1)
    eri_k.launches = 0
    acc_k.launches = 0
    t0 = time.perf_counter()
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ctx["launches"] = {"eri": eri_k.launches, "accum_tile": acc_k.launches}
    s = mf.scf_summary
    st = mf.jk.plan_stats
    tm = mf.jk.timing
    say(f"  0029: E={e:.10f} |dE|={abs(e - E_0029):.2e} cycles={s['cycles']} "
        f"converged={mf.converged} scf_wall_s={wall:.2f} "
        f"int1e_s={s['int1e_time']:.2f} screen=native plan_build_s="
        f"{tm.get('plan_build_s', 0.0):.2f} plan_builds="
        f"{tm.get('plan_builds', 0)} jk_s_per_iter="
        f"{s['jk_time'] / s['cycles']:.3f} tasks={st['ntasks']} "
        f"tasks_fp64={st['n64']} launches={ctx['launches']}")
    check(mf.converged, "0029: SCF not converged")
    check(abs(e - E_0029) < 1e-6, f"0029: E {e:.10f} vs {E_0029}")
    check(eri_k.launches > 0 and acc_k.launches > 0, "0029: a kernel was "
          "not launched on the main path")
    # determinism of the Fock build on the converged density
    dm = mf.dm
    eri_k.launches = acc_k.launches = 0
    t1 = time.perf_counter()
    j1, k1 = mf.jk.get_jk(dm)
    torch.cuda.synchronize()
    jk_wall = time.perf_counter() - t1
    ctx["launches_per_jk"] = {"eri": eri_k.launches,
                              "accum_tile": acc_k.launches}
    j2, k2 = mf.jk.get_jk(dm)
    check(np.isfinite(j1).all() and np.isfinite(k1).all(), "0029: J/K NaN")
    check(np.array_equal(j1, j2) and np.array_equal(k1, k2),
          "0029: repeated get_jk differs")
    ctx["jk_wall"] = jk_wall
    _profile_jk(ctx, mf, dm)
    _fock_bounds(mf.jk)
    _time_kernels(ctx, mf)
    return (f"E={e:.10f} (ref {E_0029}, |dE| {abs(e - E_0029):.2e}); "
            f"get_jk on converged dm {jk_wall:.3f} s, twice bit-identical, "
            f"launches per get_jk {ctx['launches_per_jk']}")


def _profile_jk(ctx, mf, dm):
    """Device time by kernel over one get_jk (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mf.jk.get_jk(dm)
        torch.cuda.synchronize()
    rows = []
    dev_total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, ev.key, ev.count))
            dev_total += us
    rows.sort(reverse=True)
    if not rows:
        say("  profile: no device time recorded (not measured)")
        return
    for us, key, n in rows[:6]:
        say(f"  profile get_jk: {us / 1e3:10.3f} ms  x{n:<5d} {key[:70]}")
    say(f"  profile get_jk: device busy {dev_total / 1e3:.3f} ms of "
        f"{ctx['jk_wall'] * 1e3:.3f} ms wall")


def _fock_bounds(eng):
    """Least time of one get_jk's kernels on this plan: ERI operations
    (nonzero primitive quartets of every task) and bytes of both kernels,
    against the card's peaks."""
    import numpy as np
    from joltqc_tpu_torch.scf.jk_contracted import STREAMS

    t_eri = t_acc = 0.0
    for e in eng._plan:
        es = 4 if e["tier"] == "f32" else 8
        nfs = [(l + 1) * (l + 2) // 2 for l in e["ls"]]
        npq = np.ones(e["ntasks"])
        for k, ci in enumerate(e["cls_idx"]):
            nz = (eng.classes[ci].coefs != 0).sum(1)
            npq = npq * nz[e["idx"][k]]
        flops = float(npq.sum()) * _eri_flops(e["ls"])
        nfel = int(np.prod(nfs))
        t_eri += max(flops / PEAK_FLOPS[e["tier"]],
                     e["ntasks"] * (16 + nfel * es) / PEAK_BYTES)
        for _, xi, yi, ui, vi, _ in STREAMS:
            nfo = nfs[ui] * nfs[vi]
            t_acc += e["ntasks"] * (nfel * es + nfo * es + 20) / PEAK_BYTES
    say(f"  bound get_jk: eri {t_eri * 1e3:.5g} ms, accum_tile "
        f"{t_acc * 1e3:.5g} ms (accumulator writes not counted)")


def _eri_flops(ls):
    """FP operations of csrc/eri.cu per primitive quartet: R recursion,
    E tables and the ket-then-bra assembly (Boys and pair data left out,
    so the bound stays a lower bound)."""
    from joltqc_tpu_torch.ops.harmonics import cart_components

    la, lb, lc, ld = ls
    L = sum(ls)
    lab = la + lb
    nr = 0
    for m in range(L - 1, -1, -1):
        for s in range(1, L - m + 1):
            nr += (s + 1) * (s + 2) // 2 * 3
    ne = 0
    for li, lj in ((la, lb), (lc, ld)):
        for i in range(li):
            ne += 3 * 5 * (i + 2)
        for j in range(lj):
            for i in range(li + 1):
                ne += 3 * 5 * (i + j + 2)
    ntab = [(t, u, s - t - u) for s in range(lab + 1) for t in range(s + 1)
            for u in range(s - t + 1)]
    nasm = 0
    for c in cart_components(lc):
        for d in cart_components(ld):
            ket = (c[0] + d[0] + 1) * (c[1] + d[1] + 1) * (c[2] + d[2] + 1)
            nasm += len(ntab) * 2 * ket
            for a in cart_components(la):
                for b in cart_components(lb):
                    nasm += 2 * ((a[0] + b[0] + 1) * (a[1] + b[1] + 1)
                                 * (a[2] + b[2] + 1)) + 2
    # FMA-counted (2 per multiply-add), so the bound stays a lower bound
    return nr + ne + nasm


def _first_chunk(eng, entry):
    """The first launch's inputs of a plan entry, as ``_run_plan`` makes
    them: class tables, the quartet, row indices and weights."""
    tbls = [eng._tables(entry["tier"])[k] for k in entry["cls_idx"]]
    idx_all, w_all = eng._entry_dev(entry)
    B = eng._chunk(entry["ls"])
    idx = tuple(idx_all[k, :B].contiguous() for k in range(4))
    return tbls, eng._quartet(tbls), idx, w_all[:B].contiguous()


def _gathered(quartet, idx):
    return {f"{n}_{x}": quartet[f"{n}_{x}"][idx[k].long()]
            for k, x in enumerate("abcd") for n in ("coord", "exps", "coefs")}


def _nfel(entry):
    return math.prod((l + 1) * (l + 2) // 2 for l in entry["ls"])


def _accum_args(eng, entry, s, G, tbls, idx, w, dm):
    """Arguments of ``accum_tile_chunk`` for stream s, less acc and e."""
    from joltqc_tpu_torch.scf.jk_contracted import STREAMS

    _, xi, yi, ui, vi, _ = STREAMS[s]
    return (G, eng._stream_tables(entry["ls"], s), dm, eng.nao,
            (idx[ui], tbls[ui]["ao"]), (idx[vi], tbls[vi]["ao"]),
            (idx[xi], tbls[xi]["erow"]), (idx[yi], tbls[yi]["erow"]), w)


def _check_templates(mf):
    """Hold every kernel template the plan launches (eri_kernel<float |
    double, LM = 1 | 2 | 4>, accum_tile_kernel<float | double>) against
    its plain version, at the main path's shapes: the first chunk of the
    template's largest entry (real tables, indexed ERI form,
    component-major G, every stream into the E-space accumulator).
    Returns the max absolute error of each kernel."""
    import torch
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.ops.eri import eri_chunk, tier_dtype
    from joltqc_tpu_torch.ops.md import eri_plain
    from joltqc_tpu_torch.scf.jk_contracted import STREAMS

    eng = mf.jk
    picks = {}
    for entry in eng._plan:
        lm = max(entry["ls"])
        key = (entry["tier"], 1 if lm <= 1 else 2 if lm == 2 else 4)
        if entry["ntasks"] and (key not in picks or entry["ntasks"]
                                * _nfel(entry) > picks[key]["ntasks"]
                                * _nfel(picks[key])):
            picks[key] = entry
    dm = eng.layout.dm_to_internal(mf.dm)
    _, E = eng._espace()
    a1, a2 = (torch.zeros((E, E, at.NLIMB), dtype=torch.int64,
                          device=eng.device) for _ in range(2))
    worst = {"eri": 0.0, "accum_tile": 0.0}
    for (tier, lm), entry in sorted(picks.items()):
        ls, nprims = entry["ls"], entry["nprims"]
        tbls, quartet, idx, w = _first_chunk(eng, entry)
        G = eri_chunk(tier, ls, nprims, quartet, 0.0, idx=idx)
        Gp = eri_plain(ls, nprims, _gathered(quartet, idx), 0.0)
        err_a = float((G - Gp).abs().max())
        rel_a = err_a / max(float(Gp.abs().max()), 1e-300)
        check(bool(torch.isfinite(G).all()), f"eri {tier} {ls}: non-finite")
        check(rel_a < ERI_TOL[tier], f"eri {tier} LM={lm} {ls} at the main "
              f"path's shapes: rel err {rel_a:.3e}")
        dmt = torch.as_tensor(dm, dtype=tier_dtype(tier),
                              device=eng.device).contiguous()
        e = at.bound_exponent(entry["bound"])
        err_b = 0.0
        for s in range(len(STREAMS)):
            args = _accum_args(eng, entry, s, G, tbls, idx, w, dmt)
            at.accum_tile_chunk(*args, a1.zero_(), e)
            at.accum_tile_plain(*args, a2.zero_(), e)
            err_b = max(err_b, float((at.limbs_to_f64(a1, e)
                                      - at.limbs_to_f64(a2, e)).abs().max()))
        check(err_b < ACC_TOL[tier] * 2.0 ** e, f"accum_tile {tier} {ls} at "
              f"the main path's shapes: err {err_b:.3e} vs 2^{e}")
        say(f"  check {tier} LM={lm}: class {ls} nprims {nprims} "
            f"T={idx[0].shape[0]}: eri rel err {rel_a:.3e} (tol "
            f"{ERI_TOL[tier]:g}); accum_tile {len(STREAMS)} streams err / "
            f"2^e {err_b * 2.0 ** -e:.3e} (tol {ACC_TOL[tier]:g})")
        worst["eri"] = max(worst["eri"], err_a)
        worst["accum_tile"] = max(worst["accum_tile"], err_b)
    return worst


def _time_kernels(ctx, mf):
    """Kernel vs plain version timed at the main path's shapes: the first
    chunk of the plan entry with the most ERI elements."""
    import torch
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.ops.eri import eri_chunk, tier_dtype
    from joltqc_tpu_torch.ops.md import eri_plain
    from joltqc_tpu_torch.scf.jk_contracted import STREAMS

    worst = _check_templates(mf)
    eng = mf.jk
    entry = max(eng._plan, key=lambda e: e["ntasks"] * _nfel(e))
    tier, ls, nprims = entry["tier"], entry["ls"], entry["nprims"]
    tbls, quartet, idx, w = _first_chunk(eng, entry)
    T = idx[0].shape[0]
    es = torch.tensor([], dtype=tier_dtype(tier)).element_size()

    # ---- kernel A
    ms_a = cuda_ms(lambda: eri_chunk(tier, ls, nprims, quartet, 0.0,
                                     idx=idx))
    gq = _gathered(quartet, idx)
    plain_a = cuda_ms(lambda: eri_plain(ls, nprims, gq, 0.0), reps=2)
    G = eri_chunk(tier, ls, nprims, quartet, 0.0, idx=idx)
    # nonzero primitive quartets of this chunk's data
    nz = None
    for k, x in enumerate("abcd"):
        c = (quartet[f"coefs_{x}"][idx[k].long()] != 0)
        nz = c.sum(1).double() if nz is None else nz * c.sum(1).double()
    npq = float(nz.sum())
    flops_a = npq * _eri_flops(ls)
    nfab = G.shape[1] * G.shape[2]
    bytes_a = T * (16 + nfab * es)
    bound_a = max(flops_a / PEAK_FLOPS[tier], bytes_a / PEAK_BYTES) * 1e3
    ctx["kern_a"] = dict(
        name="eri_chunk", route="cuda", source="joltqc_tpu_torch/csrc/eri.cu",
        replaces="joltqc_tpu/ops/eri_pallas.py:291",
        launches=ctx["launches"]["eri"],
        max_abs_err=worst["eri"], ms=ms_a, plain_ms=plain_a,
        bound_ms=bound_a,
        bound_by="operations" if flops_a / PEAK_FLOPS[tier]
        > bytes_a / PEAK_BYTES else "bytes",
        library_ms=None,
    )
    say(f"  time eri: class {ls} nprims {nprims} {tier} T={T}: kernel "
        f"{ms_a:.3f} ms, plain {plain_a:.3f} ms, bound {bound_a:.4f} ms "
        f"({flops_a:.3e} flop, {bytes_a:.3e} B)")

    # ---- kernel B: the K stream ac of the same chunk
    s = 2
    kind, xi, yi, ui, vi, _ = STREAMS[s]
    dm = torch.as_tensor(
        eng.layout.dm_to_internal(mf.dm), dtype=tier_dtype(tier),
        device=eng.device).contiguous()
    args = _accum_args(eng, entry, s, G, tbls, idx, w, dm)
    tabs = args[1]
    _, E = eng._espace()
    e = at.bound_exponent(entry["bound"])
    accs = [torch.zeros((E, E, at.NLIMB), dtype=torch.int64,
                        device=eng.device) for _ in range(2)]
    ms_b = cuda_ms(lambda: at.accum_tile_chunk(*args, accs[0], e))
    plain_b = cuda_ms(lambda: at.accum_tile_plain(*args, accs[1], e))
    # yardstick: one index_add_ of the already-contracted values
    nfxy, nfo = tabs.nfxy, tabs.nfo
    g = G.reshape(T, -1)[:, tabs.gidx.long()]
    base = (tbls[ui]["ao"][idx[ui].long()].long() * eng.nao
            + tbls[vi]["ao"][idx[vi].long()].long())
    dd = dm.reshape(-1)[base[:, None] + tabs.doff.long()[None, :]]
    v = (g * dd[:, None, :]).sum(-1).double().reshape(-1)
    rows = tbls[xi]["erow"][idx[xi].long()].long()[:, None] + tabs.roff.long()
    cols = tbls[yi]["erow"][idx[yi].long()].long()[:, None] + tabs.coff.long()
    flat = (rows * E + cols).reshape(-1)
    acc64 = torch.zeros(E * E, dtype=torch.float64, device=eng.device)
    lib_b = cuda_ms(lambda: acc64.index_add_(0, flat, v))
    ntgt = int(torch.unique(flat).numel())
    bytes_b = T * (nfxy * nfo * es + nfo * es + 16 + 4) + ntgt * 24
    flops_b = 2.0 * T * nfxy * nfo
    bound_b = max(bytes_b / PEAK_BYTES, flops_b / PEAK_FLOPS[tier]) * 1e3
    ctx["kern_b"] = dict(
        name="accum_tile_chunk", route="cuda",
        source="joltqc_tpu_torch/csrc/accum_tile.cu",
        replaces="joltqc_tpu/ops/accum_tile.py:367",
        launches=ctx["launches"]["accum_tile"],
        max_abs_err=worst["accum_tile"], ms=ms_b, plain_ms=plain_b,
        bound_ms=bound_b,
        bound_by="bytes" if bytes_b / PEAK_BYTES
        >= flops_b / PEAK_FLOPS[tier] else "operations",
        library_ms=lib_b,
    )
    say(f"  time accum_tile: stream {kind}{'abcd'[xi]}{'abcd'[yi]} T={T} "
        f"nfxy={nfxy} nfo={nfo}: kernel {ms_b:.3f} ms, plain {plain_b:.3f} "
        f"ms, index_add_ {lib_b:.3f} ms, bound {bound_b:.4f} ms "
        f"({bytes_b:.3e} B, {ntgt} targets)")


# --------------------------------------------------------------- main
PHASES = (("build", phase_build), ("eri", phase_eri), ("accum", phase_accum),
          ("anchors", phase_anchors), ("full", phase_full))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of phases (debugging)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import joltqc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = set(args.only.split(",")) if args.only else None
    ctx = {}
    ok = True
    for name, fn in PHASES:
        if want is not None and name not in want and name != "build":
            continue
        t0 = time.perf_counter()
        try:
            msg = fn(ctx)
            say(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) {msg}")
        except Exception as e:  # report the phase, then fail the run
            import traceback

            traceback.print_exc()
            say(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s) "
                f"{type(e).__name__}: {e}")
            ok = False
            if name == "build":
                break
    if not ok:
        return 1
    if want is None:
        say(ctx["smi"])
        say(json.dumps({"kernels": [ctx["kern_a"], ctx["kern_b"]]}))
    else:
        say(ctx.get("smi", ""))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
