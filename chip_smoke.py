#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (joltqc_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed with its result and wall time on its own line:
  1. build      nvcc builds every kernel library (one per csrc/*.cu,
                csrc/eri_class.cu once per class group; all at once),
                with each library's seconds and each kernel's registers
                and spills; the card's name and power limit from
                nvidia-smi;
  2. eri        kernel A against its plain PyTorch version on the card:
                every specialised class (csrc/eri_class.cu) in both
                tiers, omega > 0, and the generic route (csrc/eri.cu),
                whose launches the route counter must count exactly;
  3. accum      kernels B and C (csrc/accum_tile.cu) and D
                (csrc/accum_block.cu) against their plain versions;
                bit-identical limbs across runs and task permutations;
                B, C and D where their shared windows are stressed (one
                target, all distinct, runs, random order over many
                windows, keys or tasks outside, the engine's order), C
                and D bit for bit;
  4. anchors    RHF H2O/sto-3g and H2O/6-31g against their energies;
                H2O/sto-3g get_jk in the three accumulation modes with
                omega, hermi=0 and a stack against the dense oracle;
                incremental RHF against the direct energy;
  5. full       RHF 0029-elongated-halogenated/6-31g* (302 AO) to
                convergence against its recorded energy, with every
                kernel launch counted and none of kernel A's on the
                generic route; get_jk twice on the converged density must
                be bit-identical; kernel A's device time over one get_jk
                by class; then every (tier, class) the plan launches, with
                kernel B on each one's G, is held against its plain
                version on a chunk of that path, and each kernel and its
                plain version are timed at the shapes of that path
                (kernel B on K stream ac and J stream ab);
  6. engine     the plan and Schwarz-q disk caches, profiling and the
                autotune table at the same 302 AO, in its own empty cache
                directory with the cache on and every build saved: a
                cold RHF of the SCF's first ENGINE_CYCLES cycles (builds,
                saves, bytes on disk, kernel A's launches), the same in a
                fresh RHF and engine (0 builds, as many loads as the cold
                run's builds, q from disk with no kernel A launch, the
                same energy, density and get_jk to the bit); then on the
                converged density of phase full: get_jk with
                profile=True (the same bits, class_time by (ls, nprims,
                tier) against the call's wall), accum='auto' on the
                committed table against a tile engine (bit-identical
                where every class runs as tile, else MODE_TOL['tile']), a
                bounded tune_workload into the phase's directory and
                'auto' on the table it wrote;
  7. modes      at the same 302 AO, on the converged density: get_jk of a
                scatter and a block engine against the tile path's, with
                kernel D's launches counted; hermi=0, omega and a stack;
                kernels C and D held against their plain versions and
                timed on chunks of that path; incremental RHF against the
                direct run;
  8. dft        restricted Kohn-Sham on the card (its Fock builds through
                kernels A and B): H2O/6-31g lda,vwn, pbe, b3lyp and
                wb97x-v (VV10 off) against a float64 host oracle SCF
                (intor_np, numint_np) to 1e-8 Eh; wb97x-v with VV10 on a
                shared grid and on nlcgrids=True, the VV10 energy against
                nlc_exc_vxc_np; two waters, pbe, incremental with
                screening and the float64 tier engaged; 0029 B3LYP/6-31g*
                with the default grid and cutoffs (the grid built in a
                worker process meanwhile): convergence, kernels A and B
                launched, the grid's electron count, Exc and Vxc of the
                mixed path against a plain float64 evaluation on the
                card, and the device time of rho, xc and vxc;
  9. ecp        effective core potentials on the card (scf/ecp.py, no
                fallback): (1) H2, O-H and Na2 (the Na 10-core ECP, every
                channel ul + S..G): build, gradient, build_ip and both
                build_ipip against the same engine on the CPU (1e-12
                of max(1, max |value|)),
                build against the port's ecp_np (5e-11); (2) NaH/sto-3g
                with the shipped jqc-model against the JAX package's
                anchor (5e-8); (3) Na2 RHF and NaH RKS pbe against host
                float64 oracle SCFs (1e-7, 1e-8); (4) 0029-Na+ (0029
                with Na+ 2.25 A beyond O15, charge +1, 6-31g*, Na on the
                generated basis, 351 AO) RHF to convergence with kernels
                A and B counted (none of A's on the generic route), the
                ECP matrix against ecp_np on a seeded sample of >= 300
                shell-pair blocks (5e-11), the ECP gradient's z on Na and
                O15 against central differences (1e-6), and the ECP
                build's and gradient's wall, device time and launches;
                the host oracles run in worker processes meanwhile;
 10. pair       the pair J/K engine (scf/jk_pair.py: Hermite-density J,
                E.M.E^T exchange; float64/float32 PyTorch on the card,
                kernel A for its Schwarz q): H2O/sto-3g and O-H/6-31g
                get_j and get_k, all fp64, against the dense oracle
                (1e-9) and the same engine on the CPU (1e-12 of
                max(1, max |V|)); at 0029/6-31g*, reference cutoffs, on
                the converged RHF density: get_j and get_k against the
                tile engine's J and K (1e-5), a repeat bit-identical,
                each call's wall (first and warm), device time,
                launches, busy share, tasks and primitive quartets per
                tier, and kernel A's launches for the Schwarz q;
 11. multi      the sharded Fock build (JKEngine(group=...)) over gloo
                ranks that share the card: on phase full's converged 0029
                density (saved to the run's temporary directory), tile
                get_jk over 2 and 4 spawned ranks, every rank's J/K
                bit-identical to one rank's, the ranks' tasks summing to
                the plan's, per rank kernel A and B launches, get_jk wall
                (first and warm), the limb reduction's seconds and bytes;
                then dryrun_multichip(2) and (4) ((H2O)4/6-31g, block,
                bit-identical to one rank) with their gaps to the JAX
                package's single-chip result (1e-6);
 12. api        the PySCF adapter's patches (pyscf._apply_patches) on
                stub RHF, RKS (b3lyp) and ECP objects on the card against
                the same patches on the CPU: get_j/get_k/get_jk (hermi 1
                and 0, MODE_TOL['tile']), the incremental veff against the
                direct one, RKS Exc (1e-7) and veff, the ECPscalar routing
                (1e-12 of max(1, |V|)); entry()'s step (kernels A and B)
                on the card against its CPU run (ACC_TOL);
 13. a "kernels" JSON line; the last line is the device JSON.
The plan and q caches (joltqc_tpu_torch/utils/plancache.py) live in a
fresh temporary JQC_CACHE_DIR, removed at exit, and are off
(JQC_PLAN_CACHE=0) in every phase but engine, so that no phase loads what
an earlier phase or an earlier run wrote.
Any failed phase makes the script exit nonzero.  Options: --only PHASES
(comma list, for debugging: build,eri,accum,anchors,full,engine,modes,
dft,ecp,pair,multi,api; modes, pair and multi run the 0029 SCF themselves
when full is left out).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# and FLOP/s outside the tensor cores (kernel A's scalar FFMA and DFMA):
# 67 TFLOP/s fp32, 34 TFLOP/s fp64 (67 is fp64 on the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "fp64": 34e12}

# kernel A's generic route: l = 3, 4 and a non-canonical tuple (ls, nprims)
ERI_GENERIC_CASES = [
    ((0, 1, 0, 0), (3, 1, 3, 3)),
    ((3, 2, 1, 0), (1, 1, 1, 1)),
    ((4, 2, 1, 0), (1, 1, 1, 1)),
]
ERI_TOL = {"f32": 2e-5, "fp64": 1e-12}  # of the block's max |value|
ACC_TOL = {"f32": 1e-6, "fp64": 1e-13}  # of the static bound 2^e
# J/K of two accumulation modes on one density, of max(|J|, 1): the
# reference's bounds (tests/test_jk_engine.py, tile and block vs scatter)
MODE_TOL = {"tile": 1e-9, "block": 1e-11}


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
def _kernel_name(mangled):
    """'accum_tile_kernel<float, false>' for the mangled name of one of
    the port's kernels (float, double, int and bool template arguments);
    the mangled name where it names none."""
    m = re.search(r"\d([a-z_]+_kernel)(?:I((?:[fd]|L[ib]\d+E)+)E)?",
                  mangled)
    if not m:
        return mangled
    if not m.group(2):
        return m.group(1)
    names = {"f": "float", "d": "double", "Lb0E": "false", "Lb1E": "true"}
    args = [names.get(a.group(0), a.group(1))
            for a in re.finditer(r"[fd]|Lb[01]E|Li(\d+)E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def phase_build(ctx):
    from joltqc_tpu_torch.ops import cuda

    logs = cuda.build_all(verbose=True)
    for name, log in logs.items():
        fn = "?"
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                fn = _kernel_name(m.group(1))
            elif "registers" in ln or "spill" in ln:
                say(f"  ptxas {name} {fn}: {ln.strip()}")
    say("  nvcc seconds by library: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(cuda.build_seconds.items())))
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
    """Kernel A against its plain version: every specialised class in both
    tiers (nprims as 6-31g*'s: 1 for d, 3 below), omega = 0 and 0.3 on
    one class per source, the generic route's cases, and the engine's
    indexed form.  The route counter must count exactly the generic
    cases."""
    import torch
    from joltqc_tpu_torch.ops.eri import ERI_CLASSES, eri_chunk
    from joltqc_tpu_torch.ops.md import eri_plain

    dev = torch.device("cuda")
    worst = {"f32": 0.0, "fp64": 0.0}
    cases = [(ls, tuple(1 if l == 2 else 3 for l in ls), 0.0)
             for ls in ERI_CLASSES]
    cases += [(ls, (1, 3, 3, 3), 0.3) for ls in
              ((1, 1, 1, 0), (2, 0, 1, 0), (2, 1, 1, 0), (2, 2, 1, 0))]
    cases += [(ls, npr, om) for ls, npr in ERI_GENERIC_CASES
              for om in (0.0, 0.2)]
    n0, g0 = eri_chunk.launches, eri_chunk.generic_launches
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
    ngen = 2 * 2 * len(ERI_GENERIC_CASES)
    check(eri_chunk.launches - n0 == 2 * len(cases)
          and eri_chunk.generic_launches - g0 == ngen,
          f"eri: {eri_chunk.generic_launches - g0} generic launches of "
          f"{eri_chunk.launches - n0}, want {ngen} of {2 * len(cases)}")
    # engine form: per-class tables + int32 row indices, gathered inside
    for ls, nprims in (((2, 1, 1, 0), (1, 1, 3, 1)),
                       ((3, 2, 1, 0), (1, 1, 1, 1))):
        tab = _rand_quartet(nprims, 50, "fp64", seed=3, dev=dev)
        idx = torch.randint(0, 50, (4, 4096), generator=torch.Generator(
            device="cpu").manual_seed(5)).to(torch.int32).to(dev)
        got = eri_chunk("fp64", ls, nprims, tab, 0.0, idx=tuple(idx))
        ref = eri_plain(ls, nprims, _gathered(tab, idx), 0.0)
        err = float((got - ref).abs().max() / ref.abs().max())
        check(err < ERI_TOL["fp64"], f"eri indexed form {ls}: rel err "
              f"{err:.3e}")
        worst["fp64"] = max(worst["fp64"], err)
    return (f"{len(cases)} cases x 2 tiers ({len(ERI_CLASSES)} specialised "
            f"classes, {ngen} generic launches as expected) + indexed form; "
            f"max rel err f32 {worst['f32']:.3e} (tol 2e-5) fp64 "
            f"{worst['fp64']:.3e} (tol 1e-12)")


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
    worst_c, worst_d = _accum_cd(dev, rng)
    nb = _adversarial_b(dev, rng)
    nc = _adversarial_c(dev, rng)
    nd = _adversarial_d(dev, rng)
    return (f"max |kernel - plain| / bound: B {worst:.3e}, C {worst_c:.3e}, "
            f"D {worst_d:.3e} (fp64, tol 1e-13); repeat and permuted runs "
            f"bit-identical; {nb} adversarial cases of B, {nc} of C and {nd} "
            "of D (C and D bit-identical to their plain versions)")


def _runs(rng, T, hi, longest):
    """(T,) int32 of runs of one value in [0, hi), run lengths 1..longest"""
    import numpy as np

    lens = rng.integers(1, longest + 1, T)
    out = np.repeat(rng.integers(0, hi, T), lens)[:T]
    return out.astype(np.int32)


def _adversarial_b(dev, rng):
    """Kernel B against its plain version where its shared window is
    stressed: every task on one target, every target distinct, runs of
    one target, tasks in random order over many windows (the global
    route) and sorted by window; with and without weights.  Each is held
    by ``_held``: the plain version within ACC_TOL, repeat and permuted
    launches bit-identical.  Returns the number of cases."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.ops.eri import tier_dtype

    nfxy, nfo = 6, 9
    n = 0
    for tier in ("f32", "fp64"):
        for name, lx, ly, W in _window_cases(rng, 8192):
            weighted = name not in ("one target", "sorted by window")
            Tc = lx.shape[0]
            dt = tier_dtype(tier)
            G = torch.as_tensor(rng.standard_normal((Tc, nfxy, nfo)) * np.exp(
                rng.uniform(-10, 0, (Tc, 1, 1))), dtype=dt, device=dev)
            d = torch.as_tensor(rng.standard_normal((Tc, nfo)), dtype=dt,
                                device=dev)
            w = (torch.as_tensor(2.0 ** -rng.integers(0, 3, Tc),
                                 dtype=torch.float32, device=dev)
                 if weighted else None)
            lxt = torch.as_tensor(lx, device=dev)
            lyt = torch.as_tensor(ly, device=dev)
            bound = float(G.abs().amax() * d.abs().amax()) * nfo * 2
            e = at.bound_exponent(bound)

            def launch(acc, p):
                Gp, dp, xp, yp = _permuted(p, G, d, lxt, lyt)
                wp = None if w is None else _permuted(p, w)[0]
                got, _ = at._supertile(at.accum_tile_chunk, Gp, dp, xp, yp, W,
                                       W, bound, w=wp)
                acc.add_(got.view(acc.shape))

            def plain(acc):
                got, _ = at._supertile(at.accum_tile_plain, G, d, lxt, lyt, W,
                                       W, bound, w=w)
                acc.add_(got.view(acc.shape))

            _held(dev, f"accum_tile {tier} {name}", tier, e, (W, W, nfxy, 3),
                  Tc, launch, plain)
            n += 1
    return n


def _window_cases(rng, T):
    """(name, lx, ly, tile edge W) where a 64 x 64 shared window is
    stressed: every task on one target, every target distinct, runs of
    one target, tasks in random order over 16 windows of a 256 x 256
    tile (the global route) and sorted by window."""
    import numpy as np

    one = np.full(T, 5, np.int32)
    grid = rng.permutation(64 * 64).astype(np.int32)
    rand = rng.integers(0, 256, (2, T)).astype(np.int32)
    order = np.argsort((rand[0] // 64) * 4 + rand[1] // 64, kind="stable")
    return (("one target", one, one, 64),
            ("distinct", grid // 64, grid % 64, 64),
            ("runs", _runs(rng, T, 64, 100), _runs(rng, T, 64, 100), 64),
            ("random over 16 windows", rand[0], rand[1], 256),
            ("sorted by window", rand[0][order], rand[1][order], 256))


def _adversarial_c(dev, rng):
    """Kernel C against its plain version, bit for bit, in the window
    cases of kernel B and with tasks outside the tile (dropped), at nf 18
    and 1; repeat and permuted launches give the same bits.  Returns the
    number of cases."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops import accum as ac
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.ops.eri import tier_dtype

    n = 0
    for tier in ("f32", "fp64"):
        T = 8192
        out = rng.integers(-3, 70, (2, T)).astype(np.int32)
        cases = _window_cases(rng, T) + (
            ("tasks outside the tile", out[0], out[1], 64),)
        for name, lx, ly, W in cases:
            for nf in (18, 1):
                Tc = lx.shape[0]
                v = torch.as_tensor(rng.standard_normal((Tc, nf)) * np.exp(
                    rng.uniform(-12, 0, (Tc, 1))), dtype=tier_dtype(tier),
                    device=dev)
                ix = torch.as_tensor(lx, device=dev)
                iy = torch.as_tensor(ly, device=dev)
                e = ac.bound_exponent(float(v.abs().max()) * 1.5)
                what = f"tile_accumulate {tier} {name} nf {nf}"

                def launch(acc, p):
                    at.tile_accumulate_chunk(*_permuted(p, v, ix, iy), acc, e)

                _, acc_k, acc_p = _held(
                    dev, what, tier, e, (W, W, nf, ac.NLIMB), Tc, launch,
                    lambda acc: at.tile_accumulate_plain(v, ix, iy, acc, e))
                check(torch.equal(acc_k, acc_p), f"{what}: not bit-identical "
                      "to the plain version")
                n += 1
    return n


def _adversarial_d(dev, rng):
    """Kernel D against its plain version, bit for bit: every task on one
    row, every row distinct, rows in random order with keys outside [0,
    nrows), and the engine's order (groups of 64 rows, gslot
    non-decreasing, runs of one row) at nf 3 and 36; repeat and permuted
    launches give the same bits.  Returns the number of cases."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops import accum as ac
    from joltqc_tpu_torch.ops.eri import tier_dtype

    n = 0
    for tier in ("fp64", "f32"):
        gs = np.sort(rng.integers(0, 512, 200_000))
        sorted_keys = (gs * 64 + _runs(rng, gs.shape[0], 64, 40)).astype(
            np.int32)
        cases = (  # (name, key, nf, nrows)
            ("one row", np.full(65_536, 7, np.int32), 3, 16),
            ("distinct rows", rng.permutation(16_384).astype(np.int32), 3,
             16_384),
            ("random, keys outside", rng.integers(-1, 4098, 131_072).astype(
                np.int32), 9, 4096),
            ("engine order nf 3", sorted_keys, 3, 512 * 64),
            ("engine order nf 36", sorted_keys[:60_000], 36, 512 * 64),
            ("one row nf 1", np.full(50_000, 3, np.int32), 1, 8),
        )
        for name, key, nf, nrows in cases:
            T = key.shape[0]
            v = torch.as_tensor(rng.standard_normal((T, nf)) * np.exp(
                rng.uniform(-20, 3, (T, nf))), dtype=tier_dtype(tier),
                device=dev)
            kt = torch.as_tensor(key, device=dev)
            e = ac.bound_exponent(float(v.abs().max()) * 2)
            what = f"accum_block {tier} {name}"

            def launch(acc, p):
                ac.accum_block_chunk(*_permuted(p, v, kt), acc, e)

            _, acc_k, acc_p = _held(
                dev, what, tier, e, (nrows, nf, ac.NLIMB), T, launch,
                lambda acc: ac.block_accumulate_plain(v, kt, acc, e))
            check(torch.equal(acc_k, acc_p), f"{what}: not bit-identical to "
                  "the plain version")
            n += 1
    return n


def _permuted(perm, *tensors):
    """The tensors with their tasks (axis 0) in the order ``perm``; None
    leaves them as they are."""
    return [t if perm is None else t[perm].contiguous() for t in tensors]


def _held(dev, what, tier, e, shape, T, launch, plain):
    """One accumulation kernel against its plain version: ``launch(acc,
    perm)`` and ``plain(acc)`` add into a zeroed int64 ``acc`` of
    ``shape`` (perm: a task permutation or None).  Fails past ACC_TOL of
    2^e, or if a second or a permuted launch changes a bit.  Returns the
    max abs error and the two accumulators (kernel, plain)."""
    import torch
    from joltqc_tpu_torch.ops.accum import limbs_to_f64

    accs = [torch.zeros(shape, dtype=torch.int64, device=dev)
            for _ in range(4)]
    launch(accs[0], None)
    plain(accs[1])
    launch(accs[2], None)
    launch(accs[3], torch.randperm(T, device=dev))
    torch.cuda.synchronize()
    err = float((limbs_to_f64(accs[0], e)
                 - limbs_to_f64(accs[1], e)).abs().max())
    check(err < ACC_TOL[tier] * 2.0 ** e, f"{what}: err {err:.3e} vs 2^{e}")
    check(torch.equal(accs[0], accs[2]), f"{what}: runs differ")
    check(torch.equal(accs[0], accs[3]), f"{what}: permutation changes bits")
    check(bool(accs[0].any()), f"{what}: nothing accumulated")
    return err, accs[0], accs[1]


def _accum_cd(dev, rng):
    """Kernels C (tile_accumulate) and D (block_accumulate) against their
    plain versions on synthetic values, with a second and a permuted run.
    Returns the worst fp64 error over 2^e of each."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops import accum as ac
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.ops.eri import tier_dtype

    worst = {"c": 0.0, "d": 0.0}
    for tier, nf, Wx, Wy, T in (("f32", 3, 64, 64, 1024),
                                ("fp64", 36, 64, 64, 1024),
                                ("f32", 1, 8, 64, 1024),
                                ("fp64", 36, 64, 64, 131072),
                                ("f32", 36, 64, 64, 131072)):
        v = torch.as_tensor(
            rng.standard_normal((T, nf)) * np.exp(rng.uniform(-12, 0, (T, 1))),
            dtype=tier_dtype(tier), device=dev)
        ix = torch.as_tensor(rng.integers(0, Wx, T), dtype=torch.int32,
                             device=dev)
        iy = torch.as_tensor(rng.integers(0, Wy, T), dtype=torch.int32,
                             device=dev)
        e = ac.bound_exponent(float(v.abs().max()) * 1.5)
        err, _, _ = _held(
            dev, f"tile_accumulate {tier} T={T} nf={nf} Wx={Wx}", tier, e,
            (Wx, Wy, nf, ac.NLIMB), T,
            lambda acc, p: at.tile_accumulate_chunk(*_permuted(p, v, ix, iy),
                                                    acc, e),
            lambda acc: at.tile_accumulate_plain(v, ix, iy, acc, e))
        if tier == "fp64":
            worst["c"] = max(worst["c"], err * 2.0 ** -e)
    for T, nf, nrows in ((1024, 5, 16), (256, 3, 32), (131072, 36, 4096)):
        for tier in ("fp64", "f32"):
            v = torch.as_tensor(
                rng.standard_normal((T, nf))
                * np.exp(rng.uniform(-20, 3, (T, nf))),
                dtype=tier_dtype(tier), device=dev)
            # some keys at or beyond nrows: dropped
            key = torch.as_tensor(rng.integers(0, nrows + 2, T),
                                  dtype=torch.int32, device=dev)
            e = ac.bound_exponent(float(v.abs().max()) * 2)
            err, _, _ = _held(
                dev, f"block_accumulate {tier} T={T} nf={nf} nrows={nrows}",
                tier, e, (nrows, nf, ac.NLIMB), T,
                lambda acc, p: ac.accum_block_chunk(*_permuted(p, v, key),
                                                    acc, e),
                lambda acc: ac.block_accumulate_plain(v, key, acc, e))
            if tier == "fp64":
                worst["d"] = max(worst["d"], err * 2.0 ** -e)
    return worst["c"], worst["d"]


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
        if basis == "sto-3g":
            e_direct = e
    mol_sto = Molecule.from_atom_string(H2O, basis="sto-3g")
    out.append(_anchor_modes(mol_sto))
    mf = RHF(mol_sto, conv_tol=1e-11, incremental=True)
    e = mf.kernel()
    check(mf.converged and abs(e - e_direct) < 1e-9,
          f"H2O/sto-3g incremental: E {e:.12f} vs direct {e_direct:.12f}")
    out.append(f"incremental RHF |dE vs direct|={abs(e - e_direct):.1e} "
               f"in {mf.scf_summary['cycles']} cycles")
    return "; ".join(out)


def _anchor_modes(mol):
    """H2O/sto-3g get_jk on the card, all-fp64 routing: the three
    accumulation modes x (omega=0.3, hermi=0, a stack of 2) against the
    dense oracle at 1e-9."""
    import numpy as np
    from joltqc_tpu_torch.mol import intor_np
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.scf import JKEngine

    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, (mol.nao, mol.nao))
    sym = a + a.T
    g = {0.0: intor_np.eri(mol), 0.3: intor_np.eri(mol, omega=0.3)}

    def ref(om, d):
        return (np.einsum("ijkl,kl->ij", g[om], d),
                np.einsum("ikjl,kl->ij", g[om], d))

    worst = 0.0
    for accum, kw in (("tile", {}), ("scatter", {}), ("block", {"tile": 4})):
        eng = JKEngine(BasisLayout(mol), cutoff_fp32=1e-30,
                       cutoff_fp64=1e-30, accum=accum, tile_w=8, **kw)
        cases = (("omega", eng.get_jk(sym, omega=0.3), ref(0.3, sym)),
                 ("hermi0", eng.get_jk(a, hermi=0), ref(0.0, a)))
        stack = np.stack([sym, 0.5 * sym + np.eye(mol.nao)])
        vj, vk = eng.get_jk(stack)
        cases += tuple((f"stack{i}", (vj[i], vk[i]), ref(0.0, stack[i]))
                       for i in range(2))
        for name, got, want in cases:
            err = max(np.abs(got[0] - want[0]).max(),
                      np.abs(got[1] - want[1]).max())
            check(err < 1e-9, f"H2O/sto-3g {accum} {name}: |J/K - oracle| "
                  f"{err:.3e}")
            worst = max(worst, err)
        if accum == "block":
            check(eng.plan_stats["by_accum"]["block"] > 0,
                  "H2O/sto-3g block engine: no block entry")
    return (f"3 modes x (omega, hermi=0, stack) vs dense oracle: max err "
            f"{worst:.1e} (tol 1e-9)")


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
    eri_k.generic_launches = 0
    acc_k.launches = 0
    t0 = time.perf_counter()
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ctx["launches"] = {"eri": eri_k.launches, "accum_tile": acc_k.launches,
                       "eri_generic": eri_k.generic_launches}
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
    check(eri_k.generic_launches == 0, f"0029: {eri_k.generic_launches} "
          "ERI launches took the generic route")
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
    ctx["mf"], ctx["e_0029"], ctx["scf_wall"] = mf, e, wall
    _profile_jk(mf.jk, dm, jk_wall, "get_jk")
    _fock_bounds(mf.jk)
    _time_kernels(ctx, mf)
    return (f"E={e:.10f} (ref {E_0029}, |dE| {abs(e - E_0029):.2e}); "
            f"get_jk on converged dm {jk_wall:.3f} s, twice bit-identical, "
            f"launches per get_jk {ctx['launches_per_jk']}")


def _profile_jk(eng, dm, wall, label):
    """Device time by kernel over one get_jk (torch.profiler), beside the
    wall time of a warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.get_jk(dm)
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
        say(f"  profile {label}: no device time recorded (not measured)")
        return
    for us, key, n in rows[:6]:
        say(f"  profile {label}: {us / 1e3:10.3f} ms  x{n:<5d} {key[:70]}")
    eri_rows = [(us, key, n) for us, key, n in rows
                if re.search(r"eri_(class_|generic_)?kernel", key)]
    eri = sum(us for us, _, _ in eri_rows)
    for us, key, n in eri_rows:
        m = re.search(r"eri_\w*kernel<[^>]*>", key)
        say(f"  profile {label} eri: {us / 1e3:10.3f} ms  x{n:<4d} "
            f"{m.group(0) if m else key[:70]}")
    # kernel B is contract_kernel + accum_tile_kernel; D accum_block_kernel
    acc = [(us, n) for us, key, n in rows if "contract_kernel" in key
           or "accum_tile_kernel" in key or "accum_block_kernel" in key]
    say(f"  profile {label}: device busy {dev_total / 1e3:.3f} ms (eri "
        f"kernels {eri / 1e3:.3f} ms, accumulation kernels B/D "
        f"{sum(us for us, _ in acc) / 1e3:.3f} ms in "
        f"{sum(n for _, n in acc)} kernel runs) of {wall * 1e3:.3f} ms wall")


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
    """FP operations per primitive quartet of kernel A's chain, which the
    class kernels and the generic kernel of csrc/eri.cuh share: R
    recursion, E tables and the ket-then-bra assembly (Boys and pair data
    left out, so the bound stays a lower bound)."""
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
    """Hold every ERI class the plan launches (each (tier, l-tuple), the
    class kernel eri_class_kernel<R, la, lb, lc, ld> where the tuple has
    one) and both accum_tile_kernel templates against their plain
    versions, at the main path's shapes: the first chunk of each class's
    largest entry, and of each (tier, lmax <= 1 | 2 | 4) group's entry
    with the most ERI elements (real tables, indexed ERI form,
    component-major G; kernel B on every stream into the E-space
    accumulator).  Fails if a launch took the generic route.  Returns the
    max absolute error of each kernel."""
    import torch
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.ops.eri import eri_chunk, tier_dtype
    from joltqc_tpu_torch.ops.md import eri_plain
    from joltqc_tpu_torch.scf.jk_contracted import STREAMS

    eng = mf.jk
    by_class, by_lm = {}, {}
    for entry in eng._plan:
        if not entry["ntasks"]:
            continue
        key = (entry["tier"], entry["ls"])
        if key not in by_class or entry["ntasks"] > by_class[key]["ntasks"]:
            by_class[key] = entry
        lm = max(entry["ls"])
        key = (entry["tier"], 1 if lm <= 1 else 2 if lm == 2 else 4)
        if key not in by_lm or (entry["ntasks"] * _nfel(entry)
                                > by_lm[key]["ntasks"] * _nfel(by_lm[key])):
            by_lm[key] = entry
    picks = {id(e): e for e in [*by_class.values(), *by_lm.values()]}
    picks = sorted(picks.values(), key=lambda e: (e["tier"], e["ls"],
                                                  e["nprims"]))
    dm = eng.layout.dm_to_internal(mf.dm)
    _, E = eng._espace()
    a1, a2 = (torch.zeros((E, E, at.NLIMB), dtype=torch.int64,
                          device=eng.device) for _ in range(2))
    worst = {"eri": 0.0, "accum_tile": 0.0}
    g0 = eri_chunk.generic_launches
    for entry in picks:
        tier, ls, nprims = entry["tier"], entry["ls"], entry["nprims"]
        tbls, quartet, idx, w = _first_chunk(eng, entry)
        G = eri_chunk(tier, ls, nprims, quartet, 0.0, idx=idx)
        Gp = eri_plain(ls, nprims, _gathered(quartet, idx), 0.0)
        err_a = float((G - Gp).abs().max())
        rel_a = err_a / max(float(Gp.abs().max()), 1e-300)
        check(bool(torch.isfinite(G).all()), f"eri {tier} {ls}: non-finite")
        check(rel_a < ERI_TOL[tier], f"eri {tier} {ls} at the main path's "
              f"shapes: rel err {rel_a:.3e}")
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
        say(f"  check {tier} class {ls} nprims {nprims} T={idx[0].shape[0]}: "
            f"eri rel err {rel_a:.3e} (tol {ERI_TOL[tier]:g}); accum_tile "
            f"{len(STREAMS)} streams err / 2^e {err_b * 2.0 ** -e:.3e} (tol "
            f"{ACC_TOL[tier]:g})")
        worst["eri"] = max(worst["eri"], err_a)
        worst["accum_tile"] = max(worst["accum_tile"], err_b)
    check(eri_chunk.generic_launches == g0, "eri: a class of the 0029 plan "
          "took the generic route")
    say(f"  check: {len(picks)} entries held ({len(by_class)} (tier, class) "
        f"pairs, {len(by_lm)} (tier, lmax) groups), none on the generic "
        "route")
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
        name="eri_chunk", route="cuda", source="joltqc_tpu_torch/csrc/eri.cuh",
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

    # ---- kernel B: the K stream ac of the same chunk (the table's row),
    # and J stream ab (every task of a bra run on one target)
    dm = torch.as_tensor(
        eng.layout.dm_to_internal(mf.dm), dtype=tier_dtype(tier),
        device=eng.device).contiguous()
    for s in (2, 0):
        row = _time_b_stream(eng, entry, s, G, tbls, idx, w, dm, es)
        if s == 2:
            ctx["kern_b"] = dict(
                name="accum_tile_chunk", route="cuda",
                source="joltqc_tpu_torch/csrc/accum_tile.cu",
                replaces="joltqc_tpu/ops/accum_tile.py:367",
                launches=ctx["launches"]["accum_tile"],
                max_abs_err=worst["accum_tile"], **row)


def _time_b_stream(eng, entry, s, G, tbls, idx, w, dm, es):
    """Kernel B on stream s of a chunk: ms per launch (and its split
    between the two kernels), the plain version's, one index_add_ of the
    contracted values (the yardstick) and the byte bound."""
    import torch
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.scf.jk_contracted import STREAMS

    kind, xi, yi, ui, vi, _ = STREAMS[s]
    tier = entry["tier"]
    T = idx[0].shape[0]
    args = _accum_args(eng, entry, s, G, tbls, idx, w, dm)
    tabs = args[1]
    _, E = eng._espace()
    e = at.bound_exponent(entry["bound"])
    accs = [torch.zeros((E, E, at.NLIMB), dtype=torch.int64,
                        device=eng.device) for _ in range(2)]
    ms_b = cuda_ms(lambda: at.accum_tile_chunk(*args, accs[0], e), reps=20)
    split = _kernel_split(lambda: at.accum_tile_chunk(*args, accs[0], e),
                          reps=20)
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
    lib_b = cuda_ms(lambda: acc64.index_add_(0, flat, v), reps=20)
    ntgt = int(torch.unique(flat).numel())
    bytes_b = T * (nfxy * nfo * es + nfo * es + 16 + 4) + ntgt * 24
    flops_b = 2.0 * T * nfxy * nfo
    bound_b = max(bytes_b / PEAK_BYTES, flops_b / PEAK_FLOPS[tier]) * 1e3
    parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
    say(f"  time accum_tile: stream {kind}{'abcd'[xi]}{'abcd'[yi]} T={T} "
        f"nfxy={nfxy} nfo={nfo}: kernel {ms_b:.4f} ms ({parts}), plain "
        f"{plain_b:.3f} ms, index_add_ {lib_b:.4f} ms, bound {bound_b:.4f} "
        f"ms ({bytes_b:.3e} B, {ntgt} targets)")
    return dict(
        ms=ms_b, plain_ms=plain_b, bound_ms=bound_b,
        bound_by="bytes" if bytes_b / PEAK_BYTES
        >= flops_b / PEAK_FLOPS[tier] else "operations",
        library_ms=lib_b)


def _kernel_split(fn, reps):
    """Device ms per call of fn() by CUDA kernel name (torch.profiler),
    keyed by the kernel's short name; {} where the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = re.split(r"[<(]", ev.key.split("::", 1)[-1])[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


# ------------------------------------------------------------ phase 6
ENGINE_TUNE_BUDGET_S = 30.0  # tune_workload's wall budget in phase engine
# depth of phase engine's cold and warm RHF: its first 6 cycles, each of
# which builds (cold) or loads (warm) its own plan (the 27-cycle SCF
# rebuilds on cycles 0-17 only); cut from 27 when the whole script passed
# 900 s (PERF.md)
ENGINE_CYCLES = 6


@contextlib.contextmanager
def _env(**kv):
    """Set environment variables for a block, then restore them."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _engine_scf(label):
    """A fresh 0029 RHF of ENGINE_CYCLES cycles: (mf, E, SCF wall s,
    kernel A and B launches), the counts set to 0 just before and read
    just after."""
    import torch
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.ops.accum_tile import accum_tile_chunk as acc_k
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.scf import RHF

    mf = RHF(Molecule.from_xyz_file(XYZ_0029, basis="6-31g*"),
             max_cycle=ENGINE_CYCLES)
    eri_k.launches = eri_k.generic_launches = acc_k.launches = 0
    t0 = time.perf_counter()
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {"eri": eri_k.launches, "accum_tile": acc_k.launches,
         "eri_generic": eri_k.generic_launches}
    tm = mf.jk.timing
    say(f"  engine {label}: E={e:.10f} cycles={mf.scf_summary['cycles']} "
        f"scf_wall_s={wall:.2f} plan_builds={tm.get('plan_builds', 0)} "
        f"plan_build_s={tm.get('plan_build_s', 0.0):.2f} plan_saves="
        f"{tm.get('plan_saves', 0)} plan_save_s={tm.get('plan_save_s', 0.0):.2f}"
        f" plan_save_bytes={tm.get('plan_save_bytes', 0)} plan_loads="
        f"{tm.get('plan_loads', 0)} plan_load_s={tm.get('plan_load_s', 0.0):.2f}"
        f" launches={n}")
    check(mf.scf_summary["cycles"] == ENGINE_CYCLES and math.isfinite(e),
          f"engine {label}: {mf.scf_summary['cycles']} cycles, E {e}")
    check(n["eri_generic"] == 0, f"engine {label}: generic ERI launches")
    return mf, e, wall, n


def _timed_jk(eng, dm):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.get_jk(dm)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_jk(a, b):
    import numpy as np

    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _auto_vs_tile(label, eng, dm, jt, wall_tile):
    """get_jk of an 'auto' engine on the converged density against the
    tile engine's J/K jt: tasks by mode, a repeat bit-identical, and the
    bits of jt where every class runs as tile (exact integer limbs, any
    chunking), else MODE_TOL['tile'] of max(|J|, 1)."""
    _, cold = _timed_jk(eng, dm)  # plan build (saved) and uploads
    ja, wall = _timed_jk(eng, dm)
    check(_same_jk(ja, eng.get_jk(dm)), f"engine {label}: repeat differs")
    by = eng.plan_stats["by_accum"]
    chunks = sorted({eng._entry_chunk(e) for e in eng._plan})
    dj, dk, scale = _jk_diff(ja, jt)
    all_tile = by["tile"] == eng.plan_stats["ntasks"]
    say(f"  engine {label}: tasks by mode {by}, chunks {chunks[:6]}"
        f"{'...' if len(chunks) > 6 else ''}; first get_jk {cold:.3f} s, "
        f"warm {wall:.3f} s (tile engine {wall_tile:.3f} s); vs tile "
        f"|dJ| {dj:.3e} |dK| {dk:.3e}" + (" (every class tile: bit-identical "
                                           "required)" if all_tile else
                                           f" (limit {MODE_TOL['tile']:g} x "
                                           f"{scale:.4g})"))
    if all_tile:
        check(_same_jk(ja, jt), f"engine {label}: J/K differ from the tile "
              "engine's with every class on tile")
    else:
        check(max(dj, dk) < MODE_TOL["tile"] * scale,
              f"engine {label}: |dJ| {dj:.3e} |dK| {dk:.3e} vs tile")
    return wall, by


def phase_engine(ctx):
    import numpy as np
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.scf import JKEngine
    from joltqc_tpu_torch.utils import autotune, plancache

    # the converged density of phase full's SCF (cache off) for (3)-(5)
    dm_conv = _scf_0029(ctx).dm
    base = os.path.join(ctx["cache_dir"], "engine")
    os.makedirs(base)
    with _env(JQC_CACHE_DIR=base, JQC_PLAN_CACHE="1",
              JQC_PLAN_CACHE_MIN_SECS="0"):
        autotune._TABLE = None
        plans = os.path.join(plancache.cache_root(), "plans")
        # (1) cold: every plan built and saved, every q computed and saved
        cold, e_c, wall_c, n_c = _engine_scf("cold")
        tc = cold.jk.timing
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(plans) for f in fs)
        nq = sum(-(-pc.npair // cold.jk._chunk(
            (cold.jk.classes[pc.ci].l, cold.jk.classes[pc.cj].l) * 2))
            for pc in cold.jk.pair_classes)
        check(tc["plan_builds"] > 0 and tc.get("plan_loads", 0) == 0,
              "engine cold: a plan was loaded in an empty cache")
        check(tc.get("plan_saves", 0) == tc["plan_builds"],
              f"engine cold: {tc.get('plan_saves', 0)} plans saved of "
              f"{tc['plan_builds']} built")
        say(f"  engine cold: {nbytes} bytes on disk in "
            f"{sum(len(fs) for _, _, fs in os.walk(plans))} files; kernel A "
            f"launches {n_c['eri']}, {nq} of them for the Schwarz q")
        # (2) warm: a fresh RHF and engine load every plan and q
        warm, e_w, wall_w, n_w = _engine_scf("warm")
        tw = warm.jk.timing
        check(warm.scf_summary["cycles"] == cold.scf_summary["cycles"]
              and e_w == e_c and np.array_equal(warm.dm, cold.dm),
              f"engine warm: E {e_w!r} in {warm.scf_summary['cycles']} "
              f"cycles vs cold {e_c!r} in {cold.scf_summary['cycles']}")
        check(tw.get("plan_builds", 0) == 0, "engine warm: a plan was built")
        check(tw.get("plan_loads", 0) == tc["plan_builds"],
              f"engine warm: {tw.get('plan_loads', 0)} loads for "
              f"{tc['plan_builds']} cold builds")
        check(n_w["eri"] == n_c["eri"] - nq,
              f"engine warm: kernel A launches {n_w['eri']}, want "
              f"{n_c['eri']} - {nq} Schwarz-q launches")
        eri_k.launches = 0
        for pc_c, pc_w in zip(cold.jk.pair_classes, warm.jk.pair_classes):
            q = warm.jk._ensure_q(pc_w)
            check(np.array_equal(q, pc_c.q_log)
                  and np.array_equal(pc_w.i_loc, pc_c.i_loc)
                  and np.array_equal(pc_w.j_loc, pc_c.j_loc),
                  "engine warm: q from disk differs from the computed q")
        check(eri_k.launches == 0, f"engine warm: {eri_k.launches} kernel A "
              "launches for a q on disk")
        dm = cold.dm  # the last cycle's density: both engines' plans hold
        jc, _ = _timed_jk(cold.jk, dm)
        jw, _ = _timed_jk(warm.jk, dm)
        check(_same_jk(jc, jw), "engine: get_jk on the last density differs "
              "between the cold and the warm engine")
        nb, nl = tc["plan_builds"], tw["plan_loads"]
        say(f"  engine warm vs cold: SCF {wall_w:.2f} s vs {wall_c:.2f} s; "
            f"plan_load_s {tw['plan_load_s']:.2f} ({tw['plan_load_s'] / nl:.3f}"
            f" s a load) vs plan_build_s {tc['plan_build_s']:.2f} "
            f"({tc['plan_build_s'] / nb:.3f} s a build); E, cycles, density "
            f"and get_jk bit-identical; q from disk, 0 kernel A launches; "
            f"launches {n_w}")
        # (3)-(5) on the converged density, with a tile engine screened at
        # that density (the SCF engines' plans were screened at others)
        dm = dm_conv
        kw = dict(cutoff_fp32=cold.cutoff_fp32, cutoff_fp64=cold.cutoff_fp64)
        tile = JKEngine(cold.layout, accum="tile", **kw)
        tile.get_jk(dm)
        jc, wall_tile = _timed_jk(tile, dm)
        # (3) profile=True: the same bits, class_time over the plan
        eng = tile
        eng.profile, eng.class_time = True, {}
        jp, wall_p = _timed_jk(eng, dm)
        eng.profile = False
        keys = {(e["ls"], e["nprims"], e["tier"]) for e in eng._plan}
        check(_same_jk(jp, jc), "engine profile: J/K differ")
        check(set(eng.class_time) == keys, "engine profile: class_time keys "
              "are not the plan's classes")
        tot = sum(eng.class_time.values())
        for key, t in sorted(eng.class_time.items(), key=lambda kv: -kv[1])[:8]:
            say(f"  engine profile: {t * 1e3:9.3f} ms  {key}")
        say(f"  engine profile: {len(keys)} classes, class_time sum "
            f"{tot * 1e3:.3f} ms of the call's {wall_p * 1e3:.3f} ms wall "
            f"(unprofiled warm call {wall_tile * 1e3:.3f} ms); J/K "
            "bit-identical")
        # (4) accum='auto' on the committed table
        autotune._TABLE = None
        committed = dict(autotune.load_table())
        say(f"  engine auto: committed table {autotune._device_name()} with "
            f"{len(committed)} classes")
        wall_a, by_a = _auto_vs_tile("auto", JKEngine(cold.layout, accum="auto",
                                                      **kw), dm, jc, wall_tile)
        # (5) a bounded tune into the phase's directory, then 'auto' on it
        t0 = time.perf_counter()
        table = autotune.tune_workload(tile, max_chunks=4, verbose=False,
                                       budget_s=ENGINE_TUNE_BUDGET_S)
        t_tune = time.perf_counter() - t0
        path = autotune._table_path()
        with open(path) as f:
            user = json.load(f)
        autotune._TABLE = None
        loaded = autotune.load_table()
        tuned = [k for k in user if k not in committed or user[k] !=
                 committed[k]]
        check(path.startswith(base) and user == table and loaded == table,
              "engine tune: load_table does not return the written table")
        say(f"  engine tune: {t_tune:.1f} s (budget {ENGINE_TUNE_BUDGET_S:g}),"
            f" {len(table)} classes in {path}, {len(tuned)} of them new or "
            f"changed over the committed table; e.g. " + "; ".join(
                f"{k} {user[k]}" for k in tuned[:3]))
        _auto_vs_tile("auto-tuned", JKEngine(cold.layout, accum="auto", **kw),
                      dm, jc, wall_tile)
    for k, row in (("eri", "kern_a"), ("accum_tile", "kern_b")):
        if row in ctx:  # the kernels line counts this phase's SCFs too
            ctx[row]["launches"] += n_c[k] + n_w[k]
    return (f"cold SCF {wall_c:.2f} s ({nb} builds, {nbytes} bytes), warm "
            f"{wall_w:.2f} s ({nl} loads, {tw['plan_load_s']:.2f} s), "
            f"bit-identical; 'auto' get_jk {wall_a:.3f} s vs tile "
            f"{wall_tile:.3f} s ({by_a})")


# ------------------------------------------------------------ phase 7
def _scf_0029(ctx):
    """The converged direct RHF of phase full (run here when that phase
    was left out)."""
    if "mf" not in ctx:
        import torch
        from joltqc_tpu_torch.mol import Molecule
        from joltqc_tpu_torch.scf import RHF

        mf = RHF(Molecule.from_xyz_file(XYZ_0029, basis="6-31g*"))
        t0 = time.perf_counter()
        e = mf.kernel()
        torch.cuda.synchronize()
        check(mf.converged, "0029: SCF not converged")
        ctx["mf"], ctx["e_0029"] = mf, e
        ctx["scf_wall"] = time.perf_counter() - t0
    return ctx["mf"]


def _jk_diff(a, b):
    """max |dJ|, max |dK| and the scale max(|J|, 1) of two (J, K) pairs."""
    import numpy as np

    return (float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1]).max()),
            max(float(np.abs(b[0]).max()), 1.0))


def phase_modes(ctx):
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops.accum import accum_block_chunk as blk_k
    from joltqc_tpu_torch.ops.accum_tile import accum_tile_chunk as acc_k
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.scf import RHF, JKEngine

    mf = _scf_0029(ctx)
    dm = mf.dm
    nao = dm.shape[0]
    engines = {"tile": mf.jk}
    jk = {"tile": mf.jk.get_jk(dm)}
    walls = {}
    for mode in ("scatter", "block"):
        eng = JKEngine(mf.layout, cutoff_fp32=mf.cutoff_fp32,
                       cutoff_fp64=mf.cutoff_fp64, accum=mode)
        eng.get_jk(dm)  # cold: Schwarz bounds, plan build, uploads
        eri_k.launches = acc_k.launches = blk_k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jk[mode] = eng.get_jk(dm)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
        n = {"eri": eri_k.launches, "accum_tile": acc_k.launches,
             "accum_block": blk_k.launches}
        ctx.setdefault("launches_modes", {})[mode] = n
        again = eng.get_jk(dm)
        check(np.array_equal(jk[mode][0], again[0])
              and np.array_equal(jk[mode][1], again[1]),
              f"modes {mode}: repeated get_jk differs")
        by = eng.plan_stats["by_accum"]
        say(f"  modes {mode}: tasks by entry accum {by}, entries "
            f"{len(eng._plan)}, warm get_jk {walls[mode]:.3f} s, launches {n}, "
            f"plan_build_s {eng.timing['plan_build_s']:.2f}")
        engines[mode] = eng
        _profile_jk(eng, dm, walls[mode], f"get_jk[{mode}]")
    by = engines["block"].plan_stats["by_accum"]
    check(by["block"] > 0, "modes: the block engine routed no task to 'block'")
    check(ctx["launches_modes"]["block"]["accum_block"] > 0,
          "modes: kernel D was not launched by the block engine")
    check(ctx["launches_modes"]["scatter"]["accum_block"] == 0
          and ctx["launches_modes"]["scatter"]["accum_tile"] == 0,
          "modes: the scatter engine launched an accumulation kernel")
    # J/K of the modes against each other; limits stated before the run
    lines = []
    for a, b, tol in (("tile", "scatter", MODE_TOL["tile"]),
                      ("block", "scatter", MODE_TOL["block"])):
        dj, dk, scale = _jk_diff(jk[a], jk[b])
        lines.append(f"{a} vs {b}: |dJ| {dj:.3e} |dK| {dk:.3e} (limit "
                     f"{tol:g} x {scale:.4g})")
        check(dj < tol * scale and dk < tol * scale,
              f"modes {a} vs {b}: |dJ| {dj:.3e} |dK| {dk:.3e} above "
              f"{tol:g} x {scale:.4g}")
    say("  modes J/K: " + "; ".join(lines))

    # hermi=0 on dm + A, omega=0.3: tile against scatter; J of the hermi=0
    # call is J of the symmetric part; a stack [dm, dm/2] gives [J, J/2]
    a = np.random.default_rng(29).standard_normal((nao, nao)) * 1e-3
    x = dm + (a - a.T)
    xs = 0.5 * (x + x.T)
    et, es = engines["tile"], engines["scatter"]
    h_t, h_s = et.get_jk(x, hermi=0), es.get_jk(x, hermi=0)
    dj, dk, scale = _jk_diff(h_t, h_s)
    check(dj < MODE_TOL["tile"] * scale and dk < MODE_TOL["tile"] * scale,
          f"modes hermi=0 tile vs scatter: |dJ| {dj:.3e} |dK| {dk:.3e}")
    asym = float(np.abs(h_t[1] - h_t[1].T).max())
    check(asym > 0.0, "modes hermi=0: K came out symmetric")
    for name, eng, h in (("tile", et, h_t), ("scatter", es, h_s)):
        j_sym, _ = eng.get_jk(xs, with_k=False)
        check(np.array_equal(j_sym, h[0]),
              f"modes hermi=0 {name}: J differs from J of the symmetric part")
    o_t, o_s = et.get_jk(dm, omega=0.3), es.get_jk(dm, omega=0.3)
    oj, ok_, oscale = _jk_diff(o_t, o_s)
    check(oj < MODE_TOL["tile"] * oscale and ok_ < MODE_TOL["tile"] * oscale,
          f"modes omega=0.3 tile vs scatter: |dJ| {oj:.3e} |dK| {ok_:.3e}")
    check(float(np.abs(o_t[0]).max()) < float(np.abs(jk["tile"][0]).max()),
          "modes omega=0.3: long-range J not below the full J")
    sj, sk = et.get_jk(np.stack([dm, 0.5 * dm]))
    jt, kt = et.get_jk(dm)
    jmax = float(np.abs(jt).max())
    d_stack = max(float(np.abs(sj[0] - jt).max()),
                  float(np.abs(sj[1] - 0.5 * jt).max()),
                  float(np.abs(sk[0] - kt).max()),
                  float(np.abs(sk[1] - 0.5 * kt).max()))
    check(d_stack < 1e-12 * jmax, f"modes stack [dm, dm/2]: off by "
          f"{d_stack:.3e} (limit 1e-12 x {jmax:.4g})")
    say(f"  modes hermi=0: tile vs scatter |dJ| {dj:.3e} |dK| {dk:.3e} "
        f"(limit {MODE_TOL['tile']:g} x {scale:.4g}), |K - K^T| {asym:.3e}, "
        f"J equals J(sym part) bit for bit; omega=0.3: |dJ| {oj:.3e} |dK| "
        f"{ok_:.3e} (x {oscale:.4g}); stack [dm, dm/2] off by {d_stack:.3e} "
        f"(limit 1e-12 x {jmax:.4g})")

    _time_cd(ctx, mf, engines["block"])

    # incremental direct SCF against the direct run of this script
    mi = RHF(mf.mol, cutoff_fp32=mf.cutoff_fp32, cutoff_fp64=mf.cutoff_fp64,
             incremental=True)
    t0 = time.perf_counter()
    e_i = mi.kernel()
    torch.cuda.synchronize()
    wall_i = time.perf_counter() - t0
    de = abs(e_i - ctx["e_0029"])
    builds = {f"{k[0]}": v for k, v in sorted(
        mi.jk.plan_builds.items(), key=lambda kv: str(kv[0]))}
    say(f"  modes incremental RHF: E={e_i:.10f} |dE vs direct|={de:.2e} "
        f"conv_tol={mi.conv_tol:g} cycles={mi.scf_summary['cycles']} (direct "
        f"{mf.scf_summary['cycles']}) scf_wall_s={wall_i:.2f} (direct "
        f"{ctx['scf_wall']:.2f}) plan_build_s="
        f"{mi.jk.timing.get('plan_build_s', 0.0):.2f} plan builds per "
        f"bucket {builds}")
    check(mi.converged, "modes: incremental SCF not converged")
    check(de < 1e-8, f"modes: incremental E {e_i:.10f} vs direct "
          f"{ctx['e_0029']:.10f}")
    return (f"scatter {walls['scatter']:.3f} s, block {walls['block']:.3f} s "
            f"per warm get_jk (tile {ctx.get('jk_wall', float('nan')):.3f} "
            f"s); kernel D launches {ctx['launches_modes']['block']}; "
            f"incremental |dE| {de:.2e}")


def _byte_bound(T, nf, es, idx_bytes, ntgt):
    """ms to move T*(nf*es + idx_bytes) bytes in and 24 bytes per distinct
    target out at the card's memory rate."""
    return (T * (nf * es + idx_bytes) + 24 * ntgt) / PEAK_BYTES * 1e3


def _held_and_timed(dev, what, tier, e, shape, T, launch, plain, library):
    """``_held`` at a main-path chunk, then the times: ``library()`` is
    the yardstick call.  Returns (max abs error, kernel ms, plain ms,
    library ms)."""
    err, acc_k, acc_p = _held(dev, f"{what} at the main path's shapes", tier,
                              e, shape, T, launch, plain)
    return (err, cuda_ms(lambda: launch(acc_k, None), reps=20),
            cuda_ms(lambda: plain(acc_p), reps=20), cuda_ms(library, reps=20))


def _time_cd(ctx, mf, eng_b):
    """Kernels D and C against their plain versions and timed at the main
    path's shapes: D on the first chunk of the block plan's entry with
    the most values (its widest stream), C on the contracted K stream ac
    and the within-supertile indices of the first chunk of the tile
    plan's largest entry."""
    import torch
    from joltqc_tpu_torch.ops import accum as ac
    from joltqc_tpu_torch.ops import accum_tile as at
    from joltqc_tpu_torch.ops.eri import tier_dtype

    dev = eng_b.device
    dm_int = eng_b.layout.dm_to_internal(mf.dm)

    def chunk_streams(eng, entry):
        """The six contracted streams of the entry's first launch."""
        dm = torch.as_tensor(dm_int, dtype=tier_dtype(entry["tier"]),
                             device=dev).reshape(-1)
        tbls, idx, w, G = eng._chunk_eri(entry, 0)
        js, ks = eng._chunk_streams(entry, tbls, idx, w, G, dm)
        return idx, [(xy, v.contiguous()) for xy, v, _ in js + ks]

    def widest(entry):
        nfs = sorted((l + 1) * (l + 2) // 2 for l in entry["ls"])
        return nfs[-1] * nfs[-2]

    # ---- kernel D
    plan = eng_b._plans_full[0.0][0]
    e = max(ac.bound_exponent(x["bound"]) for x in plan)
    entry = max((x for x in plan if x["accum"] == "block"),
                key=lambda x: min(x["ntasks"], x["chunk"]) * widest(x))
    tier = entry["tier"]
    idx, streams = chunk_streams(eng_b, entry)
    xy, vals = max(streams, key=lambda st: st[1].shape[1])
    rowkey, _ = eng_b._block_keys(entry, 0, idx, xy)
    T, nf = vals.shape
    nrows = entry["nrows"]
    v64, k64 = vals.double(), rowkey.long()
    out64 = torch.zeros((nrows, nf), dtype=torch.float64, device=dev)
    err_d, ms_d, plain_d, lib_d = _held_and_timed(
        dev, f"accum_block {tier} {entry['ls']}", tier, e,
        (nrows, nf, ac.NLIMB), T,
        lambda acc, p: ac.accum_block_chunk(*_permuted(p, vals, rowkey),
                                            acc, e),
        lambda acc: ac.block_accumulate_plain(vals, rowkey, acc, e),
        lambda: out64.index_add_(0, k64, v64))
    ntgt = int(torch.unique(rowkey).numel()) * nf
    bound_d = _byte_bound(T, nf, vals.element_size(), 4, ntgt)
    ctx["kern_d"] = dict(
        name="accum_block_chunk", route="cuda",
        source="joltqc_tpu_torch/csrc/accum_block.cu",
        replaces="joltqc_tpu/ops/accum_pallas.py:124",
        launches=ctx["launches_modes"]["block"]["accum_block"],
        max_abs_err=err_d, ms=ms_d, plain_ms=plain_d, bound_ms=bound_d,
        bound_by="bytes", library_ms=lib_d,
    )
    say(f"  time accum_block: class {entry['ls']} {tier} stream {xy} T={T} "
        f"nf={nf} nrows={nrows}: kernel {ms_d:.3f} ms, plain {plain_d:.3f} "
        f"ms, index_add_ {lib_d:.3f} ms, bound {bound_d:.4f} ms ({ntgt} "
        f"targets); err / 2^e {err_d * 2.0 ** -e:.3e} (tol "
        f"{ACC_TOL[tier]:g}); permuted run bit-identical")

    # ---- kernel C
    eng = mf.jk
    W = eng.tile_w
    entry = max(eng._plan, key=lambda x: x["ntasks"] * _nfel(x))
    tier = entry["tier"]
    e = max(ac.bound_exponent(x["bound"]) for x in eng._plan)
    idx, streams = chunk_streams(eng, entry)
    cen = {"a": 0, "b": 1, "c": 2, "d": 3}
    streams = [(xy, v, (idx[cen[xy[0]]] % W).contiguous(),
                (idx[cen[xy[1]]] % W).contiguous()) for xy, v in streams]
    xy, vals, ix, iy = streams[2]  # K stream ac
    T, nf = vals.shape
    v64 = vals.double()
    flat = ix.long() * W + iy.long()
    out64 = torch.zeros((W * W, nf), dtype=torch.float64, device=dev)
    err_c, ms_c, plain_c, lib_c = _held_and_timed(
        dev, f"tile_accumulate {tier} {entry['ls']}", tier, e,
        (W, W, nf, ac.NLIMB), T,
        lambda acc, p: at.tile_accumulate_chunk(*_permuted(p, vals, ix, iy),
                                                acc, e),
        lambda acc: at.tile_accumulate_plain(vals, ix, iy, acc, e),
        lambda: out64.index_add_(0, flat, v64))
    ntgt = int(torch.unique(flat).numel()) * nf
    bound_c = _byte_bound(T, nf, vals.element_size(), 8, ntgt)
    # the public function on the six streams of that chunk (no engine
    # path calls it): its launches are counted here, and the decoded
    # tiles are held against float64 sums of the same values
    at.tile_accumulate_chunk.launches = 0
    worst = 0.0
    for sxy, v, sx, sy in streams:
        limbs, e_s = at.tile_accumulate(v, sx, sy, W, W, 2.0 ** (e - 1))
        want = torch.zeros((W * W, v.shape[1]), dtype=torch.float64,
                           device=dev).index_add_(0, sx.long() * W + sy.long(),
                                                  v.double())
        d = float((at.tile_limbs_to_f64(limbs, e_s).view(W * W, -1)
                   - want).abs().max())
        check(e_s == e and d < 1e-10 * 2.0 ** e, f"tile_accumulate stream "
              f"{sxy}: off the float64 sums by {d:.3e} vs 2^{e}")
        worst = max(worst, d)
    torch.cuda.synchronize()
    check(at.tile_accumulate_chunk.launches == len(streams),
          "tile_accumulate did not launch its kernel once per stream")
    ctx["kern_c"] = dict(
        name="tile_accumulate_chunk", route="cuda",
        source="joltqc_tpu_torch/csrc/accum_tile.cu",
        replaces="joltqc_tpu/ops/accum_tile.py:176",
        launches=at.tile_accumulate_chunk.launches,
        max_abs_err=err_c, ms=ms_c, plain_ms=plain_c, bound_ms=bound_c,
        bound_by="bytes", library_ms=lib_c,
    )
    say(f"  time tile_accumulate: class {entry['ls']} {tier} stream {xy} "
        f"T={T} nf={nf} W={W}: kernel {ms_c:.3f} ms, plain {plain_c:.3f} ms, "
        f"index_add_ {lib_c:.3f} ms, bound {bound_c:.4f} ms ({ntgt} "
        f"targets); err / 2^e {err_c * 2.0 ** -e:.3e} (tol "
        f"{ACC_TOL[tier]:g}); six streams through tile_accumulate off the "
        f"float64 sums by {worst * 2.0 ** -e:.3e} of 2^e, launches "
        f"{at.tile_accumulate_chunk.launches}")


# ------------------------------------------------------------ phase 8
WATERS = """O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696;
O 8 0 0.1174; H 7.243 0 -0.4696; H 8.757 0 -0.4696"""
NELEC_0029 = 152


def _oracle_rks(mol, xc, grids, eri, conv_tol=1e-10, max_cycle=50,
                h_ecp=None):
    """Dense-float64 RKS on the host: the port's intor_np ERIs (``eri``,
    by omega) and numint_np on ``grids``, its eval_xc in float64 on the
    CPU, in the loop of tests/test_dft_oracle_scf.py::oracle_rks (no
    VV10); ``h_ecp``, an ECP matrix, is added to hcore."""
    import numpy as np
    from scipy.linalg import eigh
    from joltqc_tpu_torch.dft.xc import rsh_coeff, xc_family
    from joltqc_tpu_torch.mol import intor_np
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.mol.numint_np import eval_rho_np, eval_vxc_np
    from joltqc_tpu_torch.scf.diis import DIIS

    layout = BasisLayout(mol)
    fam = xc_family(xc)
    omega, alpha, hyb = rsh_coeff(xc)
    s = intor_np.overlap(mol)
    h = intor_np.kinetic(mol) + intor_np.nuclear(mol)
    if h_ecp is not None:
        h = h + h_ecp
    nocc = mol.nelectron // 2
    _, c = eigh(h, s)
    dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
    diis = DIIS()
    e_last = 0.0
    w = grids.weights
    for cycle in range(max_cycle):
        dm_int = layout.dm_to_internal(dm)
        rho = eval_rho_np(layout, grids.coords, dm_int, fam)
        exc, wv = _xc_rows(xc, w, rho, "cpu")
        vxc = layout.mat_to_mol(eval_vxc_np(layout, grids.coords, wv, fam))
        vj = np.einsum("ijkl,kl->ij", eri[0.0], dm)
        veff = vxc + vj
        if hyb > 0 or omega > 0:
            vk = hyb * np.einsum("ikjl,kl->ij", eri[0.0], dm)
            if omega > 0 and abs(alpha - hyb) > 1e-12:
                vk = vk + (alpha - hyb) * np.einsum("ikjl,kl->ij",
                                                    eri[omega], dm)
            veff -= 0.5 * vk
            exc -= 0.25 * float(np.einsum("ij,ij->", dm, vk))
        e_tot = (float(np.einsum("ij,ij->", dm, h))
                 + 0.5 * float(np.einsum("ij,ij->", dm, vj)) + exc
                 + mol.energy_nuc())
        f = diis.update(s, dm, h + veff)
        _, c = eigh(f, s)
        dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
        if abs(e_tot - e_last) < conv_tol and cycle > 0:
            return e_tot
        e_last = e_tot
    raise PhaseError(f"oracle RKS {xc}: not converged")


def _device_ms(fn, top=0):
    """(device ms, wall ms, the ``top`` kernels [(ms, calls, name)]) of one
    call of fn() on the card (torch.profiler); device ms None when the
    profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    dev = sum(r[0] for r in rows)
    return (dev if rows else None), wall, rows[:top]


def _xc_rows(xc, w, rho, device):
    """Exc and the potential rows wv of rho rows on a grid of weights w,
    as RKS.get_veff forms them (no VV10)."""
    import numpy as np
    from joltqc_tpu_torch.dft.xc import eval_xc, xc_family

    fam = xc_family(xc)
    sigma = (rho[1:4] ** 2).sum(axis=0) if fam != "lda" else None
    tau = rho[4] if fam == "mgga" else None
    e, vr, vs, vt = eval_xc(xc, rho[0], sigma, tau, device=device)
    if fam == "lda":
        return float(np.sum(w * e)), (w * vr)[None, :]
    rows = [(w * vr)[None, :], 2.0 * (w * vs)[None, :] * rho[1:4]]
    if fam == "mgga":
        rows.append((w * vt)[None, :])
    return float(np.sum(w * e)), np.concatenate(rows)


def _plain_fp64_xc(mf, dm_int, chunk=32768):
    """Exc and V_xc (internal basis) of dm_int on mf's grid by a plain
    float64 evaluation on the card: every AO of every shell at every
    point, dense float64 products (independent of the port's numint)."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops.harmonics import cart_components

    dev = mf.device
    lay, fam = mf.layout, mf.family
    nrow = {"lda": 1, "gga": 4, "mgga": 5}[fam]
    pts_all = torch.as_tensor(mf.grids.coords, dtype=torch.float64,
                              device=dev)
    dm = torch.as_tensor(dm_int, dtype=torch.float64, device=dev)
    shells = [(lay.ao_loc_int[i], sh.l,
               torch.as_tensor(sh.coord, dtype=torch.float64, device=dev),
               torch.as_tensor(sh.exps, dtype=torch.float64, device=dev),
               torch.as_tensor(sh.coeffs, dtype=torch.float64, device=dev))
              for i, sh in enumerate(mf.mol.shells)]

    def aos(pts):
        out = torch.zeros((4, len(pts), lay.nao_int), dtype=torch.float64,
                          device=dev)
        for col, l, c, e, k in shells:
            rel = pts - c
            ex = torch.exp(-e[None, :] * (rel * rel).sum(1)[:, None])
            rad, drad = ex @ k, ex @ (-2.0 * e * k)
            for f, p in enumerate(cart_components(l)):
                mono = rel[:, 0] ** p[0] * rel[:, 1] ** p[1] * rel[:, 2] ** p[2]
                out[0, :, col + f] = rad * mono
                for d in range(3):
                    g = drad * rel[:, d] * mono
                    if p[d]:
                        q = list(p)
                        q[d] -= 1
                        g = g + rad * p[d] * (rel[:, 0] ** q[0]
                                              * rel[:, 1] ** q[1]
                                              * rel[:, 2] ** q[2])
                    out[1 + d, :, col + f] = g
        return out

    rho = torch.zeros((nrow, len(pts_all)), dtype=torch.float64, device=dev)
    for p0 in range(0, len(pts_all), chunk):
        a = aos(pts_all[p0:p0 + chunk])
        t = a[0] @ dm
        r = [(t * a[0]).sum(1)]
        if fam != "lda":
            r += [2.0 * (t * a[1 + d]).sum(1) for d in range(3)]
        if fam == "mgga":
            r.append(0.5 * sum(((a[1 + d] @ dm) * a[1 + d]).sum(1)
                               for d in range(3)))
        rho[:, p0:p0 + chunk] = torch.stack(r)
    exc, wv = _xc_rows(mf.xc, mf.grids.weights, rho.cpu().numpy(), dev)
    wv = torch.as_tensor(wv, dtype=torch.float64, device=dev)
    half = torch.zeros((lay.nao_int,) * 2, dtype=torch.float64, device=dev)
    for p0 in range(0, len(pts_all), chunk):
        a = aos(pts_all[p0:p0 + chunk])
        w = wv[:, p0:p0 + chunk]
        mid = a[0] * (0.5 * w[0])[:, None]
        if fam != "lda":
            for d in range(3):
                mid = mid + a[1 + d] * w[1 + d][:, None]
        half += a[0].T @ mid
        if fam == "mgga":
            for d in range(3):
                half += a[1 + d].T @ (a[1 + d] * (0.25 * w[4])[:, None])
    return exc, (half + half.T).cpu().numpy(), rho.cpu().numpy()


def _dft_h2o(eri_h2o, xcs):
    """(1) H2O/6-31g RKS, VV10 off, against the host oracle, 1e-8 Eh."""
    from joltqc_tpu_torch.dft import Grids
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.scf import RKS

    mol = Molecule.from_atom_string(H2O, basis="6-31g")
    grids = Grids(mol, n_rad=50, n_theta=12).build()
    out = []
    for xc in xcs:
        e_ref = _oracle_rks(mol, xc, grids, eri_h2o)
        mf = RKS(mol, xc=xc, grids=grids, nlc=False, conv_tol=1e-10)
        e = mf.kernel()
        check(mf.converged, f"H2O/6-31g {xc}: not converged")
        check(abs(e - e_ref) < 1e-8, f"H2O/6-31g {xc}: E {e:.10f} vs oracle "
              f"{e_ref:.10f} (|dE| {abs(e - e_ref):.2e})")
        out.append(f"{xc} |dE|={abs(e - e_ref):.1e}")
    say("  dft (1) H2O/6-31g vs the float64 oracle (tol 1e-8): "
        + ", ".join(out))


def _dft_vv10():
    """(2) wb97x-v with VV10 on a shared grid and on nlcgrids=True; the
    VV10 energy at each converged density against nlc_exc_vxc_np."""
    from joltqc_tpu_torch.dft import Grids
    from joltqc_tpu_torch.dft.vv10 import nlc_exc_vxc, nlc_exc_vxc_np
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.mol.numint_np import eval_rho_np
    from joltqc_tpu_torch.scf import RKS

    mol = Molecule.from_atom_string(H2O, basis="6-31g")
    grids = Grids(mol, n_rad=40, n_ang=110).build()
    e_off = RKS(mol, xc="wb97x-v", grids=grids, nlc=False,
                conv_tol=1e-9).kernel()
    out = []
    for label, kw in (("shared", {}), ("nlcgrids", {"nlcgrids": True})):
        mf = RKS(mol, xc="wb97x-v", grids=grids, conv_tol=1e-9, **kw)
        e = mf.kernel()
        check(mf.converged, f"wb97x-v VV10 {label}: not converged")
        g = mf.nlcgrids or mf.grids
        rho = eval_rho_np(mf.layout, g.coords,
                          mf.layout.dm_to_internal(mf.dm), "gga")
        sigma = (rho[1:4] ** 2).sum(0)
        b, C = mf.nlc
        e_nlc, _, _ = nlc_exc_vxc(g.coords, g.weights, rho[0], sigma, b, C,
                                  device=mf.device)
        e_np = nlc_exc_vxc_np(g.coords, g.weights, rho[0], sigma, b, C)
        rel = abs(e_nlc - e_np) / abs(e_np)
        check(rel < 1e-5, f"wb97x-v VV10 {label}: E_nlc {e_nlc:.10f} vs "
              f"numpy {e_np:.10f} (rel {rel:.2e})")
        check(abs(e - e_off) > 1e-4, f"wb97x-v VV10 {label}: no VV10 shift")
        out.append(f"{label} ({g.size} points): E={e:.10f} "
                   f"E-E(nlc off)={e - e_off:.6f} E_nlc rel err {rel:.1e}")
    say("  dft (2) H2O/6-31g wb97x-v with VV10 (tol rel 1e-5): "
        + "; ".join(out))


def _dft_waters(eri_w):
    """(3) two waters, pbe, incremental: screening engaged, mixed tier
    on, E against the oracle to 1e-8, fewer block evaluations."""
    from joltqc_tpu_torch.dft import Grids
    from joltqc_tpu_torch.dft.numint import NumInt
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.scf import RKS

    mol = Molecule.from_atom_string(WATERS, basis="6-31g")
    grids = Grids(mol, n_rad=40, n_theta=10, block=256).build()
    e_ref = _oracle_rks(mol, "pbe", grids, eri_w)
    mf = RKS(mol, xc="pbe", grids=grids, conv_tol=1e-10, max_cycle=40,
             incremental=True)
    mf.ni = NumInt(mf.layout, block=256)
    mf.screen_thresh = 1e-12
    e = mf.kernel()
    scr = mf._screening()
    ncyc = mf.scf_summary["cycles"]
    nblk = len(mf._block_bounds())
    check(mf.converged, "two waters: not converged")
    check(scr is not None, "two waters: screening did not engage")
    check(mf.dft_cutoff_fp64 is not None, "two waters: mixed tier off")
    check(abs(e - e_ref) < 1e-8, f"two waters: E {e:.10f} vs oracle "
          f"{e_ref:.10f}")
    check(mf.dft_block_evals < 2 * ncyc * nblk, f"two waters: "
          f"{mf.dft_block_evals} block evaluations, not < 2 x {ncyc} x {nblk}")
    say(f"  dft (3) two waters pbe incremental: E={e:.10f} |dE vs oracle|="
        f"{abs(e - e_ref):.1e} (tol 1e-8), fill {scr.fill_fraction:.3f}, "
        f"block evals {mf.dft_block_evals} < 2 x {ncyc} cycles x {nblk}")


def _dft_0029(ctx, grids):
    """(4) 0029 B3LYP/6-31g* at full width with the default grid and
    cutoffs: convergence, kernels A and B launched, the grid's electron
    count, and Exc/Vxc of the mixed path against a plain float64
    evaluation at the converged density."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.dft.mixed import heavy_shell_pairs
    from joltqc_tpu_torch.dft.screening import GridScreening
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.ops.accum_tile import accum_tile_chunk as acc_k
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.scf import RKS

    mol = Molecule.from_xyz_file(XYZ_0029, basis="6-31g*")
    check(mol.nao == 302, f"0029: nao {mol.nao}, want 302")
    mf = RKS(mol, xc="b3lyp", grids=grids, conv_tol=1e-9, verbose=1)
    eri_k.launches = acc_k.launches = 0
    t0 = time.perf_counter()
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"eri": eri_k.launches, "accum_tile": acc_k.launches}
    ctx["launches_dft"] = launches
    s = mf.scf_summary
    scr = mf._screening()
    fill = GridScreening(mf.ni, grids, mf.screen_thresh).fill_fraction
    dm_int = mf.layout.dm_to_internal(mf.dm)
    D = mf.layout.dm_cond(dm_int)
    n_rho = len(heavy_shell_pairs(mf.layout, np.log(np.maximum(D, 1e-300)),
                                  mf.dft_cutoff_fp64)[0])
    rho_m = mf._rho_eval(dm_int, mf.family)
    exc_m, wv = _xc_rows(mf.xc, grids.weights, rho_m, mf.device)
    wlog = np.full((mf.layout.nbas,) * 2, np.log(np.sum(np.abs(wv)) + 1e-300))
    n_vxc = len(heavy_shell_pairs(mf.layout, wlog, mf.dft_cutoff_fp64)[0])
    npairs = mf.layout.nbas * (mf.layout.nbas + 1) // 2
    tm = mf.jk.timing
    say(f"  dft (4) 0029 B3LYP/6-31g*: E={e:.10f} cycles={s['cycles']} "
        f"converged={mf.converged} scf_wall_s={wall:.2f} plan_build_s="
        f"{tm.get('plan_build_s', 0.0):.2f} plan_builds="
        f"{tm.get('plan_builds', 0)} get_jk_s={mf.veff_time['jk']:.2f} "
        f"dft_layer_s={mf.veff_time['dft']:.2f} int1e_s={s['int1e_time']:.2f} "
        f"grid_points={grids.size} padded={len(grids.coords)} blocks="
        f"{len(grids.coords) // mf.ni.block} screening="
        f"{'on' if scr is not None else 'off'} (fill {fill:.4f}, engages "
        f"below 0.6) heavy shell pairs rho {n_rho} vxc {n_vxc} of {npairs} "
        f"nelec_grid={mf._nelec_grid:.8f} launches={launches}")
    check(mf.converged, "0029 B3LYP: SCF not converged")
    check(launches["eri"] > 0 and launches["accum_tile"] > 0,
          "0029 B3LYP: kernel A or B not launched on the RKS path")
    vxc_m = mf._vxc_eval(wv, mf.family)
    exc_p, vxc_p, rho_p = _plain_fp64_xc(mf, dm_int)
    d_exc = abs(exc_m - exc_p)
    d_vxc = float(np.abs(vxc_m - vxc_p).max())
    say(f"  dft (4) mixed path vs plain float64 on the card, converged "
        f"density: Exc {exc_m:.10f} vs {exc_p:.10f} |dExc|={d_exc:.2e} (tol "
        f"1e-7), max|dVxc|={d_vxc:.2e} (max|Vxc| "
        f"{float(np.abs(vxc_p).max()):.4g})")
    check(np.isfinite(exc_m) and d_exc < 1e-7,
          f"0029 B3LYP: |dExc| {d_exc:.2e} vs plain float64")
    # electrons: of the density (tr DS), and on the grid by the mixed path
    # and by the plain float64 evaluation; the grid's own quadrature error
    # is |n_fp64 - tr DS|, the port's numerics |n_mixed - n_fp64|
    w = grids.weights
    n_dm = float(np.einsum("ij,ji->", mf.dm, mf.get_ovlp()))
    n_mixed = float(np.sum(w * rho_m[0]))
    n_fp64 = float(np.sum(w * rho_p[0]))
    say(f"  dft (4) electrons at the converged density: tr(DS) {n_dm:.10f}; "
        f"on the grid: mixed path {n_mixed:.10f}, plain float64 "
        f"{n_fp64:.10f}; |n_mixed - n_fp64| {abs(n_mixed - n_fp64):.2e} (tol "
        f"1e-7); grid quadrature |n_fp64 - {NELEC_0029}| "
        f"{abs(n_fp64 - NELEC_0029):.3e} (1e-4 not met above it)")
    check(abs(n_dm - NELEC_0029) < 1e-8,
          f"0029 B3LYP: tr(DS) {n_dm:.10f} vs {NELEC_0029}")
    check(abs(n_mixed - n_fp64) < 1e-7,
          f"0029 B3LYP: grid electrons {n_mixed:.10f} vs plain float64 "
          f"{n_fp64:.10f}")

    # device time of one get_veff's DFT pieces on the converged density
    # (the profiler's first use in a process pays its own start-up: warm)
    fam = mf.family
    _device_ms(lambda: mf._rho_eval(dm_int, fam))
    prof = {"rho": _device_ms(lambda: mf._rho_eval(dm_int, fam), top=4),
            "xc": _device_ms(lambda: _xc_rows(mf.xc, grids.weights, rho_m,
                                               mf.device), top=2),
            "vxc": _device_ms(lambda: mf._vxc_eval(wv, fam), top=4),
            "get_veff with J/K": _device_ms(lambda: mf.get_veff(mf.dm))}
    for name, (dev_ms, wall_ms, top) in prof.items():
        say(f"  dft (4) profile {name} on the converged density: "
            + (f"device {dev_ms:.3f} ms" if dev_ms is not None
               else "device not measured") + f", wall {wall_ms:.3f} ms")
        for ms, n, key in top:
            say(f"  dft (4) profile {name}: {ms:10.3f} ms x{n:<5d} {key[:70]}")
    return e, s["cycles"], wall


def _grid_0029():
    """The default grid of 0029 (host numpy, about a minute and a half):
    built in a worker process while the smaller runs go on."""
    sys.path.insert(0, HERE)
    from joltqc_tpu_torch.dft import Grids
    from joltqc_tpu_torch.mol import Molecule

    t0 = time.perf_counter()
    grids = Grids(Molecule.from_xyz_file(XYZ_0029, basis="6-31g*")).build()
    return grids, time.perf_counter() - t0


def _eri_by_omega(mol, xcs):
    """Dense ERIs of intor_np for omega 0 and each range separation."""
    from joltqc_tpu_torch.dft.xc import rsh_coeff
    from joltqc_tpu_torch.mol import intor_np

    omegas = {0.0} | {rsh_coeff(xc)[0] for xc in xcs}
    return {om: intor_np.eri(mol, omega=om) for om in sorted(omegas)}


def phase_dft(ctx):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from joltqc_tpu_torch.mol import Molecule

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        grid = pool.submit(_grid_0029)
        xcs = ("lda,vwn", "pbe", "b3lyp", "wb97x-v")
        _dft_h2o(_eri_by_omega(Molecule.from_atom_string(H2O, basis="6-31g"),
                               xcs), xcs)
        _dft_vv10()
        _dft_waters(_eri_by_omega(
            Molecule.from_atom_string(WATERS, basis="6-31g"), ("pbe",)))
        grids, grid_s = grid.result()
    say(f"  dft 0029 default grid built in {grid_s:.1f} s (host numpy, in "
        "a worker process during (1)-(3))")
    e, ncyc, wall = _dft_0029(ctx, grids)
    return (f"0029 B3LYP/6-31g* E={e:.10f} in {ncyc} cycles, SCF wall "
            f"{wall:.1f} s; RKS path launches {ctx['launches_dft']}")


# ------------------------------------------------------------ phase 9
# ECP data of the JAX package's tests/test_ecp.py: a model O ECP, an
# s-only H ECP, and the Na 10-core ECP of the reference's own suite
# (public GPU4PySCF test data; channels ul + S..G) with a Na valence basis
ECP_O = """ECP
O nelec 2
O ul
2 1.24 -2.30
1 4.50 1.10
0 3.00 2.00
O S
2 5.35 10.2
2 1.04 2.29
O P
2 2.45 5.10
END"""
ECP_H = """ECP
H nelec 0
H ul
2 2.0 -1.5
H S
2 3.5 0.8
END"""
ECP_NA = """ECP
Na nelec 10
Na ul
2       1.0                   0.5
Na S
2      13.652203             732.2692
2       6.826101              26.484721
Na P
2      10.279868             299.489474
2       5.139934              26.466234
Na D
2       7.349859             124.457595
2       3.674929              14.035995
Na F
2       3.034072              21.531031
Na G
2       4.808857             -21.607597
END"""
NA_BASIS = """BASIS "ao basis" PRINT
Na    S
      1.8        0.4
      0.6        0.7
Na    S
      0.25       1.0
Na    P
      0.9        1.0
Na    D
      0.5        1.0
END"""
# NaH/sto-3g with the shipped model ECP: the JAX package's anchor
# (tests/test_ecp_data.py, an all-numpy RHF)
E_NAH_MODEL = -0.7088327233
# 0029-Na+: Na 2.25 A beyond O15 on the C14=O15 axis (0-based atoms)
NA_0029 = "Na 4.1338 -3.1001 1.6996"
O15 = 15
ECP_FD_H = 1e-4  # Angstrom


def _ecp_mol(case):
    """The ECP phase's molecules by name, in this process or a worker."""
    from joltqc_tpu_torch.mol import Molecule

    if case == "h2":
        return Molecule.from_atom_string("H 0 0 0; H 0 0 1.2", basis="sto-3g",
                                         ecp=ECP_H)
    if case == "oh":
        return Molecule.from_atom_string("O 0 0 0; H 0 0 1.9", basis="sto-3g",
                                         charge=1, ecp=ECP_O)
    if case == "na2":
        path = os.path.join(HERE, "joltqc_tpu_torch", "_build",
                            "na_valence.dat")
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path + f".{os.getpid()}", "w") as f:
                f.write(NA_BASIS)
            os.replace(path + f".{os.getpid()}", path)
        return Molecule.from_atom_string("Na 0.5 0.5 0; Na 0 1.0 1.0",
                                         basis=path, ecp=ECP_NA)
    if case == "nah":
        return Molecule.from_atom_string("Na 0 0 0; H 0 0 1.89",
                                         basis="sto-3g", ecp="jqc-model")
    if case == "0029na":
        return Molecule.from_atom_string(_atoms_0029na(), basis="6-31g*",
                                         charge=1, ecp=ECP_NA)
    raise ValueError(case)


def _atoms_0029na(shift=None):
    """0029 with Na+; ``shift`` (atom, dz in Angstrom) moves one atom."""
    with open(XYZ_0029) as f:
        lines = f.read().splitlines()
    rows = [ln.split()[:4] for ln in lines[2:2 + int(lines[0])]]
    rows.append(NA_0029.split())
    if shift is not None:
        ia, dz = shift
        rows[ia][3] = repr(float(rows[ia][3]) + dz)
    return "\n".join(" ".join(r) for r in rows)


def _w_ecp_matrix(case):
    """(worker) The port's float64 oracle ECP matrix, molecular basis."""
    sys.path.insert(0, HERE)
    from joltqc_tpu_torch.mol.ecp_np import ecp_matrix_np
    from joltqc_tpu_torch.mol.layout import BasisLayout

    mol = _ecp_mol(case)
    lay = BasisLayout(mol)
    return lay.mat_to_mol(ecp_matrix_np(mol, lay))


def _w_oracle_rhf(case):
    """(worker) Dense float64 RHF on the host with the ECP in hcore: the
    port's intor_np and ecp_np, the loop of tests/test_ecp.py."""
    sys.path.insert(0, HERE)
    import numpy as np
    from scipy.linalg import eigh
    from joltqc_tpu_torch.mol import intor_np
    from joltqc_tpu_torch.scf.diis import DIIS

    mol = _ecp_mol(case)
    s = intor_np.overlap(mol)
    h = (intor_np.kinetic(mol) + intor_np.nuclear(mol)
         + _w_ecp_matrix(case))
    eri = intor_np.eri(mol)
    nocc = mol.nelectron // 2
    _, c = eigh(h, s)
    dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
    diis = DIIS()
    e_last = 0.0
    for cycle in range(60):
        vj = np.einsum("ijkl,kl->ij", eri, dm)
        vk = np.einsum("ikjl,kl->ij", eri, dm)
        e = float(np.einsum("ij,ij->", dm, h)
                  + 0.5 * np.einsum("ij,ij->", dm, vj - 0.5 * vk)) \
            + mol.energy_nuc()
        _, c = eigh(diis.update(s, dm, h + vj - 0.5 * vk), s)
        dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
        if abs(e - e_last) < 1e-11 and cycle > 0:
            return e
        e_last = e
    raise PhaseError(f"oracle RHF {case}: not converged")


def _ecp_grids(mol):
    from joltqc_tpu_torch.dft import Grids

    return Grids(mol, n_rad=50, n_theta=12).build()


def _w_oracle_rks_nah():
    """(worker) NaH pbe with jqc-model: the host float64 RKS oracle."""
    sys.path.insert(0, HERE)
    from joltqc_tpu_torch.mol import intor_np

    mol = _ecp_mol("nah")
    return _oracle_rks(mol, "pbe", _ecp_grids(mol),
                       {0.0: intor_np.eri(mol)}, h_ecp=_w_ecp_matrix("nah"))


def _w_ecp_blocks(pairs):
    """(worker) ecp_np's internal cartesian blocks <i|U|j> of 0029-Na+
    for shell pairs i >= j, summed over the Na channels."""
    sys.path.insert(0, HERE)
    from joltqc_tpu_torch.mol.ecp_np import type1_cart_np, type2_cart_np

    mol = _ecp_mol("0029na")
    na = mol.natm - 1
    C = mol.coords[na]
    data = mol.ecp["Na"]
    out = []
    for i, j in pairs:
        si, sj = mol.shells[i], mol.shells[j]
        blk = 0.0
        for ch in data.channels:
            fn = type1_cart_np if ch.l < 0 else type2_cart_np
            blk = blk + fn(si, sj, C, ch)
        out.append(blk)
    return out


def _sample_pairs(eng, mol, n=300, seed=29):
    """A seeded sample of >= n shell pairs (i >= j) that hold ECP tasks:
    ten (or all) of every (l_i, l_j), forty Na-Na pairs, the rest drawn
    at random."""
    import numpy as np

    na = mol.natm - 1
    pairs = set()
    for ci, cj, _icen, si, sj in eng._chunks():
        a = eng.classes[ci].shell_ids[si]
        b = eng.classes[cj].shell_ids[sj]
        pairs.update(zip(np.maximum(a, b).tolist(), np.minimum(a, b).tolist()))
    pairs = sorted(pairs)
    rng = np.random.default_rng(seed)
    ls = {p: (mol.shells[p[0]].l, mol.shells[p[1]].l) for p in pairs}
    nana = [p for p in pairs if mol.shells[p[0]].atom_idx == na
            and mol.shells[p[1]].atom_idx == na]
    pick = set()
    for key in sorted(set(ls.values())):
        group = [p for p in pairs if ls[p] == key]
        for k in rng.permutation(len(group))[:10]:
            pick.add(group[k])
    for k in rng.permutation(len(nana))[:40]:
        pick.add(nana[k])
    rest = [p for p in pairs if p not in pick]
    for k in rng.permutation(len(rest))[:max(0, n - len(pick))]:
        pick.add(rest[k])
    return sorted(pick), sorted(set(ls.values())), nana


ECP_METHODS = ("build", "gradient", "build_ip", "ipipv", "ipvip")


def _ecp_methods(eng, nao):
    """The five results of one ECP engine; the gradient on a seeded
    symmetric density."""
    import numpy as np

    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (nao, nao))
    dm = a + a.T
    return {"build": eng.build(), "gradient": eng.gradient(dm),
            "build_ip": eng.build_ip(), "ipipv": eng.build_ipip("ipipv"),
            "ipvip": eng.build_ipip("ipvip")}


def _w_ecp_cpu(case):
    """(worker) The five results of the same engine on the CPU."""
    sys.path.insert(0, HERE)
    import torch
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.scf import ECPEngine

    torch.set_num_threads(1)
    mol = _ecp_mol(case)
    return _ecp_methods(ECPEngine(BasisLayout(mol), device="cpu"), mol.nao)


def _ecp_engine_checks(case, cpu, oracle):
    """(1) one case: build, gradient, build_ip and both build_ipip on the
    card against the same engine on the CPU (``cpu``, from a worker; 1e-12
    of max(1, max |value|): a float64 ulp of the second derivatives'
    largest entries, ~1e4 Eh/a0^2 at O-H, is itself above 1e-12), build
    against the port's ecp_np (``oracle``, 5e-11)."""
    import numpy as np
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.scf import ECPEngine

    mol = _ecp_mol(case)
    card = ECPEngine(BasisLayout(mol))
    check(card.device.type == "cuda", f"ECP {case}: engine on {card.device}")
    got = _ecp_methods(card, mol.nao)
    worst = {}
    for name in ECP_METHODS:
        ref = cpu[name]
        check(np.isfinite(got[name]).all() and got[name].shape == ref.shape,
              f"ECP {case} {name}: shape or NaN")
        scale = max(1.0, float(np.abs(ref).max()))
        worst[name] = (float(np.abs(got[name] - ref).max()), scale)
        check(worst[name][0] < 1e-12 * scale, f"ECP {case} {name}: card vs "
              f"cpu {worst[name][0]:.3e} (max |value| {scale:.3e})")
    err = float(np.abs(got["build"] - oracle).max())
    check(err < 5e-11, f"ECP {case}: build vs ecp_np {err:.3e}")
    say(f"  ecp (1) {case} ({mol.nao} AO, {card.last_run['tasks']} tasks): "
        "card vs cpu max |d| (max |value|) " + ", ".join(
            f"{k} {d:.1e} ({s:.1e})" for k, (d, s) in worst.items())
        + f" (tol 1e-12 x max(1, max |value|)); build vs ecp_np {err:.1e} "
        "(tol 5e-11)")


def _ecp_timed(fn, by_name=None):
    """(result, wall s, device ms or None, kernel launches) of fn() on
    the card: the wall of a synchronised call, then the device time and
    launch count of a second call from the profiler's raw device events
    (its key_averages parses 1e5 launches in Python for a minute).
    ``by_name``: a dict to fill with kernel name -> [ns, launches]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ns = launches = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev_ns += ev.duration_ns()
            launches += not ev.name().startswith(("Memcpy", "Memset"))
            if by_name is not None:
                row = by_name.setdefault(ev.name(), [0, 0])
                row[0] += ev.duration_ns()
                row[1] += 1
    return out, wall, (dev_ns / 1e6 if dev_ns else None), launches


def _ecp_0029(ctx, parts, pairs, lpairs, nana):
    """(4) 0029-Na+ RHF/6-31g* with the full-channel Na ECP; ``parts``,
    the futures of ecp_np's blocks of ``pairs``, in order."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.mol.elements import BOHR
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.ops.accum_tile import accum_tile_chunk as acc_k
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.scf import ECPEngine, RHF

    t_in = time.perf_counter()
    mol = _ecp_mol("0029na")
    check(mol.nao == 351 and mol.nelectron == 152,
          f"0029-Na+: nao {mol.nao}, nelectron {mol.nelectron}")
    mf = RHF(mol, cutoff_fp32=1e-13, cutoff_fp64=1e-6)
    eri_k.launches = eri_k.generic_launches = acc_k.launches = 0
    t0 = time.perf_counter()
    e = mf.kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"eri": eri_k.launches, "accum_tile": acc_k.launches,
                "eri_generic": eri_k.generic_launches}
    s = mf.scf_summary
    plan_s = mf.jk.timing.get("plan_build_s", 0.0)
    say(f"  ecp (4) 0029-Na+ RHF/6-31g*: E={e:.10f} cycles={s['cycles']} "
        f"converged={mf.converged} scf_wall_s={wall:.2f} plan_build_s="
        f"{plan_s:.2f} ({100 * plan_s / wall:.0f}% of the wall) int1e+ecp_s="
        f"{s['int1e_time']:.2f} setup_s={t0 - t_in:.1f} launches={launches}")
    check(mf.converged and np.isfinite(e), "0029-Na+: SCF not converged")
    check(eri_k.launches > 0 and acc_k.launches > 0,
          "0029-Na+: kernel A or B was not launched")
    check(eri_k.generic_launches == 0, f"0029-Na+: {eri_k.generic_launches} "
          "ERI launches took the generic route")
    ctx["e_0029na"] = e

    t_step = time.perf_counter()
    eng = ECPEngine(mf.layout)
    cold = time.perf_counter()
    eng.build()
    torch.cuda.synchronize()
    cold = time.perf_counter() - cold
    V, b_wall, b_dev, b_launch = _ecp_timed(eng.build_int)
    b_run = dict(eng.last_run)
    dm = mf.dm
    grad, g_wall, g_dev, g_launch = _ecp_timed(lambda: eng.gradient(dm))
    g_run = dict(eng.last_run)
    check(np.isfinite(V).all() and np.isfinite(grad).all(),
          "0029-Na+: ECP matrix or gradient not finite")
    for label, w, d, n, run in (("build", b_wall, b_dev, b_launch, b_run),
                                ("gradient", g_wall, g_dev, g_launch, g_run)):
        say(f"  ecp (4) ECP {label}: wall {w:.3f} s (first build {cold:.3f} "
            "s), device " + (f"{d:.1f} ms" if d is not None else
                             "not measured")
            + f", {n} kernel launches, {run['chunks']} chunks, "
            f"{run['tasks']} tasks, {run['evaluations']} chunk evaluations")
    say(f"  ecp (4) ECP timing with its profiles: "
        f"{time.perf_counter() - t_step:.1f} s")

    # the matrix on a seeded sample of shell-pair blocks against ecp_np
    t_step = time.perf_counter()
    al = mf.layout.ao_loc_int
    ref = [b for f in parts for b in f.result()]
    err = max(float(np.abs(V[al[i]:al[i + 1], al[j]:al[j + 1]] - r).max())
              for (i, j), r in zip(pairs, ref))
    n_nana = len([p for p in pairs if p in set(nana)])
    say(f"  ecp (4) ECP matrix vs ecp_np on {len(pairs)} sampled shell-pair "
        f"blocks ((l_i, l_j) {lpairs}, {n_nana} Na-Na): max |d| {err:.2e} "
        f"(tol 5e-11; waited {time.perf_counter() - t_step:.1f} s for them)")
    check(len(pairs) >= 300 and n_nana > 0, "0029-Na+: block sample too small")
    check(err < 5e-11, f"0029-Na+: ECP blocks vs ecp_np {err:.3e}")

    # z gradient on Na and O15 against central differences of tr(D V_ecp)
    t_step = time.perf_counter()
    na = mol.natm - 1
    out = []
    for ia in (na, O15):
        e_pm = []
        for dz in (ECP_FD_H, -ECP_FD_H):
            m = Molecule.from_atom_string(_atoms_0029na((ia, dz)),
                                          basis="6-31g*", charge=1, ecp=ECP_NA)
            e_pm.append(float(np.sum(dm * ECPEngine(BasisLayout(m)).build())))
        fd = (e_pm[0] - e_pm[1]) / (2 * ECP_FD_H / BOHR)
        d = abs(fd - grad[ia, 2])
        out.append(f"{mol.atom_symbols[ia]}{ia} dE/dz {grad[ia, 2]:.10f} fd "
                   f"{fd:.10f} |d| {d:.1e}")
        check(d < 1e-6, f"0029-Na+: ECP gradient z on atom {ia} "
              f"{grad[ia, 2]:.10f} vs fd {fd:.10f}")
    say("  ecp (4) ECP gradient vs central differences (h = 1e-4 A, tol "
        f"1e-6; {time.perf_counter() - t_step:.1f} s): " + "; ".join(out))
    return e, s["cycles"], wall


def _one_thread():
    """Pool initializer: one BLAS / OpenMP thread per worker (set before
    the worker imports numpy), so that the workers leave the cores to
    the process that drives the card."""
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"


def phase_ecp(ctx):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.scf import RHF, RKS, ECPEngine

    # the host oracles and the CPU engine run in worker processes while
    # the card runs 0029-Na+ first
    mol_big = _ecp_mol("0029na")
    pairs, lpairs, nana = _sample_pairs(ECPEngine(BasisLayout(mol_big)),
                                        mol_big)
    nwork = max(2, min(6, (os.cpu_count() or 4) - 2))
    with ProcessPoolExecutor(
            nwork, mp_context=multiprocessing.get_context("spawn"),
            initializer=_one_thread) as pool:
        step = -(-len(pairs) // (2 * nwork))
        parts = [pool.submit(_w_ecp_blocks, pairs[k:k + step])
                 for k in range(0, len(pairs), step)]
        rks_fut = pool.submit(_w_oracle_rks_nah)
        cases = ("h2", "oh", "na2")
        cpus = {c: pool.submit(_w_ecp_cpu, c) for c in cases}
        mats = {c: pool.submit(_w_ecp_matrix, c) for c in cases}
        rhf_fut = pool.submit(_w_oracle_rhf, "na2")

        t0 = time.perf_counter()
        e, ncyc, wall = _ecp_0029(ctx, parts, pairs, lpairs, nana)
        say(f"  ecp (4) done in {time.perf_counter() - t0:.1f} s")

        # (2) the JAX package's NaH anchor with the shipped model ECP
        t0 = time.perf_counter()
        mf = RHF(_ecp_mol("nah"), conv_tol=1e-10)
        e_nah = mf.kernel()
        check(mf.converged and abs(e_nah - E_NAH_MODEL) < 5e-8,
              f"NaH jqc-model: E {e_nah:.10f} vs {E_NAH_MODEL}")
        say(f"  ecp (2) NaH/sto-3g jqc-model RHF E={e_nah:.10f} |dE vs "
            f"{E_NAH_MODEL}|={abs(e_nah - E_NAH_MODEL):.1e} (tol 5e-8; "
            f"{time.perf_counter() - t0:.1f} s)")

        t0 = time.perf_counter()
        for case in cases:
            _ecp_engine_checks(case, cpus[case].result(),
                               mats[case].result())
        say(f"  ecp (1) done in {time.perf_counter() - t0:.1f} s (waiting "
            "on the workers included)")

        # (3) RHF and RKS with an ECP against host oracle SCFs
        t0 = time.perf_counter()
        mf = RHF(_ecp_mol("na2"), conv_tol=1e-11)
        e_na2 = mf.kernel()
        e_ref = rhf_fut.result()
        check(mf.converged and abs(e_na2 - e_ref) < 1e-7,
              f"Na2 RHF: E {e_na2:.10f} vs oracle {e_ref:.10f}")
        nah = _ecp_mol("nah")
        ks = RKS(nah, xc="pbe", grids=_ecp_grids(nah), conv_tol=1e-10)
        e_ks = ks.kernel()
        e_ks_ref = rks_fut.result()
        check(ks.converged and abs(e_ks - e_ks_ref) < 1e-8,
              f"NaH pbe: E {e_ks:.10f} vs oracle {e_ks_ref:.10f}")
        say(f"  ecp (3) Na2 RHF E={e_na2:.10f} |dE vs oracle|="
            f"{abs(e_na2 - e_ref):.1e} (tol 1e-7); NaH jqc-model RKS pbe "
            f"E={e_ks:.10f} |dE vs oracle|={abs(e_ks - e_ks_ref):.1e} "
            f"(tol 1e-8; {time.perf_counter() - t0:.1f} s)")
    return (f"0029-Na+ RHF/6-31g* E={e:.10f} in {ncyc} cycles, SCF wall "
            f"{wall:.1f} s")


# ----------------------------------------------------------- phase 10
# the pair engine's small anchors: (atoms, basis, density seed)
PAIR_ANCHORS = (("h2o/sto-3g", H2O, "sto-3g", 0),
                ("o-h/6-31g", "O 0 0 0; H 0 0 0.96", "6-31g", 4))
PAIR_ORACLE_TOL = 1e-9   # tests/test_jk_pair.py, all fp64
PAIR_CPU_TOL = 1e-12     # of max(1, max |V|): the card against the CPU
PAIR_TILE_TOL = 1e-5     # tests/test_jk_pair.py:45, :90, mixed tiers


def _pair_anchor(name, atoms, basis, seed):
    """get_j and get_k of one small system, all fp64, on the card against
    the dense oracle and the same engine on the CPU."""
    import numpy as np
    from joltqc_tpu_torch.mol import Molecule, intor_np
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.scf import PairJEngine

    mol = Molecule.from_atom_string(atoms, basis=basis)
    a = np.random.default_rng(seed).uniform(-1, 1, (mol.nao, mol.nao))
    dm = a + a.T
    g = intor_np.eri(mol)
    ref = (np.einsum("ijkl,kl->ij", g, dm), np.einsum("ijkl,jk->il", g, dm))
    out = {}
    for dev in (None, "cpu"):
        eng = PairJEngine(BasisLayout(mol), device=dev, cutoff_fp32=1e-30,
                          cutoff_fp64=1e-30)
        out[dev] = (eng.get_j(dm), eng.get_k(dm))
    parts = []
    for k, what in enumerate("JK"):
        d_or = float(np.abs(out[None][k] - ref[k]).max())
        scale = max(1.0, float(np.abs(out["cpu"][k]).max()))
        d_cpu = float(np.abs(out[None][k] - out["cpu"][k]).max()) / scale
        check(d_or < PAIR_ORACLE_TOL, f"pair {name}: {what} vs oracle "
              f"{d_or:.2e}")
        check(d_cpu < PAIR_CPU_TOL, f"pair {name}: {what} card vs CPU "
              f"{d_cpu:.2e}")
        parts.append(f"{what} vs oracle {d_or:.1e}, vs CPU {d_cpu:.1e}")
    say(f"  pair {name} ({mol.nao} AO): " + "; ".join(parts)
        + f" (tol {PAIR_ORACLE_TOL:g}, {PAIR_CPU_TOL:g} of max(1, |V|))")


def _pair_call(eng, fn, dm, label):
    """Cold call (kernel A for the Schwarz q, counted), warm call and a
    profiled call of one pair-engine method: its result, printed wall,
    device ms, launches, busy share, tasks and quartets per tier."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k

    eri_k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = fn(dm)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    a_launches = eri_k.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    names = {}
    warm, wall, dev_ms, launches = _ecp_timed(lambda: fn(dm), names)
    check(np.isfinite(first).all(), f"pair 0029 {label}: not finite")
    check(np.array_equal(first, warm), f"pair 0029 {label}: a repeated call "
          "differs")
    run = eng.last_run[label]
    busy = "not measured" if dev_ms is None else \
        f"{dev_ms / (wall * 1e3):.3f}"
    dev = "not measured" if dev_ms is None else f"{dev_ms:.1f} ms"
    say(f"  pair 0029 {label}: wall first {cold:.3f} s (kernel A launches "
        f"{a_launches}), warm {wall:.3f} s; device {dev} in {launches} "
        f"launches, busy {busy}; tasks fp64 {run['tasks']['fp64']} f32 "
        f"{run['tasks']['f32']}, quartets fp64 {run['quartets']['fp64']} f32 "
        f"{run['quartets']['f32']}, chunks {run['chunks']}, host "
        f"screening {run['screen_s']:.3f} s; peak device memory {peak:.2f} "
        "GiB; repeat bit-identical")
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (ns, n) in top:
        say(f"  pair 0029 {label} profile: {ns / 1e6:9.1f} ms x{n:<7d} "
            f"{name[:80]}")
    return first, a_launches


def phase_pair(ctx):
    import numpy as np
    from joltqc_tpu_torch.scf import PairJEngine

    t0 = time.perf_counter()
    for case in PAIR_ANCHORS:
        _pair_anchor(*case)
    say(f"  pair anchors done in {time.perf_counter() - t0:.1f} s")
    mf = _scf_0029(ctx)
    dm = mf.dm
    t0 = time.perf_counter()
    jt, kt = mf.jk.get_jk(dm)
    say(f"  pair 0029: tile get_jk on the converged density "
        f"{time.perf_counter() - t0:.3f} s; max |D_int| "
        f"{np.abs(mf.layout.dm_to_internal(dm)).max():.6f} (the screening "
        "shifts by its log)")
    eng = PairJEngine(mf.layout)
    vj, a_j = _pair_call(eng, eng.get_j, dm, "get_j")
    vk, a_k = _pair_call(eng, eng.get_k, dm, "get_k")
    check(a_j > 0, "pair 0029: kernel A not launched for the Schwarz q")
    dj = float(np.abs(vj - jt).max())
    dk = float(np.abs(vk - kt).max())
    ej = 0.5 * float(np.einsum("ij,ji->", dm, vj - jt))
    ek = 0.25 * float(np.einsum("ij,ji->", dm, vk - kt))
    say(f"  pair 0029 vs tile: max |dJ| {dj:.2e}, max |dK| {dk:.2e} (tol "
        f"{PAIR_TILE_TOL:g}); 1/2 tr(D dJ) {ej:.3e}, 1/4 tr(D dK) {ek:.3e} Eh")
    check(dj < PAIR_TILE_TOL and dk < PAIR_TILE_TOL,
          f"pair 0029: |dJ| {dj:.2e}, |dK| {dk:.2e} vs the tile engine")
    return (f"0029 pair J/K within {max(dj, dk):.1e} of the tile engine; "
            f"get_j {eng.last_run['get_j']['wall_s']:.2f} s, get_k "
            f"{eng.last_run['get_k']['wall_s']:.2f} s (last calls)")


# ----------------------------------------------------------- phase 11
MULTI_RANKS = (2, 4)      # gloo ranks sharing the card in phase multi
MULTI_TIMEOUT_S = 240.0   # one spawn of ranks, start-up to exit


def _multi_rank(rank, world, tmp):
    """One spawned gloo rank of phase multi (spawned: this file is its
    main module): the sharded tile get_jk at 0029/6-31g* on phase full's
    converged density, twice, with kernels A and B counted per call (set
    to 0 just before, read just after); J/K and counts to tmp."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from joltqc_tpu_torch.mol import Molecule
    from joltqc_tpu_torch.mol.layout import BasisLayout
    from joltqc_tpu_torch.ops.accum_tile import accum_tile_chunk as acc_k
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.parallel import sharded_jk_engine

    import datetime

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, f"rdzv{world}"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S))
    try:
        dm = np.load(os.path.join(tmp, "dm_0029.npy"))
        mol = Molecule.from_xyz_file(XYZ_0029, basis="6-31g*")
        eng = sharded_jk_engine(BasisLayout(mol), dist.group.WORLD)
        out, calls = {}, []
        for call in ("first", "warm"):
            eri_k.launches = eri_k.generic_launches = acc_k.launches = 0
            r0 = dict(eng.timing)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vj, vk = eng.get_jk(dm)
            torch.cuda.synchronize()
            calls.append([time.perf_counter() - t0,
                          eng.timing["reduce_s"] - r0.get("reduce_s", 0.0),
                          eng.timing["reduce_bytes"]
                          - r0.get("reduce_bytes", 0), eri_k.launches,
                          acc_k.launches, eri_k.generic_launches])
            out[f"{call}_j"], out[f"{call}_k"] = vj, vk
        np.savez(os.path.join(tmp, f"multi{world}_rank{rank}.npz"),
                 calls=np.array(calls), rank_tasks=eng.plan_stats[
                     "rank_tasks"], ntasks=eng.plan_stats["ntasks"],
                 device=str(eng.device), **out)
    finally:
        dist.destroy_process_group()


def phase_multi(ctx):
    """The sharded Fock build (JKEngine(group=...)) on the card: 0029
    tile get_jk over 2 and 4 gloo ranks sharing cuda:0, bit-identical to
    one rank; then dryrun_multichip(2) and (4) against the JAX package's
    single-chip (H2O)4/6-31g result."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.entry import dryrun_multichip
    from joltqc_tpu_torch.parallel import spawn_ranks
    from joltqc_tpu_torch.scf import JKEngine

    mf = _scf_0029(ctx)
    dm = mf.dm
    tmp = os.path.join(ctx["cache_dir"], "multi")
    os.makedirs(tmp, exist_ok=True)
    np.save(os.path.join(tmp, "dm_0029.npy"), dm)
    one = JKEngine(mf.layout)
    ref, wall_1 = _timed_jk(one, dm)
    ref_w, wall_1w = _timed_jk(one, dm)
    check(_same_jk(ref, ref_w), "multi: one-rank get_jk repeat differs")
    ntasks = one.plan_stats["ntasks"]
    say(f"  multi one rank: 0029 tile get_jk first {wall_1:.3f} s, warm "
        f"{wall_1w:.3f} s, {ntasks} tasks")
    launches = {"eri": 0, "accum_tile": 0, "accum_block": 0}
    walls = {}
    for R in MULTI_RANKS:
        spawn_s = spawn_ranks(_multi_rank, R, (tmp,),
                              timeout=MULTI_TIMEOUT_S)
        ranks = [dict(np.load(os.path.join(tmp, f"multi{R}_rank{r}.npz")))
                 for r in range(R)]
        tasks = [int(x["rank_tasks"]) for x in ranks]
        check(sum(tasks) == ntasks and all(int(x["ntasks"]) == ntasks
                                           for x in ranks),
              f"multi R={R}: rank tasks {tasks} do not sum to {ntasks}")
        for r, x in enumerate(ranks):
            for call in ("first", "warm"):
                check(_same_jk((x[f"{call}_j"], x[f"{call}_k"]), ref),
                      f"multi R={R} rank {r} {call}: J/K differ from one "
                      "rank")
            (w1, _, _, a1, b1, g1), (w2, rs, rb, a2, b2, g2) = x["calls"]
            check(a2 > 0 and b2 > 0 and g1 == g2 == 0,
                  f"multi R={R} rank {r}: kernel A {a2}, B {b2}, generic "
                  f"{g1 + g2} launches")
            launches["eri"] += int(a1 + a2)
            launches["accum_tile"] += int(b1 + b2)
            say(f"  multi R={R} rank {r} ({x['device']}): {tasks[r]} tasks; "
                f"get_jk first {w1:.3f} s, warm {w2:.3f} s; reduce "
                f"{rs * 1e3:.1f} ms of {int(rb)} B; launches per warm call "
                f"A {int(a2)} B {int(b2)} (first call A {int(a1)} B "
                f"{int(b1)})")
        walls[R] = max(float(x["calls"][1][0]) for x in ranks)
        say(f"  multi R={R}: {R} ranks bit-identical to one rank (first "
            f"and warm), tasks per rank {tasks}; spawn to exit "
            f"{spawn_s:.1f} s")
    dry = {}
    for R in MULTI_RANKS:
        got = dryrun_multichip(R)
        dry[R] = got
        launches["eri"] += sum(got["eri_launches"])
        launches["accum_block"] += sum(got["block_launches"])
        check(min(got["block_launches"]) > 0 and min(got["eri_launches"]) > 0,
              f"dryrun R={R}: a rank launched no kernel A or D")
        say(f"  multi dryrun R={R}: |dJ|, |dK| vs the JAX npz "
            f"{got['gap_j']:.3e}, {got['gap_k']:.3e} (tol 1e-6); tasks per "
            f"rank {got['rank_tasks']}; get_jk per rank "
            + ", ".join(f"{w:.3f}" for w in got["wall_s"]) + " s; reduce "
            + ", ".join(f"{w * 1e3:.1f}" for w in got["reduce_s"])
            + f" ms of {got['reduce_bytes']} B; launches A "
            f"{got['eri_launches']} D {got['block_launches']}")
    for k, row in (("eri", "kern_a"), ("accum_tile", "kern_b"),
                   ("accum_block", "kern_d")):
        if row in ctx:  # the kernels line counts this phase's runs too
            ctx[row]["launches"] += launches[k]
    torch.cuda.synchronize()
    return (f"0029 tile get_jk bit-identical on {list(MULTI_RANKS)} ranks "
            f"(warm {', '.join(f'{walls[R]:.3f}' for R in MULTI_RANKS)} s "
            f"vs one rank {wall_1w:.3f} s); dryrun bit-identical, JAX gap "
            + ", ".join(f"{max(d['gap_j'], d['gap_k']):.1e}"
                        for d in dry.values()))


# ----------------------------------------------------------- phase 12
def phase_api(ctx):
    """The PySCF adapter's patches (joltqc_tpu_torch.pyscf._apply_patches)
    on stub RHF, RKS (b3lyp) and ECP objects on the card against the same
    patches on the CPU, and entry()'s step on the card against its CPU
    run."""
    import numpy as np
    import torch
    from joltqc_tpu_torch.entry import entry
    from joltqc_tpu_torch.ops.accum import limbs_to_f64
    from joltqc_tpu_torch.ops.accum_tile import accum_tile_chunk as acc_k
    from joltqc_tpu_torch.ops.eri import eri_chunk as eri_k
    from joltqc_tpu_torch.pyscf import _apply_patches
    from joltqc_tpu_torch.pyscf.standin import standin_mf

    def stub(**kw):
        """A stand-in RHF / RKS on H2O/6-31g (sto-3g with the ECP)."""
        basis = "sto-3g" if kw.get("ecp") else "6-31g"
        return standin_mf(basis, direct_scf=True, n_rad=30, n_theta=10,
                          **kw)

    out = []
    eri_k.launches = acc_k.launches = 0
    # RHF: get_j / get_k / get_jk (hermi 1 and 0), incremental veff
    mfs = {dev: _apply_patches(stub(), device=dev)
           for dev in ("cuda", "cpu")}
    n = mfs["cpu"].mol.nao
    rng = np.random.default_rng(11)
    a = rng.uniform(-0.5, 0.5, (n, n))
    dm0 = a + a.T
    dm1 = dm0 + 0.02 * np.eye(n)
    res = {}
    for dev, mf in mfs.items():
        res[dev] = [mf.get_j(mf.mol, dm0, 1), mf.get_k(mf.mol, dm0, 1),
                    *mf.get_jk(mf.mol, dm0, 1), *mf.get_jk(mf.mol, a, 0)]
    scale = max(1.0, float(np.abs(res["cpu"][0]).max()))
    d = max(float(np.abs(x - y).max())
            for x, y in zip(res["cuda"], res["cpu"])) / scale
    check(d < MODE_TOL["tile"], f"api RHF: card vs CPU {d:.2e}")
    check(np.array_equal(res["cuda"][0], res["cuda"][2])
          and np.array_equal(res["cuda"][1], res["cuda"][3]),
          "api RHF: get_j/get_k differ from get_jk on the card")
    mf = mfs["cuda"]
    v0 = mf.get_veff(mf.mol, dm0)
    incr = mf.get_veff(mf.mol, dm1, dm0, v0, 1)
    vj1, vk1 = mf.get_jk(mf.mol, dm1, 1)
    d_inc = float(np.abs(incr - (vj1 - 0.5 * vk1)).max())
    check(d_inc < 1e-10, f"api RHF: incremental veff off by {d_inc:.2e}")
    out.append(f"RHF get_j/get_k/get_jk (hermi 1, 0) card vs CPU "
               f"{d:.1e} of max(|J|, 1) (tol {MODE_TOL['tile']:g}); "
               f"incremental veff vs direct {d_inc:.1e}")
    # RKS b3lyp: tags, incremental veff, Exc against the CPU adapter
    rks = {dev: _apply_patches(stub(xc="b3lyp"), device=dev)
           for dev in ("cuda", "cpu")}
    for mf in rks.values():
        mf.grids.build()  # the port's default grid (host): one on both
    vks = {dev: mf.get_veff(mf.mol, dm0) for dev, mf in rks.items()}
    d_exc = abs(vks["cuda"].exc - vks["cpu"].exc)
    d_v = float(np.abs(np.asarray(vks["cuda"]) - np.asarray(vks["cpu"]))
                .max())
    mf = rks["cuda"]
    v1i = mf.get_veff(mf.mol, dm1, dm0, vks["cuda"], 1)
    v1d = mf.get_veff(mf.mol, dm1)
    d_rinc = float(np.abs(np.asarray(v1i) - np.asarray(v1d)).max())
    check(all(getattr(vks["cuda"], t) is not None
              for t in ("ecoul", "exc", "vj", "vk")), "api RKS: tags")
    check(d_exc < 1e-7 and d_v < 1e-6, f"api RKS: card vs CPU Exc "
          f"{d_exc:.2e}, veff {d_v:.2e}")
    check(d_rinc < 1e-8, f"api RKS: incremental veff off by {d_rinc:.2e}")
    out.append(f"RKS b3lyp Exc card vs CPU {d_exc:.1e} Eh (tol 1e-7), veff "
               f"{d_v:.1e} (tol 1e-6), incremental vs direct {d_rinc:.1e}")
    # ECP: intor('ECPscalar') routed to the card's ECP engine
    ecp = {dev: _apply_patches(stub(ecp=True), device=dev)
           for dev in ("cuda", "cpu")}
    mats = {dev: mf.mol.intor("ECPscalar") for dev, mf in ecp.items()}
    d_ecp = float(np.abs(mats["cuda"] - mats["cpu"]).max()) / max(
        1.0, float(np.abs(mats["cpu"]).max()))
    check(np.abs(mats["cuda"]).max() > 0 and d_ecp < 1e-12,
          f"api ECP: card vs CPU {d_ecp:.2e}")
    out.append(f"ECPscalar card vs CPU {d_ecp:.1e} of max(1, |V|)")
    torch.cuda.synchronize()
    n_a, n_b = eri_k.launches, acc_k.launches
    check(n_a > 0 and n_b > 0, f"api: kernel A {n_a}, B {n_b} launches")
    # entry(): kernels A and B of the first tile launch, card vs CPU
    steps = {}
    for dev in ("cuda", "cpu"):
        fn, args = entry(device=dev)
        eri_k.launches = acc_k.launches = 0
        EJ, EK = fn(*args)
        if dev == "cuda":
            torch.cuda.synchronize()
            check(eri_k.launches == 1 and acc_k.launches == 6,
                  f"entry: A {eri_k.launches}, B {acc_k.launches} launches")
            n_a, n_b = n_a + 1, n_b + 6
        steps[dev] = [limbs_to_f64(x.cpu(), fn.e) for x in (EJ, EK)]
    d_ent = max(float((x - y).abs().max()) for x, y in
                zip(steps["cuda"], steps["cpu"])) * 2.0 ** -fn.e
    check(d_ent < ACC_TOL[fn.tier], f"entry: card vs CPU {d_ent:.2e} of 2^e")
    out.append(f"entry() step ({fn.tier}) card vs CPU {d_ent:.1e} of 2^e "
               f"(tol {ACC_TOL[fn.tier]:g})")
    for k, row, m in (("eri", "kern_a", n_a), ("accum_tile", "kern_b", n_b)):
        if row in ctx:  # the kernels line counts this phase's launches too
            ctx[row]["launches"] += m
    out.append(f"launches A {n_a} B {n_b}")
    return "; ".join(out)


# --------------------------------------------------------------- main
PHASES = (("build", phase_build), ("eri", phase_eri), ("accum", phase_accum),
          ("anchors", phase_anchors), ("full", phase_full),
          ("engine", phase_engine), ("modes", phase_modes), ("dft", phase_dft),
          ("ecp", phase_ecp), ("pair", phase_pair), ("multi", phase_multi),
          ("api", phase_api))


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
    cache_dir = tempfile.mkdtemp(prefix="jqc_smoke_cache_")
    os.environ["JQC_CACHE_DIR"] = cache_dir
    os.environ["JQC_PLAN_CACHE"] = "0"
    try:
        return _run(want, {"cache_dir": cache_dir})
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _run(want, ctx):
    import torch

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
        say(json.dumps({"kernels": [ctx[k] for k in (
            "kern_a", "kern_b", "kern_c", "kern_d")]}))
    else:
        say(ctx.get("smi", ""))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
