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
  6. modes      at the same 302 AO, on the converged density: get_jk of a
                scatter and a block engine against the tile path's, with
                kernel D's launches counted; hermi=0, omega and a stack;
                kernels C and D held against their plain versions and
                timed on chunks of that path; incremental RHF against the
                direct run;
  7. a "kernels" JSON line; the last line is the device JSON.
Any failed phase makes the script exit nonzero.  Options: --only PHASES
(comma list, for debugging: build,eri,accum,anchors,full,modes; modes
runs the 0029 SCF itself when full is left out).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
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


# --------------------------------------------------------------- main
PHASES = (("build", phase_build), ("eri", phase_eri), ("accum", phase_accum),
          ("anchors", phase_anchors), ("full", phase_full),
          ("modes", phase_modes))


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
