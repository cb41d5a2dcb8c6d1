#!/usr/bin/env python3
"""Readings that set a cell's limits: on each seed, the numbers compared
for the program as the configuration states it and for the control (the
program with its lower-precision path switched on, as the cell's limits
file names it), each against the reference, at the cell's own size.

    python3 qcbench/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

Prints one line per seed and side, and a JSON summary as the last line.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seeds, device):
    """{side: [numbers per seed]} for side 'program' and 'control'."""
    import torch

    from qcbench.harness import build_driver, call_kind, make_inputs

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for k, v in cell.config.get("env", {}).items():
        os.environ[k] = str(v)
    kind = call_kind(cell)
    out = {"program": [], "control": []}
    for seed in seeds:
        inputs = make_inputs(kind, cell, seed, dev)
        got = {}
        prog, _ = build_driver(cell, inputs, dev)
        # the control shares the program's set-up products (the grid)
        ctrl, _ = build_driver(cell, inputs, dev, cell.limits["control"],
                               share=prog)
        for side, driver in (("program", prog), ("control", ctrl)):
            fn = kind.bind(driver, inputs, cell)
            for k in range(int(cell.traffic["warmup_calls"])):
                res = fn(k)
            got[side] = res
        del prog, ctrl, driver, fn
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = kind.reference(inputs, cell.config, cell.limits, dev)
        ref_s = time.perf_counter() - t
        for side in out:
            nums = kind.numbers(got[side], ref)
            out[side].append(nums)
            print(f"seed {seed} {side} " + " ".join(
                f"{k} {v!r}" for k, v in nums.items())
                + f" reference_s {ref_s:.1f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.setdefault("JQC_CACHE_DIR",
                          os.path.join(ROOT, ".qcbench_cache", "jqc"))
    sys.path.insert(0, ROOT)
    from qcbench.harness import Cell

    cell = Cell.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    res = readings(cell, seeds, args.device)
    summary = {side: {k: max(r[k] for r in rows) if side == "program"
                      else min(r[k] for r in rows) for k in rows[0]}
               for side, rows in res.items()}
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "readings": res, "program_max": summary["program"],
                      "control_min": summary["control"]}), flush=True)


if __name__ == "__main__":
    main()
