#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port (joltqc_tpu_torch).

From the root of a checkout:

    python3 qcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up, the window, each number compared with the reference
beside its limit on standard error, and one JSON result as the last line
of standard output.  Exits nonzero, with no result, where no CUDA device
is found, where the program cannot be imported, or where JAX or the JAX
package is loaded.  BENCHMARK.json at the root names the cells; the rest
is described in qcbench/harness.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".qcbench_cache")


def config_env(workload):
    """The ``env`` of the cell's configuration file; {} where the cell or
    its files are not found (the harness then says why)."""
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            spec = json.load(f)
        cfg = next(w["config"] for w in spec["workloads"]
                   if w["name"] == workload)
        with open(os.path.join(HERE, "configs", cfg + ".json")) as f:
            return json.load(f).get("env", {})
    except (OSError, StopIteration, ValueError, KeyError):
        return {}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("JQC_CACHE_DIR", "jqc")):
        os.environ[var] = os.path.join(CACHE, sub)
    # the configuration's environment (its host threads among it), set
    # before numpy and torch load
    for k, v in config_env(args.workload).items():
        os.environ[k] = str(v)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from qcbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             args.trace)
    except SystemExit as e:
        print(e, file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
