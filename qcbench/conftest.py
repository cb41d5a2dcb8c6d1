"""Fixtures of the harness's own tests: a small copy of the benchmark
(BENCHMARK.json and the files it names) whose cells run water on the CPU
through the same harness, configurations and traffic mixes."""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WATER = """3
water, the program's H2O anchor geometry
O  0.0000000000 -0.0000000000  0.1174000000
H -0.7570000000 -0.0000000000 -0.4696000000
H  0.7570000000  0.0000000000 -0.4696000000
"""
# the small cells: name -> (configuration it copies, traffic, basis)
SMALL = {"water-rhf.fock": ("0029-rhf-631gs", "fock", "6-31g*"),
         "water-b3lyp.veff": ("0029-b3lyp-631gs", "veff", "6-31g*")}
REAL = {"water-rhf.fock": "0029-rhf-631gs.fock",
        "water-b3lyp.veff": "0029-b3lyp-631gs.veff"}


def make_small_bench(dest):
    """Write into ``dest`` a BENCHMARK.json whose cells are SMALL's, and
    configs/, traffic/, calls/, limits/ and metrics/ beside it: copies of
    the real files with the molecule swapped for water."""
    for sub in ("traffic", "metrics", "calls"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(dest, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(dest, "configs"))
    os.makedirs(os.path.join(dest, "limits"))
    xyz = os.path.join(dest, "water.xyz")
    with open(xyz, "w") as f:
        f.write(WATER)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    spec["workloads"] = []
    spec["configs"] = []
    for name, (cfg, traffic, basis) in SMALL.items():
        real = REAL[name]
        with open(os.path.join(HERE, "configs", cfg + ".json")) as f:
            c = json.load(f)
        c["molecule"], c["basis"] = xyz, basis
        small_cfg = name.split(".")[0]
        with open(os.path.join(dest, "configs", small_cfg + ".json"),
                  "w") as f:
            json.dump(c, f)
        shutil.copy(os.path.join(HERE, "limits", real + ".json"),
                    os.path.join(dest, "limits", name + ".json"))
        if real in cells:
            spec["workloads"].append({**cells[real], "name": name,
                                      "config": small_cfg})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return dest


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    return make_small_bench(str(tmp_path_factory.mktemp("qcbench_small")))


@pytest.fixture
def cuda_device():
    """Skips a test where no CUDA device is present (decided here, when the
    test runs, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
