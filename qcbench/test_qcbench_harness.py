"""The harness: files found by name, the window's statistics, the trace's
reduction, the contract's shape of BENCHMARK.json, and a whole run of a
small cell on the CPU, with a metric, a configuration, a mix and a cell
added only as files."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from qcbench import harness
from qcbench.trace import Trace, union_length

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "qcbench/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    names += [c["name"] for c in s["configs"]]
    names += [w["name"] for w in s["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    for m in s["end_to_end"]:
        assert 0.0 < m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in s["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("qcbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in s["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.Cell.load(cell)
    assert c.config["name"] == c.workload["config"]
    kind = harness.call_kind(c)
    assert set(c.limits["checks"]) == set(kind.names)
    assert callable(kind.bind) and callable(kind.reference)
    reported = {m["name"] for m in c.end_to_end()}
    assert {"setup_s", c.traffic["per_call_metric"]} <= reported
    layers = c.per_layer()
    assert layers
    for m in layers:
        assert callable(harness.reader(m["name"]))


def test_window_statistic_counts_a_stall():
    # ten calls of 0.1 s with a 2 s stall before the sixth: the statistic is
    # the whole window over the calls, not a typical call
    t, timeline = 100.0, []
    for k in range(10):
        if k == 5:
            t += 2.0
        timeline.append((t, t + 0.1))
        t += 0.1
    assert harness.per_call_seconds(timeline, 100.0) == pytest.approx(0.3)
    with pytest.raises(ValueError):
        harness.per_call_seconds([], 0.0)


def test_idle_share_of_a_synthetic_trace():
    dev = [("eri_class_kernel<1>", 0.0, 0.4), ("accum_tile_kernel", 0.3, 0.5),
           ("Memcpy DtoH", 0.7, 0.8), ("eri_class_kernel<2>", 1.5, 2.5)]
    host = [("aten::copy_", 0.45, 0.75), ("screen", 0.8, 1.6),
            ("qcbench.window", 0.0, 2.0)]
    tr = Trace((0.0, 2.0), dev, host)
    assert tr.busy_s() == pytest.approx(0.5 + 0.1 + 0.5)
    assert 1.0 - tr.busy_s() / tr.window_s == pytest.approx(0.45)
    assert tr.device_time(r"eri_(class_)?kernel") == pytest.approx(1.4)
    gaps = tr.idle_gaps(2)
    assert gaps[0] == ["screen", pytest.approx(0.7)]
    assert gaps[1] == ["aten::copy_", pytest.approx(0.2)]
    assert union_length([("a", -1.0, 0.5)], (0.0, 1.0)) == 0.5


def test_trace_from_profiler_events():
    # the window's span appears on both timelines: it marks the window on
    # the host's and is no device activity on the device's
    import torch
    from types import SimpleNamespace as NS

    from qcbench.trace import WINDOW_SPAN, from_events

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, s, e, ann=False):
        return NS(name=lambda: name, device_type=lambda: dev,
                  is_user_annotation=lambda: ann,
                  start_ns=lambda: int(s * 1e9), end_ns=lambda: int(e * 1e9))

    tr = from_events([ev(WINDOW_SPAN, cpu, 1.0, 3.0, True),
                      ev(WINDOW_SPAN, cuda, 1.0, 3.0, True),
                      ev("eri_class_kernel", cuda, 1.5, 2.0),
                      ev("aten::copy_", cpu, 2.0, 2.9)])
    assert tr.window == (0.0, 2.0)
    assert tr.busy_s() == pytest.approx(0.5)
    assert [n for n, _, _ in tr.device] == ["eri_class_kernel"]
    assert tr.idle_gaps(1) == [["aten::copy_", pytest.approx(1.0)]]


def test_trace_of_a_real_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from qcbench.trace import WINDOW_SPAN, from_profiler

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_SPAN):
            a = torch.ones(64, 64)
            for _ in range(10):
                a = a @ a / 64.0
    tr = from_profiler(prof)
    assert tr is not None and tr.window_s > 0.0 and tr.device == []
    assert any("mm" in name for name, _, _ in tr.host)


def test_forbidden_names_are_whole_top_level_names():
    mods = dict(sys.modules)
    try:
        sys.modules["joltqc_tpu_torch_fake"] = sys
        sys.modules["jaxlike.sub"] = sys
        assert harness.loaded_forbidden() == []
        sys.modules["jax.numpy"] = sys
        assert harness.loaded_forbidden() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


GET_J = '''"""J alone, on half the core-guess density, timed per
call as j_build_s: a kind of call added as a file."""

from qcbench.harness import per_call_seconds
from qcbench.inputs import make_inputs as general, max_rel

names = ("J",)


def make_inputs(config, traffic, seed, device):
    inputs = general(config, traffic, seed, device)
    inputs.dm = 0.5 * inputs.dm
    return inputs


def bind(driver, inputs, cell):
    return lambda k: driver.jk.get_jk(inputs.dm, with_k=False)[0]


def reference(inputs, config, limits, device):
    from qcbench.reference.jk import get_jk

    return get_jk(inputs.ref_mol, inputs.dm, device,
                  thresh=limits["ref_thresh"])[0]


def numbers(out, ref):
    return {"J": max_rel(out, ref)}


def window_metrics(traffic, timeline, t0, outs):
    return {"j_build_s": per_call_seconds(timeline, t0)}
'''


def _added_only_as_files(dest):
    """A configuration, a mix, a per-layer metric and a cell, each added as
    files and BENCHMARK.json entries; then a mix with a kind of call of its
    own (its inputs, its call, its reference and its end-to-end metric),
    added the same way."""
    with open(os.path.join(dest, "configs", "water-rhf.json")) as f:
        cfg = json.load(f)
    cfg.update(name="water-rhf-sto3g", basis="sto-3g")
    with open(os.path.join(dest, "configs", "water-rhf-sto3g.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dest, "traffic", "fock.json")) as f:
        mix = json.load(f)
    mix["warmup_calls"] = 1
    with open(os.path.join(dest, "traffic", "fock-once.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(dest, "limits", "water-rhf.fock.json")) as f:
        lim = f.read()
    with open(os.path.join(dest, "limits", "water-sto3g.fock-once.json"),
              "w") as f:
        f.write(lim)
    with open(os.path.join(dest, "metrics", "calls_done.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.calls)\n")
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        s = json.load(f)
    cell = "water-sto3g.fock-once"
    s["workloads"].append({"name": cell, "config": "water-rhf-sto3g",
                           "traffic": "fock-once", "chips": 1, "why": "t"})
    for m in s["end_to_end"]:
        if "workloads" in m and m["name"] == "fock_build_s":
            m["workloads"].append(cell)
    s["per_layer"].append({"name": "calls_done.fock", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "harness", "moves": "fock_build_s",
                           "workloads": [cell]})
    with open(os.path.join(dest, "calls", "get_j.py"), "w") as f:
        f.write(GET_J)
    with open(os.path.join(dest, "traffic", "j-half.json"), "w") as f:
        json.dump({"call": "get_j", "why": "t", "density": "core_guess",
                   "motion": mix["motion"], "warmup_calls": 1}, f)
    with open(os.path.join(dest, "limits", "water-sto3g.j-half.json"),
              "w") as f:
        json.dump({"ref_thresh": 1e-15, "checks": {"J": 1e-8}}, f)
    jcell = "water-sto3g.j-half"
    s["workloads"].append({"name": jcell, "config": "water-rhf-sto3g",
                           "traffic": "j-half", "chips": 1, "why": "t"})
    s["end_to_end"].append({"name": "j_build_s", "unit": "s",
                            "better": "lower", "bound": 0.05,
                            "source": "host_clock", "workloads": [jcell]})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    return cell, jcell


def test_added_as_files_runs(tmp_path):
    from qcbench.conftest import make_small_bench

    dest = make_small_bench(str(tmp_path))
    cell, jcell = _added_only_as_files(dest)
    res = harness.run(cell, 2 ** 33 + 5, 0.2, 1, device="cpu",
                      chips_check=False, root=dest, data=dest)
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["calls_done.fock"]["value"] == res["attempted"]
    assert list(res)[-1] == "checks"
    res = harness.run(jcell, 2 ** 31 + 9, 0.2, 0, device="cpu",
                      chips_check=False, root=dest, data=dest)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "j_build_s"}
    assert set(res["checks"]) == {"J"}
    # the half density is the kind's own input: a J of the full density
    # would not be correct against its reference
    broken = harness.run(jcell, 2 ** 31 + 9, 0.2, 0, device="cpu",
                         chips_check=False, root=dest, data=dest,
                         fault=lambda driver, fn: lambda k: 2.0 * fn(k))
    assert not broken["correct"]


@pytest.mark.parametrize("cell", ["water-rhf.fock", "water-b3lyp.veff"])
def test_small_cell_runs_correct(small_bench, cell):
    res = harness.run(cell, -12345678901, 0.3, 0, device="cpu",
                      chips_check=False, root=small_bench, data=small_bench)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s",
                                   harness.Cell.load(cell, small_bench,
                                                     small_bench)
                                   .traffic["per_call_metric"]}
    assert res["device"]["platform"] == "cpu"
    assert isinstance(res["compiled"], bool)
    assert list(res)[-1] == "checks"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "qcbench/run.py", "--workload",
                        spec()["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bench_files_alone_give_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "qcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "qcbench/run.py", "--workload",
                        spec()["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
