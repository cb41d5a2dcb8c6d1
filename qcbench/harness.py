"""One run of one cell: set-up, the measured window, the per-layer
readers, the comparison with the reference and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in BENCHMARK.json:
``configs/<config>.json``, ``traffic/<mix>.json`` (the mix's parameters,
with the kind of call its window drives, ``calls/<call>.py``: see
``calls/__init__.py``), ``limits/<cell>.json`` and ``metrics/<metric>.py``
(or ``metrics/<name before the first dot>.py``, shared by a quantity's
per-cell metrics), whose ``read(ctx)`` returns the metric's value or None
where it finds nothing to read.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import itertools
import json
import os
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "joltqc_tpu")


def say(line):
    print(line, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    data: str

    @classmethod
    def load(cls, name, root=ROOT, data=HERE):
        """The cell ``name`` of ``root``/BENCHMARK.json, its files read
        from the directory ``data``."""
        spec = load_json(root, "BENCHMARK.json")
        wl = {w["name"]: w for w in spec["workloads"]}
        if name not in wl:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = wl[name]
        return cls(name, spec, w,
                   load_json(data, "configs", w["config"] + ".json"),
                   load_json(data, "traffic", w["traffic"] + ".json"),
                   load_json(data, "limits", name + ".json"), data)

    def _applies(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self):
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    def per_layer(self):
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self._applies(m) and m["moves"] in mine]


def _load(data, sub, fname):
    path = os.path.join(data, sub, fname + ".py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(
        f"qcbench_{sub}_" + fname.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name, data=HERE):
    """The ``read`` function of a per-layer metric, by name."""
    for fname in (name, name.split(".")[0]):
        mod = _load(data, "metrics", fname)
        if mod is not None:
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {name!r}")


def call_kind(cell):
    """The module of the kind of call that the cell's mix drives."""
    mod = _load(cell.data, "calls", cell.traffic["call"])
    if mod is None:
        raise FileNotFoundError(f"no call kind {cell.traffic['call']!r}")
    return mod


def make_inputs(kind, cell, seed, device):
    """The cell's inputs: by the kind's own maker, else the general
    generator."""
    from .inputs import make_inputs as general

    make = getattr(kind, "make_inputs", general)
    return make(cell.config, cell.traffic, seed, device)


def window_metrics(kind, traffic, timeline, t0, outs):
    """The window's end-to-end values: by the kind's own statistic, else
    the window's wall over its calls, under the mix's
    ``per_call_metric``."""
    own = getattr(kind, "window_metrics", None)
    if own is not None:
        return own(traffic, timeline, t0, outs)
    return {traffic["per_call_metric"]: per_call_seconds(timeline, t0)}


def per_call_seconds(timeline, t0):
    """The window's wall time over the calls completed in it: from the
    window's start to the end of its last call, over the number of calls.
    ``timeline``: (start, end) of each call, in order."""
    if not timeline:
        raise ValueError("no call completed in the window")
    return (timeline[-1][1] - t0) / len(timeline)


def counters(driver):
    """The program's own counters, copied: the Fock build's ``timing``
    and, for Kohn-Sham, ``veff_time``."""
    out = {"jk.timing": dict(getattr(driver.jk, "timing", {}))}
    if hasattr(driver, "veff_time"):
        out["veff_time"] = dict(driver.veff_time)
    return out


def resolve(obj, dotted):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@dataclass
class Context:
    """What a per-layer reader may read."""

    cell: Cell
    inputs: object
    device: object
    calls: int
    window_s: float
    per_call_s: float
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: object = None
    cache: dict = field(default_factory=dict)  # shared by the readers


def build_driver(cell, inputs, device, overrides=None, share=None):
    """The program's driver object for a configuration, as a user makes
    it: the molecule from the coordinates, the configuration's driver
    class with its arguments and attributes (``overrides`` merged over
    them), then the configuration's set-up steps, each timed as a span.
    ``share``: another driver of the same molecule whose objects built by
    the set-up steps (a step ``grids.build`` builds ``grids``) are taken
    over instead of built again.  Returns (driver, spans)."""
    import joltqc_tpu_torch as jqc

    method = dict(cell.config["method"])
    for k, v in (overrides or {}).items():
        method[k] = {**method.get(k, {}), **v}
    mol = jqc.Molecule.from_atom_string(inputs.atom_string(),
                                        basis=inputs.basis, unit="bohr",
                                        charge=cell.config.get("charge", 0))
    driver = getattr(jqc, method["driver"])(mol, device=str(device),
                                            **method.get("kwargs", {}))
    for k, v in method.get("attrs", {}).items():
        setattr(driver, k, v)
    spans = {}
    for step in cell.config.get("setup", []):
        if share is not None:
            attr = step["call"].split(".")[0]
            setattr(driver, attr, getattr(share, attr))
            continue
        t0 = time.perf_counter()
        resolve(driver, step["call"])()
        spans[step["span"]] = time.perf_counter() - t0
    return driver, spans


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(fn, first, seconds, device):
    """Call ``fn(k)`` for k = first, first + 1, ... until ``seconds`` have
    passed; returns (t0, timeline, outputs)."""
    timeline, outs = [], []
    sync(device)
    t0 = time.perf_counter()
    end_at = t0 + seconds
    for k in itertools.count(first):
        s = time.perf_counter()
        out = fn(k)
        e = time.perf_counter()
        timeline.append((s, e))
        outs.append(out)
        if e >= end_at:
            return t0, timeline, outs


def _digest(out):
    h = hashlib.sha1()
    for a in out if isinstance(out, tuple) else (out,):
        h.update(memoryview(a).cast("B") if hasattr(a, "tobytes") else
                 repr(a).encode())
    return h.hexdigest()


def compare(kind, outs, ref, limits):
    """(checks, failed): the worst reading of each number over every
    output of the window, beside its limit, and how many outputs broke a
    limit.  Outputs that are bit-identical are compared once."""
    seen, worst, failed = {}, {}, 0
    for out in outs:
        d = _digest(out)
        if d not in seen:
            seen[d] = kind.numbers(out, ref)
        nums = seen[d]
        failed += any(nums[k] > limits[k] for k in limits)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return checks, failed


def build_files():
    """{path: (size, mtime)} of the program's kernel and native builds
    (``joltqc_tpu_torch/_build/``, found without importing the package): a
    set-up that changes it built something."""
    spec = importlib.util.find_spec("joltqc_tpu_torch")
    if spec is None or not spec.submodule_search_locations:
        return {}
    top = os.path.join(spec.submodule_search_locations[0], "_build")
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(workload, seed, seconds, trace, device="cuda", fault=None,
        chips_check=True, root=ROOT, data=HERE):
    """One run; returns the result dict (the last stdout line), or raises
    SystemExit where it may not give a result.  For the harness's own
    tests: ``fault``, a callable(driver, fn) returning the timed call
    broken underneath; ``chips_check`` False skips the look for a card;
    ``root`` and ``data`` point at another BENCHMARK.json and files."""
    import torch

    cell = Cell.load(workload, root, data)
    dev = torch.device(device)
    if chips_check:
        need = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"qcbench: {workload} needs {need} CUDA "
                             "device(s); none or too few found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k, v in cell.config.get("env", {}).items():
        os.environ[k] = str(v)
    kind = call_kind(cell)

    t = time.perf_counter()
    inputs = make_inputs(kind, cell, seed, dev)
    say(f"qcbench: inputs made in {time.perf_counter() - t:.3f} s (nao "
        f"{inputs.ref_mol.nao}, not set-up)")
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- set-up: the program's import, driver, set-up steps, warm-up
    built_before = build_files()
    t_setup = time.perf_counter()
    import joltqc_tpu_torch  # noqa: F401

    driver, spans = build_driver(cell, inputs, dev)
    fn = kind.bind(driver, inputs, cell)
    if fault is not None:
        fn = fault(driver, fn)
    warmup = int(cell.traffic["warmup_calls"])
    for k in range(warmup):
        fn(k)
    sync(dev)
    setup_s = time.perf_counter() - t_setup
    compiled = build_files() != built_before
    setup_counters = counters(driver)
    say(f"qcbench: set-up {setup_s:.3f} s; spans {spans}; "
        + ("built kernels (a first run in this checkout)" if compiled
           else "every kernel already built"))

    # ---- the measured window
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function("qcbench.window")
        span.__enter__()
    t0, timeline, outs = run_window(fn, warmup, seconds, dev)
    if trace:
        span.__exit__(None, None, None)
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        say(f"qcbench: profiler stopped in {time.perf_counter() - t:.3f} s")
    per_call = per_call_seconds(timeline, t0)
    window_s = timeline[-1][1] - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    durs = sorted(e - s for s, e in timeline)
    say(f"qcbench: window {window_s:.3f} s, {len(timeline)} calls, "
        f"{per_call:.6f} s a call (shortest {durs[0]:.4f}, median "
        f"{durs[len(durs) // 2]:.4f}, longest {durs[-1]:.4f} s)")

    ctx = Context(cell, inputs, dev, len(timeline), window_s, per_call,
                  spans, {"setup": setup_counters,
                          "window": counters(driver)})
    result_metrics = {}
    breakdown = None
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": int(cell.workload["chips"]),
                "memory_peak_bytes": int(peak)}
    if trace:
        from .trace import from_profiler

        t = time.perf_counter()
        ctx.trace = from_profiler(prof)
        prof = None
        for m in cell.per_layer():
            v = reader(m["name"], cell.data)(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        if ctx.trace is not None:
            dev_info["busy_s"] = ctx.trace.busy_s()
            dev_info["window_s"] = ctx.trace.window_s
            breakdown = {"device_ops": [list(x) for x in
                                        ctx.trace.top_ops(10)],
                         "idle_gaps": ctx.trace.idle_gaps(10)}
        say(f"qcbench: trace read in {time.perf_counter() - t:.3f} s")
    else:
        values = {"setup_s": setup_s,
                  **window_metrics(kind, cell.traffic, timeline, t0, outs)}
        for m in cell.end_to_end():
            if m["name"] not in values:
                raise KeyError(f"the mix {cell.workload['traffic']!r} "
                               f"gives no end-to-end value {m['name']!r}")
            result_metrics[m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}

    # ---- the program's state freed, then the reference
    del driver, fn, ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = kind.reference(inputs, cell.config, cell.limits, dev)
    checks, failed = compare(kind, outs, ref, cell.limits["checks"])
    say(f"qcbench: reference in {time.perf_counter() - t:.3f} s (not "
        "set-up, not in the window)")
    correct = failed == 0
    bad = loaded_forbidden()
    if bad:
        raise SystemExit(f"qcbench: forbidden modules loaded: {bad}")
    for k, c in checks.items():
        say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    out = {"correct": correct, "attempted": len(timeline), "failed": failed,
           "metrics": result_metrics, "device": dev_info,
           "compiled": compiled}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
