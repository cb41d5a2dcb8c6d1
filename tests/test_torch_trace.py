"""The port's spans (utils/trace.py) on the CPU: counters always, profiler
ranges only while a profiler records; the ranges ``get_jk`` and
``get_veff`` emit and how they nest; each counter against the length of
its ranges; the trace reduction naming an idle gap by the innermost
``jqc.*`` span; and the benchmark's span readers on made-up counters."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from joltqc_tpu_torch.dft.grids import Grids
from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.scf import RKS, JKEngine
from joltqc_tpu_torch.utils import trace

torch.set_num_threads(1)

H2O = "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696"
JK_LEAVES = ("prepare", "launch", "drain", "unfold")
PLAN_STEPS = ("schwarz_q", "screen", "layout")
DFT_LEAVES = ("rho", "xc", "rows", "vxc", "to_mol")


def _dm(nao, seed=7):
    a = np.random.default_rng(seed).uniform(-0.5, 0.5, (nao, nao))
    return a + a.T


def _ranges(prof, prefix):
    """{name: [(start, end) in seconds]} of the profile's ranges whose
    name starts with ``prefix``, from its raw events (as qcbench/trace.py
    reads them: building the event tree takes seconds)."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(prefix):
            out.setdefault(ev.name(), []).append(
                (ev.start_ns() * 1e-9, ev.end_ns() * 1e-9))
    return out


def _inside(inner, outer):
    return any(os <= s and e <= oe for s, e in inner for os, oe in outer)


def _profiled(call, prefix):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return _ranges(prof, prefix)


def _check_counters(run, names, prefix, keys=None, tries=3):
    """Each counter's growth over a profiled call within 1 ms of the
    summed length of its ranges, in the best of ``tries`` calls.  ``run()``
    makes one call and returns (counts before, counts after, ranges).  A
    range also holds the profiler's own work on entry and exit, which the
    counter leaves out: tens of microseconds, stretched to milliseconds
    now and then by a busy host, hence the best of three."""
    off = {}
    for _ in range(tries):
        before, counts, r = run()
        for n in names:
            k = (keys or {}).get(n, n + "_s")
            grew = counts[k] - before.get(k, 0.0)
            length = sum(e - s for s, e in r[prefix + n])
            assert grew > 0.0, n
            off[n] = min(off.get(n, np.inf), abs(grew - length))
    assert max(off.values()) < 1e-3, off


@pytest.fixture(scope="module")
def water():
    return Molecule.from_atom_string(H2O, basis="sto-3g")


def test_span_without_profiler_adds_seconds_only(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    counts = {}
    with trace.span(counts, "jk.prepare") as sp:
        sum(range(1000))
    with trace.span(counts, "jk.prepare"):
        pass
    with trace.span(counts, "dft.layer", "dft"):
        pass
    with trace.span(None, "jk.get_jk"):
        pass
    assert set(counts) == {"prepare_s", "dft"}
    assert counts["prepare_s"] >= sp.seconds > 0.0
    trace.add(counts, plan_builds=1, prepare_s=1.0)
    assert counts["plan_builds"] == 1
    assert counts["prepare_s"] > 1.0


def test_get_jk_spans_nest_and_match_counters(water):
    lay = BasisLayout(water)
    dm = _dm(water.nao)

    def cold():
        eng = JKEngine(lay, device="cpu")
        return {}, eng.timing, _profiled(lambda: eng.get_jk(dm), "jqc.jk.")

    _, timing, r = cold()
    root = r["jqc.jk.get_jk"]
    assert len(root) == 1
    for n in JK_LEAVES + ("plan_build", "upload") + PLAN_STEPS:
        assert _inside(r["jqc.jk." + n], root), n
    for n in PLAN_STEPS:
        assert _inside(r["jqc.jk." + n], r["jqc.jk.plan_build"]), n
    assert _inside(r["jqc.jk.plan_build"], r["jqc.jk.prepare"])
    assert _inside(r["jqc.jk.upload"], r["jqc.jk.launch"])
    assert "get_jk_s" not in timing
    plan_s = timing["plan_build_s"]
    assert timing["schwarz_q_s"] + timing["screen_s"] <= plan_s
    # one range a call
    _check_counters(cold, ("plan_build",), "jqc.jk.")

    # a warm call: the plan is kept, the leaves tile the call
    eng = JKEngine(lay, device="cpu")
    eng.get_jk(dm)

    def warm():
        before = dict(eng.timing)
        return before, eng.timing, _profiled(lambda: eng.get_jk(dm),
                                             "jqc.jk.")

    r = warm()[2]
    assert set(r) == {"jqc.jk.get_jk"} | {"jqc.jk." + n for n in JK_LEAVES}
    (s, e), = r["jqc.jk.get_jk"]
    leaves = sum(b - a for n in JK_LEAVES for a, b in r["jqc.jk." + n])
    assert 0.5 * (e - s) < leaves <= e - s
    _check_counters(warm, JK_LEAVES, "jqc.jk.")


def test_get_veff_emits_the_dft_spans(water):
    mf = RKS(water, xc="b3lyp", grids=Grids(water, n_rad=20, n_ang=50),
             device="cpu")
    mf.grids.build()
    assert set(mf.grids.timing) == {"build_s", "becke_s"}
    assert mf.grids.timing["becke_s"] <= mf.grids.timing["build_s"]
    dm = _dm(water.nao)
    mf.get_veff(dm)

    def call():
        before = dict(mf.veff_time)
        return before, mf.veff_time, _profiled(lambda: mf.get_veff(dm),
                                               "jqc.")

    r = call()[2]
    for n in DFT_LEAVES:
        assert _inside(r["jqc.dft." + n], r["jqc.dft.layer"]), n
    assert _inside(r["jqc.jk.get_jk"], r["jqc.dft.jk"])
    _check_counters(call, DFT_LEAVES + ("layer", "jk"), "jqc.dft.",
                    {"layer": "dft", "jk": "jk"})


def test_idle_gap_named_by_innermost_span(water):
    from qcbench.trace import WINDOW_SPAN, Trace, from_profiler

    # synthetic: a gap inside get_jk's unfold, and one under no span
    host = [("jqc.jk.get_jk", 0.0, 1.0), ("jqc.jk.drain", 0.1, 0.4),
            ("aten::copy_", 0.3, 0.35), ("jqc.jk.unfold", 0.5, 0.95)]
    dev = [("eri_class_kernel", 0.0, 0.55), ("contract_kernel", 0.9, 1.2),
           ("eri_class_kernel", 1.5, 2.0)]
    tr = Trace((0.0, 2.0), dev, host)
    assert tr.idle_gaps(2) == [
        ["jqc.jk.unfold", pytest.approx(0.35)],
        ["host between jqc.jk.get_jk and window end", pytest.approx(0.3)]]
    # the program's own ranges, read from a real profile
    eng = JKEngine(BasisLayout(water), device="cpu")
    dm = _dm(water.nao)
    eng.get_jk(dm)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_SPAN):
            eng.get_jk(dm)
    tr = from_profiler(prof)
    (s, e), = [(a, b) for n, a, b in tr.host if n == "jqc.jk.unfold"]
    tr.device = [("k", tr.window[0], s), ("k", e, tr.window[1])]
    assert tr.idle_gaps(1) == [["jqc.jk.unfold", pytest.approx(e - s)]]


def _ctx(setup, window, calls=4):
    return SimpleNamespace(counters={"setup": setup, "window": window},
                           calls=calls)


READERS = {
    # metric: (owner, {key: (set-up value, window value)}, expected)
    "jk_host_s.fock": ("jk.timing", {"prepare_s": (1.0, 1.2),
                                     "unfold_s": (0.5, 0.6)}, 0.075),
    "jk_launch_s.fock": ("jk.timing", {"launch_s": (2.0, 2.4)}, 0.1),
    "dft_host_s.veff": ("veff_time", {"rows_s": (0.1, 0.5),
                                      "to_mol_s": (0.0, 0.04)}, 0.11),
    "schwarz_q_s.setup": ("jk.timing", {"schwarz_q_s": (0.7, 0.7)}, 0.7),
    "task_screen_s.setup": ("jk.timing", {"screen_s": (1.5, 1.5)}, 1.5),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader(metric):
    from qcbench.harness import reader

    owner, vals, want = READERS[metric]
    read = reader(metric)
    setup = {owner: {k: v[0] for k, v in vals.items()}}
    window = {owner: {k: v[1] for k, v in vals.items()}}
    assert read(_ctx(setup, window)) == pytest.approx(want)
    # a program that keeps no such counter (the parent of the spans)
    assert read(_ctx({owner: {"plan_build_s": 3.0}},
                     {owner: {"plan_build_s": 3.0}})) is None
    assert read(_ctx({}, {})) is None
