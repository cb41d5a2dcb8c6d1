"""The traced window: device activity and host operations from
``torch.profiler``, reduced to busy time, idle share, device time by
kernel name and the longest idle gaps."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

WINDOW_SPAN = "qcbench.window"


@dataclass
class Trace:
    """Intervals in seconds on the profiler's clock.  ``device``: (name,
    start, end) of every kernel, copy and set on the card; ``host``:
    (name, start, end) of every host operation; ``window``: (start, end)
    of the harness's window span."""

    window: tuple
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def busy_s(self):
        return union_length(self.device, self.window)

    def device_time(self, pattern):
        """Summed device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n))

    def top_ops(self, n=10):
        by = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The n longest gaps between device operations inside the window,
        each named by the innermost host operation running at its middle."""
        gaps = []
        t = self.window[0]
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if s > t:
                gaps.append((s - t, t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((self.window[1] - t, t, self.window[1]))
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            inner = [(he - hs, name) for name, hs, he in self.host
                     if hs <= mid <= he]
            if inner:
                out.append([min(inner)[1], length])
                continue
            before = max(((he, name) for name, _, he in self.host
                          if he < mid), default=(0, "window start"))[1]
            after = min(((hs, name) for name, hs, _ in self.host
                         if hs > mid), default=(0, "window end"))[1]
            out.append([f"host between {before} and {after}", length])
        return out


def union_length(intervals, window):
    """Length of the union of (name, start, end) intervals, clipped to
    ``window`` = (start, end)."""
    lo, hi = window
    total = 0.0
    cur_s = cur_e = None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def from_profiler(prof):
    """A Trace of a ``torch.profiler.profile`` whose window was wrapped in
    ``record_function(WINDOW_SPAN)``; None when the profiler recorded no
    window span.  Reads the profiler's raw events, without building its
    tree of FunctionEvents (fifty times slower over a window)."""
    return from_events(prof.profiler.kineto_results.events())


def from_events(events):
    """A Trace of raw profiler events (``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``, ``is_user_annotation()``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window, device, host = None, [], []
    base = None
    for ev in events:
        if base is None:
            base = ev.start_ns()
        name = ev.name()
        s, e = (ev.start_ns() - base) * 1e-9, (ev.end_ns() - base) * 1e-9
        if ev.device_type() == cuda:
            # a user annotation (the window span itself) is mirrored on the
            # device's timeline, where it is no device activity
            if name != WINDOW_SPAN and not ev.is_user_annotation():
                device.append((name, s, e))
        elif name == WINDOW_SPAN:
            window = (s, e)
        else:
            host.append((name, s, e))
    if window is None:
        return None
    return Trace(window, device, host)
