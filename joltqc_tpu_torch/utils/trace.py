"""The port's spans: host walls added to its counters and, while a
``torch.profiler`` records, laid on the profiler's clock.

``with span(counts, "jk.prepare"):`` adds the block's wall seconds to
``counts["prepare_s"]`` (``key=`` names another counter; ``counts`` None
adds to none; the span keeps them as ``seconds``) and, only while a
profiler is on, runs the block inside ``record_function("jqc.jk.prepare")``:
the range then lies on the clock of the device activity the profiler
records, and nests under the ranges open on this thread.  The profiler
being on is the only switch: the check costs a fraction of a microsecond,
an unguarded ``record_function`` about 15.
"""

from __future__ import annotations

import time

import torch

PREFIX = "jqc."


def add(counts, **kv):
    """Add each value to its counter in ``counts`` (0 where absent)."""
    for k, v in kv.items():
        counts[k] = counts.get(k, 0) + v


class span:
    """Context manager of one span (module docstring)."""

    __slots__ = ("counts", "name", "key", "rf", "t0", "seconds")

    def __init__(self, counts, name, key=None):
        self.counts, self.name = counts, name
        self.key = key or name.rsplit(".", 1)[-1] + "_s"

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = self.seconds = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.counts is not None:
            self.counts[self.key] = self.counts.get(self.key, 0) + dt
        return False


__all__ = ["PREFIX", "add", "span"]
