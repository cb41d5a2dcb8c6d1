"""The program's span counters as the harness copies them into
``ctx.counters`` (``{"setup" | "window": {"jk.timing": ..., "veff_time":
...}}``): a sum of spans per call in the window, or a counter at the end
of set-up; None where the program keeps no such counter (shared by the
span readers)."""

from __future__ import annotations


def per_call(ctx, owner, keys):
    """The window's growth of the summed counters ``keys`` of ``owner``
    over the calls completed in it."""
    before = ctx.counters.get("setup", {}).get(owner)
    after = ctx.counters.get("window", {}).get(owner)
    if before is None or after is None or not ctx.calls:
        return None
    if any(k not in after for k in keys):
        return None
    return sum(after[k] - before.get(k, 0.0) for k in keys) / ctx.calls


def at_setup(ctx, owner, key):
    """The counter ``key`` of ``owner`` at the end of set-up."""
    return ctx.counters.get("setup", {}).get(owner, {}).get(key)
