"""Seconds of the grid build in set-up: the harness's span around the
configuration's set-up step ``grids.build``."""


def read(ctx):
    return ctx.spans.get("grid_build_s")
