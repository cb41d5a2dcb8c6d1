"""Seconds of task-plan builds in set-up, by the program's own counter
(JKEngine.timing['plan_build_s'], kernel A's Schwarz bounds included)."""


def read(ctx):
    return ctx.counters["setup"]["jk.timing"].get("plan_build_s")
