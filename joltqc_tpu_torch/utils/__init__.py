"""Persistence, tuning and tracing of the port: the plan and Schwarz-q
disk caches (plancache.py), the per-device autotune table (autotune.py)
and the spans on the counters and the profiler's clock (trace.py)."""
