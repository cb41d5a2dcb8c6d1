"""Persistence and tuning of the J/K engine: the plan and Schwarz-q disk
caches (plancache.py) and the per-device autotune table (autotune.py)."""
