"""Per-layer metric readers, one file per metric (harness.reader)."""
