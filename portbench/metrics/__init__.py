"""Per-layer metric readers, one file per metric, loaded by file name."""
