"""Per-layer readers, one file per metric, loaded by path by the harness."""
