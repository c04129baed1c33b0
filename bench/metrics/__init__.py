"""The per-layer metrics' readers, one file a metric, found by name."""
