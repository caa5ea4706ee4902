"""Per-layer readers, one module a metric, found by the metric's name."""
