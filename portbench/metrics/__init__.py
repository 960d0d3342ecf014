"""Per-layer metric readers, one file a metric, named as the metric.
Each has ``read(ctx) -> float | None`` over the run's ``harness.Ctx`` and
returns None where it finds nothing to read."""
