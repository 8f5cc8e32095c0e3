"""Per-layer metric readers: ``<metric name>.py`` holds ``read(ctx)``,
which returns the metric's value from the traced run's readings, or
``None`` when it finds nothing to read (the metric is then left out)."""
