"""Per-layer readers, one file a metric: ``read(rec)`` takes the traced
run's record (``run.traced_slice``) and returns the value, or None where it
finds nothing to read."""
