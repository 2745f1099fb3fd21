"""Per-layer metric readers, one file a metric, named as the metric is in
``BENCHMARK.json``. Each ``read(run)`` returns the number, or None where
the run holds nothing for it to read."""
