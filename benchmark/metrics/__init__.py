"""One reader a metric, found by its name in ``BENCHMARK.json``:
``read(record) -> float or None``. A reader that finds nothing to read in
a run's record returns None, and the run leaves the metric out."""
