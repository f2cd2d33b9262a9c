"""One file a metric, named as the metric is in BENCHMARK.json; each has
read(ctx) -> float | None (None: nothing to read in this run, and the metric
is left out of the result line).  ctx is harness.Context."""
