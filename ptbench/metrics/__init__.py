"""One reader a metric: ptbench/metrics/<name>.py defines read(record),
the metric's value from a run's record (ptbench.run.Record), or None
where the run has nothing for it to read."""
