"""One reader a metric: ``bench/metrics/<name>.py``; a metric
``<name>.<phase>`` is read by ``<name>.py`` given the phase. ``read(run,
phase)`` returns the metric's value from the run's record (``bench.harness
.Record``), or None where the run has nothing to read for it."""
