"""One reader a metric: ``<metric name>.py`` defines ``read(run)``, which
returns the metric's value from the run's record (``ffsbench.run.Run``), or
None where the run holds nothing to read (then the metric is left out)."""
