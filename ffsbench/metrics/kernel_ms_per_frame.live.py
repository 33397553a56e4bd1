"""Device time of every kernel in the trace, over the frames the traced run
processed: ``kernel_ms_per_frame`` read in the live cell, where it moves the
latency."""

from ffsbench.metrics.kernel_ms_per_frame import read  # noqa: F401
