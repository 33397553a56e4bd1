"""How long a frame waits in the CLI's dispatch-ahead queue (``ffs.inflight``
spans: from the end of its dispatch to the start of its collect), per
frame, in the live cell, where that wait is part of every frame's
latency."""

from ffsbench.ffs_trace import ms_per_frame


def read(run):
    return ms_per_frame(run, "ffs.inflight")
