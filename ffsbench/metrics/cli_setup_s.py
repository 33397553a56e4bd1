"""The CLI's own set-up, by its ``ffs.setup`` span: from the entry of
``pipeline/spotfinder.py:run`` (imports of the spotfinder's modules, the
CUDA start, the reader, the processor and its mask upload, the profiler's
start) to the collection loop's first poll."""

from ffsbench.ffs_trace import span


def read(run):
    s = span(run, "ffs.setup")
    return s["total_ms"] / 1e3 if s else None
