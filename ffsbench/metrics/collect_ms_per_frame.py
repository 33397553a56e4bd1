"""The main thread's time in the processor's collect (``ffs.collect``
spans: the blocking device-to-host reads, host connected components, the
per-frame split of a batch), per frame."""

from ffsbench.ffs_trace import ms_per_frame


def read(run):
    return ms_per_frame(run, "ffs.collect")
