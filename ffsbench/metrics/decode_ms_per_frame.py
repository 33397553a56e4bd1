"""A reader thread's time to read and bitshuffle-LZ4 decode one image
(``ffs.fetch`` spans), per frame: thread time, spread over the CLI's
reader threads, not wall time of the loop."""

from ffsbench.ffs_trace import ms_per_frame


def read(run):
    return ms_per_frame(run, "ffs.fetch")
