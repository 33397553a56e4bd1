"""The main thread's time blocked on a reader thread's decode of the next
image (``ffs.decode_wait`` spans), per frame: the part of decoding that
the reader threads do not hide."""

from ffsbench.ffs_trace import ms_per_frame


def read(run):
    return ms_per_frame(run, "ffs.decode_wait")
