"""How long a frame waits for its batch to fill (``ffs.batch_fill`` spans:
from the frame's intake into the CLI's batch buffer to the start of its
batch's flush), per frame, in a live batched cell, where a frame released
first in its batch waits for the rest of the batch to be released."""

from ffsbench.ffs_trace import ms_per_frame


def read(run):
    return ms_per_frame(run, "ffs.batch_fill")
