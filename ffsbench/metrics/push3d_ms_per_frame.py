"""The main thread's time pushing each frame's strong pixels into the
streaming 3D merge (``ffs.push3d`` spans), per frame."""

from ffsbench.ffs_trace import ms_per_frame


def read(run):
    return ms_per_frame(run, "ffs.push3d")
