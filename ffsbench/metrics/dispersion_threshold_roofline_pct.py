"""The dispersion-threshold kernel (``dispersion_walker``) against its byte
bound: each frame and the mask read once, the packed output written once
(``ffsbench.rooflines.threshold_bytes``), at 3.35 TB/s, over its mean
device time a launch in the trace."""

from ffsbench.rooflines import share_pct, threshold_bytes


def read(run):
    return share_pct(run, "dispersion_walker", threshold_bytes)
