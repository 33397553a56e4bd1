"""The device decode's kernel (``bitshuffle_frames_kernel``: a batch's
bitshuffle planes to frames) against its byte bound: the planes read once
and the frames written once (``ffsbench.rooflines.decode_bytes``), at 3.35
TB/s, over its mean device time a launch in the trace."""

from ffsbench.rooflines import decode_bytes, share_pct


def read(run):
    return share_pct(run, "bitshuffle_frames_kernel", decode_bytes)
