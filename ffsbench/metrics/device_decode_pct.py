"""The share of the frames the CLI took in whose bitshuffle planes became
frames on the card (its ``device_decode_frames`` counter over
``frames_in``), in percent: below 100 where device decode did not run, or a
frame fell back to the host's decode.  A program without the counter reads
nothing."""

from ffsbench.ffs_trace import report


def read(run):
    rep = report(run)
    if rep is None or "device_decode_frames" not in rep["counters"]:
        return None
    taken = rep["counters"].get("frames_in", 0)
    return 100.0 * rep["counters"]["device_decode_frames"] / taken if taken else None
