"""The rate of the frames' uploads: the bytes the CLI passed to
``.to(device)`` for frames or planes in its collection loop (its
``h2d_bytes`` counter), over the device time of the host-to-device copies
in the trace of that loop, in GB/s."""

from ffsbench.ffs_trace import report


def read(run):
    rep, t = report(run), run.trace
    if rep is None or t is None:
        return None
    s = sum(s for cat, name, s in t.device if cat == "gpu_memcpy" and "HtoD" in name)
    nbytes = rep["counters"].get("h2d_bytes", 0)
    return nbytes / s / 1e9 if s and nbytes else None
