"""The extended-threshold kernel (``extended_walker``) against its byte
bound: the compulsory bytes of a launch (each frame, the mask and the packed
output once) at 3.35 TB/s, over its mean device time a launch in the trace.
The launch's frames are the CLI's ``--batch``; the byte count is the
benchmark's own, from the shapes."""

from ffsbench.peaks import HBM_BYTES_PER_S, extended_threshold_bytes


def read(run):
    t = run.trace
    if t is None:
        return None
    times = [s for cat, name, s in t.device if cat == "kernel" and "extended_walker" in name]
    if not times:
        return None
    flags = run.config["spotfinder"]["cli_flags"]
    batch = int(flags[flags.index("--batch") + 1]) if "--batch" in flags else 1
    det = run.config["detector"]
    nbytes = extended_threshold_bytes(batch, det["height"], det["width"], det["bit_depth"] // 8)
    return 100.0 * nbytes / HBM_BYTES_PER_S / (sum(times) / len(times))
