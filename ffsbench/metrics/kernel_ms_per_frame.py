"""Device time of every kernel in the trace, over the frames the traced run
processed."""


def read(run):
    t = run.trace
    if t is None or not t.device or not run.frames:
        return None
    return sum(s for cat, _, s in t.device if cat == "kernel") * 1e3 / run.frames
