"""Device time of host-to-device copies in the trace, over the frames the
traced run processed."""


def read(run):
    t = run.trace
    if t is None or not t.device or not run.frames:
        return None
    ms = sum(s for cat, name, s in t.device if cat == "gpu_memcpy" and "HtoD" in name) * 1e3
    return ms / run.frames
