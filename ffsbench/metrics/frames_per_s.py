"""Frames completed per second in the window: the pipe lines that arrived
after the window opened (at the last warm-up line) and no later than its
end, over the window's length.  A stall anywhere in the window, its tail
included, lowers it."""


def read(run):
    inside = sum(1 for t, _ in run.lines if run.t0 < t <= run.t0 + run.seconds)
    return inside / run.seconds if inside else None
