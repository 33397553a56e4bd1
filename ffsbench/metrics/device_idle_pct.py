"""100 minus the device's busy share of the traced span: the union of its
kernel, copy and memset intervals over the profiler's window of the CLI's
collection loop."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
