"""A torch.profiler Chrome trace of the spotfinder's collection loop, reduced
to what the per-layer metrics read: the traced span, the device's busy
intervals, device time by event name and kind, and the longest device idle
gaps with the host operation that ran across each."""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


@dataclass
class Trace:
    span_s: float  # the profiler's window (its "Trace" event, else all events)
    busy_s: float  # union of device events' intervals
    device: list[tuple[str, str, float]]  # (cat, name, seconds) of each device event
    gaps: list[tuple[str, float]] = field(default_factory=list)  # longest idle gaps


def _union(intervals):
    busy, end, merged = 0.0, float("-inf"), []
    for t0, t1 in sorted(intervals):
        if t0 > end:
            merged.append([t0, t1])
        else:
            merged[-1][1] = max(merged[-1][1], t1)
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy, merged


def host_at(t: float, host: list, ends: list) -> str:
    """What the host was doing at ``t``: the longest traced host operation
    running then, or else the one that ended last before it (the CLI's
    Python, NumPy and reader threads leave no events of their own)."""
    over = [(t1 - t0, name) for t0, t1, name in host if t0 <= t <= t1]
    if over:
        return max(over)[1]
    i = bisect.bisect_left(ends, (t, "")) - 1
    return f"after {ends[i][1]}" if i >= 0 else "before any host operation"


def read(path, n_gaps: int = 10) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "Trace"]
    if spans:
        t_lo, t_hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    else:
        t_lo = min(e["ts"] for e in events)
        t_hi = max(e["ts"] + e["dur"] for e in events)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy_us, merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps = []
    if merged:
        holes = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                       reverse=True)[:n_gaps]
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                      if e.get("cat") in HOST_CATS)
        ends = sorted((t1, name) for _, t1, name in host)
        for width, g0, g1 in holes:
            gaps.append((host_at((g0 + g1) / 2, host, ends), width / 1e6))
    return Trace(span_s=(t_hi - t_lo) / 1e6, busy_s=busy_us / 1e6,
                 device=[(e["cat"], e["name"], e["dur"] / 1e6) for e in dev], gaps=gaps)


def top_device_ops(trace: Trace, n: int = 10) -> list[list]:
    by_name: dict[str, float] = {}
    for _, name, s in trace.device:
        by_name[name] = by_name.get(name, 0.0) + s
    return [[name[:120], s] for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
