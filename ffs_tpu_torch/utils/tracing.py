"""Spans and counters of the spotfinder CLI's collection loop.

Counters are always on: :func:`count` is one dict add under a lock (the
reader threads count too).  Spans record only while tracing is on, which
the CLI turns on with ``--jax-profile DIR`` (:func:`start`); while it is
off, :func:`span` returns one shared no-op object after a flag check, and
:func:`record`, :func:`stamp` and :func:`at` return at once.

A span keeps ``(name, t0_ns, t1_ns, thread, first image, frames)`` in
memory, its times from ``time.time_ns()``, the clock of the profiler's
Chrome trace.  On the main thread it also opens a profiler
``RecordFunction`` of the same name, so that it lands in ``trace.json`` as
an event of its own (category ``cpu_op``) on the profiler's clock.  The
main thread's annotated spans partition its loop flat: a main-thread span
opened inside another goes to the recorder only, and one opened inside a
span of its own name records nothing (a gap in the device's timeline is
named by the longest host event over it, so an enclosing annotation would
take every name).  Spans on other threads, and those opened with
``annotate=False``, go to the recorder only.  Span names are fixed strings;
the image number goes in the record.

At the end of a run :func:`report` sums the spans by name and
:func:`write_chrome` writes them as Chrome-trace ``X`` events on
``trace.json``'s time base (``spans.json``), for Perfetto beside it.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

import numpy as np

COUNTERS = (
    "frames_in",  # images taken in by the collection loop
    "lines_out",  # JSON lines written to the pipe (--pipe_fd)
    "batches",  # batches dispatched (--batch)
    "h2d_bytes",  # bytes of frames or planes passed to .to(device)
    "fallback_batch_overflow",  # frames past the batched capacity, run per frame
    "fallback_host_decode",  # frames of a mixed batch, decoded on the host under device decode
    "host_decode_vector",  # frames fetched through the host decode's vector untranspose
    "device_decode_frames",  # frames whose bit planes became frames on the device
    "f64_walker_frames",  # frames whose float64 threshold ran as the float64 walker
    "idle_drain_frames",  # frames emitted while intake found the next image not there yet
)
# the thread of spans that time a wait in a queue, not a thread's work:
# ffs.inflight (dispatched, not yet collected) and ffs.batch_fill (taken in,
# its batch not yet full)
QUEUE = 0

_on = False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class Recorder:
    """What one run of the CLI recorded."""

    def __init__(self, on: bool):
        self.counts = dict.fromkeys(COUNTERS, 0)
        self.lock = threading.Lock()
        self.spans: list[tuple] = []  # (name, t0_ns, t1_ns, thread, frame, frames)
        self.main = threading.get_native_id()
        self.open: list[str] = []  # the main thread's open spans, innermost last
        self.frame: tuple = (None, 1)  # set by at(): the frames the next spans work on
        if on:
            # the profiler's C++ RecordFunction guard: it costs ~1 us and
            # keeps the interpreter lock; torch.profiler.record_function
            # (~8 us) drops and retakes it on entry and exit, and the main
            # thread then queues for it behind the reader threads at every
            # span's edge, where no span covers the wait
            from torch._C._profiler import _RecordFunctionFast

            self.annotation = _RecordFunctionFast


_rec = Recorder(False)


def start(on: bool) -> Recorder:
    """A fresh recorder for one run; spans record only when ``on``."""
    global _rec, _on
    _rec, _on = Recorder(on), on
    return _rec


def count(name: str, n: int = 1) -> None:
    rec = _rec
    with rec.lock:
        rec.counts[name] += n


class _Span:
    __slots__ = ("name", "frame", "frames", "annotate", "t0", "fn", "main", "skip")

    def __init__(self, name, frame, frames, annotate):
        self.name, self.frame, self.frames, self.annotate = name, frame, frames, annotate

    def __enter__(self):
        rec = _rec
        self.main = threading.get_native_id() == rec.main
        self.skip = self.main and self.name in rec.open
        self.fn = None
        if self.main and not self.skip:
            if self.annotate and not rec.open:
                self.fn = rec.annotation(self.name)
                self.fn.__enter__()
            rec.open.append(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.skip:
            return False
        rec = _rec
        if self.fn is not None:
            self.fn.__exit__(*exc)
        if self.main:
            rec.open.pop()
        frame, frames = self.frame, self.frames
        if frame is None:
            frame, hinted = rec.frame
            frames = frames or hinted
        rec.spans.append((self.name, self.t0, t1, threading.get_native_id(), frame, frames or 1))
        return False


def span(name: str, frame: int | None = None, frames: int | None = None,
         annotate: bool = True):
    """A context manager that records the work inside it as ``name``;
    without ``frame`` it takes the frames last given to :func:`at`."""
    if not _on:
        return NOOP
    return _Span(name, frame, frames, annotate)


def at(frame: int, frames: int = 1) -> None:
    """The frames that the next spans without their own work on."""
    if _on:
        _rec.frame = (frame, frames)


def stamp() -> int:
    """Now, on the spans' clock, while tracing is on; else 0."""
    return time.time_ns() if _on else 0


def record(name: str, t0_ns: int, frame: int | None = None, frames: int = 1,
           thread: int | None = None) -> None:
    """A span from ``t0_ns`` (a :func:`stamp`) to now, to the recorder only;
    ``thread`` is the main thread's unless given (:data:`QUEUE` for a wait
    in a queue)."""
    if _on:
        _rec.spans.append((name, t0_ns, time.time_ns(), _rec.main if thread is None else thread,
                           frame, frames))


def _covered_ns(intervals, lo: int, hi: int) -> int:
    covered, end = 0, lo
    for t0, t1 in sorted(intervals):
        t0, t1 = max(t0, end), min(t1, hi)
        if t1 > t0:
            covered += t1 - t0
            end = t1
    return covered


def report(loop_t0: int = 0, loop_t1: int = 0, launches: dict | None = None) -> dict:
    """The run's counters, the kernels' launches and, while tracing is on,
    each span name's ``n``, ``frames``, ``total_ms``, ``p50_ms`` and
    ``p95_ms``, the loop's wall time and the share of it that the main
    thread's spans cover."""
    rec = _rec
    out: dict = {"counters": dict(rec.counts)}
    if launches is not None:
        out["launches"] = launches
    if not _on:
        return out
    by_name: dict[str, list] = {}
    for name, t0, t1, _, _, frames in rec.spans:
        by_name.setdefault(name, []).append((t1 - t0, frames))
    spans = {}
    for name, rows in sorted(by_name.items()):
        ms = np.array([d for d, _ in rows]) / 1e6
        p50, p95 = np.percentile(ms, [50, 95])
        spans[name] = {"n": len(rows), "frames": int(sum(f for _, f in rows)),
                       "total_ms": float(ms.sum()), "p50_ms": float(p50), "p95_ms": float(p95)}
    out["spans"] = spans
    loop = max(loop_t1 - loop_t0, 0)
    main = [(t0, t1) for _, t0, t1, thread, _, _ in rec.spans if thread == rec.main]
    out["loop_ms"] = loop / 1e6
    out["main_covered_pct"] = 100.0 * _covered_ns(main, loop_t0, loop_t1) / loop if loop else 0.0
    return out


BASE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def trace_base_ns(trace_path: str) -> int:
    """``baseTimeNanoseconds`` of a torch.profiler Chrome trace, which its
    header holds (its events' ``ts`` count microseconds from it); the file
    is not parsed whole (it runs to hundreds of MB)."""
    with open(trace_path, "rb") as f:
        m = BASE.search(f.read(1 << 20))
    if m is None:
        raise ValueError(f"{trace_path}: no baseTimeNanoseconds")
    return int(m.group(1))


def write_chrome(path: str, trace_path: str) -> None:
    """Every recorded span as a Chrome-trace ``X`` event on the time base of
    the profiler's trace at ``trace_path``: ``ts = (t0_ns - base) / 1000``."""
    base = trace_base_ns(trace_path)
    pid = os.getpid()
    names = {_rec.main: "main", QUEUE: "queues (batch fill, dispatch-ahead)"}
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": n}}
              for tid, n in names.items()]
    for name, t0, t1, thread, frame, frames in _rec.spans:
        events.append({"ph": "X", "cat": "ffs", "name": name, "pid": pid, "tid": thread,
                       "ts": (t0 - base) / 1000, "dur": (t1 - t0) / 1000,
                       "args": {"frame": frame, "frames": frames}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base}, f)
