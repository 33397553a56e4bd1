"""The spotfinder CLI's own report of its collection loop: the one line
``{"ffs_trace": {...}}`` it prints at the end of a run, with its counters
and, in a traced run (``--jax-profile``), each span's ``n``, ``frames``,
``total_ms``, ``p50_ms`` and ``p95_ms``.  A program that prints no such
line gives every reader here None."""

from __future__ import annotations

import json

PREFIX = '{"ffs_trace"'


def report(run) -> dict | None:
    for line in reversed(run.cli_stdout.splitlines()):
        if line.startswith(PREFIX):
            return json.loads(line)["ffs_trace"]
    return None


def span(run, name: str) -> dict | None:
    rep = report(run)
    return rep.get("spans", {}).get(name) if rep else None


def ms_per_frame(run, name: str) -> float | None:
    """A span's total time over the frames it worked on."""
    s = span(run, name)
    return s["total_ms"] / s["frames"] if s and s["frames"] else None
