"""The trace reduction on a hand-made Chrome trace: the span, the device's
busy union, the top device operations and the idle gaps' host labels."""

from __future__ import annotations

import json

from ffsbench import trace


def test_trace_reduction(tmp_path):
    ev = [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 150, "dur": 100},  # overlaps k1
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 600, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 900, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 300, "dur": 200},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 660, "dur": 10},
        {"ph": "i", "cat": "instant", "name": "ignored", "ts": 5},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = trace.read(path)
    assert t.span_s == 1000e-6
    assert abs(t.busy_s - (150 + 50 + 20) * 1e-6) < 1e-12
    assert trace.top_device_ops(t, 2) == [["k1", 120e-6], ["k2", 100e-6]]
    # gaps: 250-600 (mid 425, inside aten::copy_) and 650-900 (mid 775, after aten::add)
    assert [g[0] for g in t.gaps] == ["aten::copy_", "after aten::add"]
    assert [round(g[1] * 1e6) for g in t.gaps] == [350, 250]
