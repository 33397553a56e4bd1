"""The spotfinder CLI's spans and counters (``ffs_tpu_torch/utils/tracing.py``)
and the benchmark's readers of them (``ffsbench/metrics``).

The CLI runs on the stream dump of ``test_torch_batch.py`` with
``--jax-profile`` and ``--threads 2``, per frame and ``--batch 4``: the
main thread's spans are flat events of the profiler's trace, ``spans.json``
sits on the trace's time base, and the counters count what the run did."""

from __future__ import annotations

import json
import os
import re
import signal
import threading

import pytest

from ffs_tpu_torch.utils import tracing

from .test_torch_batch import _run_cli, shm_dir  # noqa: F401  (a fixture)

MAIN_SPANS = {"ffs.reader_wait", "ffs.submit", "ffs.decode_wait", "ffs.upload", "ffs.dispatch",
              "ffs.collect", "ffs.push3d", "ffs.emit", "ffs.release"}
WAIT_LINE = re.compile(r"Total time waiting for images to appear: ([0-9.]+) (ms|s)")
H, W, N_IMAGES = 96, 128, 5  # the stream dump's frames


def _ffs_trace(log: str) -> dict:
    lines = [ln for ln in log.splitlines() if ln.startswith('{"ffs_trace"')]
    assert len(lines) == 1, log
    return json.loads(lines[0])["ffs_trace"]


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracing.start(False)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_span_off_is_the_shared_noop_and_records_nothing():
    rec = tracing.start(False)
    s = tracing.span("ffs.collect", frame=3)
    assert s is tracing.NOOP and tracing.span("ffs.emit") is s
    with s:
        pass
    tracing.at(7, 2)
    tracing.record("ffs.inflight", 0, 1, 1, tracing.QUEUE)
    assert tracing.stamp() == 0
    tracing.count("frames_in", 2)
    assert rec.spans == [] and rec.frame == (None, 1)
    assert tracing.report(0, 0) == {"counters": {**dict.fromkeys(tracing.COUNTERS, 0),
                                                 "frames_in": 2}}


def test_nested_spans_stay_flat_in_the_trace():
    from torch.profiler import ProfilerActivity, profile

    rec = tracing.start(True)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    tracing.at(4, 2)
    with tracing.span("ffs.collect"):
        with tracing.span("ffs.upload", frame=9):  # recorder only
            pass
        with tracing.span("ffs.collect"):  # its own name: nothing
            pass
    t = threading.Thread(target=lambda: tracing.span("ffs.fetch", frame=5).__enter__().__exit__())
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    with tracing.span("ffs.fetch", frame=6, annotate=False):
        pass
    prof.stop()
    names = [e.name for e in prof.events() if e.name.startswith("ffs.")]
    assert names == ["ffs.collect"]
    got = [(name, thread == rec.main, frame, frames)
           for name, _, _, thread, frame, frames in rec.spans]
    assert got == [("ffs.upload", True, 9, 1), ("ffs.collect", True, 4, 2),
                   ("ffs.fetch", False, 5, 1), ("ffs.fetch", True, 6, 1)]


def test_report_sums_spans_and_the_main_threads_cover():
    rec = tracing.start(True)
    ms = 1_000_000
    rec.spans += [
        ("ffs.collect", 0, 4 * ms, rec.main, 0, 2),
        ("ffs.collect", 5 * ms, 7 * ms, rec.main, 2, 2),
        ("ffs.upload", 6 * ms, 8 * ms, rec.main, 2, 2),  # overlaps: counted once
        ("ffs.fetch", 0, 10 * ms, rec.main + 1, 0, 1),  # another thread
        ("ffs.inflight", 0, 10 * ms, tracing.QUEUE, 0, 1),
    ]
    rep = tracing.report(0, 10 * ms, launches={"k": 3})
    assert rep["launches"] == {"k": 3}
    assert rep["spans"]["ffs.collect"] == {"n": 2, "frames": 4, "total_ms": 6.0,
                                           "p50_ms": 3.0, "p95_ms": pytest.approx(3.9)}
    assert rep["loop_ms"] == 10.0 and rep["main_covered_pct"] == pytest.approx(70.0)


def test_trace_base_is_read_from_the_head_of_the_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text('{"schemaVersion": 1, "baseTimeNanoseconds": 1790857026000000000, '
                    '"traceEvents": []}')
    assert tracing.trace_base_ns(str(path)) == 1790857026000000000


def test_count_loses_no_update_across_threads():
    """Reader threads count beside the main thread: more threads than
    cores, a switch every microsecond, no add lost."""
    import sys

    rec = tracing.start(False)
    n_threads, n_adds = 4 * (os.cpu_count() or 1), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tracing.count("host_decode_vector")
                                                    for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rec.counts["host_decode_vector"] == n_threads * n_adds


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 4], ids=["per_frame", "batch4"])
def test_cli_spans_on_the_profilers_clock(batch, shm_dir, tmp_path):  # noqa: F811
    trace_dir = tmp_path / "trace"
    args = [str(shm_dir), "--threads", "2", "--jax-profile", str(trace_dir), "--save-h5"]
    if batch > 1:
        args += ["--precision", "f32", "--batch", str(batch), "--min-spot-size", "1"]
    log, lines = _run_cli("ffs_tpu_torch", args, tmp_path / "run",
                          {"FFS_TORCH_KERNEL_PATH": "1"} if batch > 1 else {})
    rep = _ffs_trace(log)
    trace = json.loads((trace_dir / "trace.json").read_text())
    spans = json.loads((trace_dir / "spans.json").read_text())
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]

    ann = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                  and e["name"].startswith("ffs.")), key=lambda e: e["ts"])
    # a batch's lines go out in one ffs.emit; its 3D pushes are recorded within
    main = MAIN_SPANS if batch == 1 else MAIN_SPANS - {"ffs.push3d"} | {"ffs.stack"}
    assert {e["name"] for e in ann} == main
    for a, b in zip(ann, ann[1:]):
        assert a["ts"] + a["dur"] <= b["ts"] + 1e-3, (a, b)  # flat: none overlaps the next

    ev = [e for e in spans["traceEvents"] if e["ph"] == "X"]
    main_tid = ann[0]["tid"]
    fetch = [e for e in ev if e["name"] == "ffs.fetch"]
    assert len(fetch) == N_IMAGES and all(e["tid"] != main_tid for e in fetch)
    for a in ann:  # each annotation has its copy in spans.json, within 1 ms
        assert min(abs(a["ts"] - e["ts"]) + abs(a["dur"] - e["dur"])
                   for e in ev if e["name"] == a["name"] and e["tid"] == main_tid) < 1000.0

    m = WAIT_LINE.search(log)
    waited_ms = float(m.group(1)) * (1e3 if m.group(2) == "s" else 1.0)
    assert abs(rep["spans"]["ffs.reader_wait"]["total_ms"] - waited_ms) <= 1.0

    c = rep["counters"]
    uploaded = N_IMAGES if batch == 1 else -(-N_IMAGES // batch) * batch  # the tail pads to B
    assert c["frames_in"] == N_IMAGES == len(lines) == c["lines_out"]
    assert c["h2d_bytes"] == uploaded * H * W * 2
    assert c["batches"] == (0 if batch == 1 else 2)
    assert c["fallback_batch_overflow"] == c["fallback_host_decode"] == 0
    assert rep["spans"]["ffs.setup"]["n"] == rep["spans"]["ffs.epilogue"]["n"] == 1
    assert rep["spans"]["ffs.inflight"]["frames"] == N_IMAGES
    assert rep["spans"]["ffs.collect"]["frames"] == N_IMAGES
    assert rep["spans"]["ffs.emit"]["frames"] == rep["spans"]["ffs.push3d"]["frames"] == N_IMAGES
    assert 90.0 <= rep["main_covered_pct"] <= 100.0
    assert set(rep["launches"]) >= {"dispersion_packed", "dispersion_extended_packed",
                                    "bitshuffle_frames"}


def test_cli_without_profile_counts_but_records_no_span(shm_dir, tmp_path):  # noqa: F811
    log, lines = _run_cli("ffs_tpu_torch", [str(shm_dir), "--threads", "2"], tmp_path / "run", {})
    rep = _ffs_trace(log)
    assert set(rep) == {"counters", "launches"}
    assert rep["counters"]["frames_in"] == rep["counters"]["lines_out"] == len(lines) == N_IMAGES
    assert sorted(os.listdir(tmp_path / "run")) == []
    assert "spans.json" not in log and "frames past the batched" not in log


@pytest.mark.parametrize("mode", ["threads2", "inline", "device_decode"])
def test_cli_counts_the_vector_host_decode(mode, shm_dir, tmp_path):  # noqa: F811
    """Every bitshuffle-LZ4 frame of the stream that is decoded on the host,
    on two reader threads or one (``--threads 1``), takes the vector
    untranspose; frames sent to the card as planes are not counted."""
    from ffs_tpu_torch.io import compression

    args, extra = [str(shm_dir), "--threads", "1" if mode == "inline" else "2"], {}
    if mode == "device_decode":
        args += ["--precision", "f32", "--batch", "4", "--min-spot-size", "1",
                 "--decode-backend", "device"]
        extra = {"FFS_TORCH_KERNEL_PATH": "1"}
    log, lines = _run_cli("ffs_tpu_torch", args, tmp_path / "run", extra)
    c = _ffs_trace(log)["counters"]
    assert c["frames_in"] == len(lines) == N_IMAGES
    assert compression.untranspose_kind() > 0
    assert c["host_decode_vector"] == (0 if mode == "device_decode" else N_IMAGES)


def test_cli_prints_the_batched_overflow_fallback(shm_dir, tmp_path, monkeypatch,  # noqa: F811
                                                  capsys):
    """A frame past the batched per-frame capacity (16 slots here) runs on
    the per-frame path; the CLI counts it and says so at the end."""
    from ffs_tpu_torch import spotfind
    from ffs_tpu_torch.pipeline import spotfinder

    init = spotfind.SpotfindProcessor.__init__

    def small_slots(self, *a, **k):
        init(self, *a, **k)
        self._batch_kf = 16

    monkeypatch.setattr(spotfind.SpotfindProcessor, "__init__", small_slots)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TORCH_KERNEL_PATH", "1")
    monkeypatch.chdir(tmp_path)
    r, w = os.pipe()
    handler = signal.getsignal(signal.SIGINT)
    try:
        rc = spotfinder.run([str(shm_dir), "--precision", "f32", "--batch", "4",
                             "--min-spot-size", "1", "--pipe_fd", str(w)])
    finally:
        signal.signal(signal.SIGINT, handler)
    with os.fdopen(r) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    log = capsys.readouterr().out
    over = sum(p["num_strong_pixels"] > 16 for p in lines)
    assert rc == 0 and len(lines) == N_IMAGES and over > 0
    assert _ffs_trace(log)["counters"]["fallback_batch_overflow"] == over
    assert f"{over} frames past the batched per-frame capacity ran on the per-frame path" in log


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def _run_record(stdout: str, device=None):
    from ffsbench import trace as ftrace
    from ffsbench.run import Run

    run = Run(workload={}, config={}, config_file=None, traffic={}, seconds=40.0, t_start=0.0)
    run.cli_stdout = stdout
    if device is not None:
        run.trace = ftrace.Trace(span_s=10.0, busy_s=1.0, device=device)
    return run


def _span(total_ms, frames):
    return {"n": frames, "frames": frames, "total_ms": total_ms, "p50_ms": 0.0, "p95_ms": 0.0}


@pytest.mark.parametrize("metric,want", [
    ("cli_setup_s", 4.5),
    ("decode_ms_per_frame", 12.0),
    ("decode_wait_ms_per_frame", 0.5),
    ("collect_ms_per_frame", 3.0),
    ("push3d_ms_per_frame", 2.0),
    ("queue_ms_per_frame.live", 250.0),
    ("h2d_gbps", 2.0),
])
def test_benchmark_readers(metric, want):
    from ffsbench.run import read_metric

    report = {"counters": {**dict.fromkeys(tracing.COUNTERS, 0), "h2d_bytes": 3_000_000_000},
              "spans": {"ffs.setup": _span(4500.0, 1), "ffs.fetch": _span(1200.0, 100),
                        "ffs.decode_wait": _span(50.0, 100),
                        "ffs.collect": _span(300.0, 100), "ffs.push3d": _span(200.0, 100),
                        "ffs.inflight": _span(25000.0, 100)},
              "loop_ms": 40000.0, "main_covered_pct": 99.0}
    copies = [("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1.0),
              ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 0.5),
              ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 9.0), ("kernel", "k", 9.0)]
    stdout = "Total time waiting for images to appear: 3 ms\n" + json.dumps(
        {"ffs_trace": report}) + '\n{"ffsbench_cli": {"rc": 0}}\n'
    assert read_metric(metric, _run_record(stdout, copies)) == pytest.approx(want)
    # a program without the report line (the parent of the spans) reads nothing
    assert read_metric(metric, _run_record("3 images in 1.0 s\n", copies)) is None
