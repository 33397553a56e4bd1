"""The batched float32 path with device decode (``--precision f32 --batch B
--decode-backend device``), the path of the benchmark's
``eiger16m-rotation-f32b8`` cell, against the benchmark's plain reference.

Seeded rotation frames at a toy size (300 x 280, a multiple of 8 pixels,
under a module mask) from ``ffsbench.frames``, written as a stream by
``ffsbench.stream`` (bitshuffle-LZ4 chunks of ``ffsbench.codec``), run
through the CLI in this process on the kernels' plain versions
(``FFS_TORCH_KERNEL_PATH``), 10 images in batches of 4 (a tail of 2).
Every frame's strong pixels and spots, and the spot table, are held to
``ffsbench.reference`` in float32 (pixels exact, the table within 1e-9 of
each column's largest); the counters say which frames became frames on the
device, and ``ffs.batch_fill`` times each frame's wait for its batch.
Also: the benchmark's readers of the new counter, span and kernels, and the
kernels' byte counts against PERF.md section 6 (rows 1 and 5).
"""

from __future__ import annotations

import json
import os
import signal

import numpy as np
import pytest
import torch

from ffs_tpu_torch.utils import tracing

N_IMAGES, BATCH, FALLEN = 10, 4, 5
CONFIG = {
    "detector": {"height": 300, "width": 280, "bit_depth": 16, "pixel_size_mm": 0.075,
                 "trusted_max": 65530,
                 "mask": {"kind": "modules", "module": [140, 130], "gap": [20, 20],
                          "grid": [2, 2]}},
    "geometry": {"distance_mm": 250.0, "beam_center_px": [140.0, 150.0],
                 "wavelength_A": 0.976, "omega_start_deg": 0.0, "omega_increment_deg": 0.1},
    "spotfinder": {"algorithm": "dispersion", "precision": "f32", "min_spot_size": 3,
                   "min_spot_size_3d": 3, "max_peak_centroid_separation": 2.0},
}
TRAFFIC = {"distinct_frames": 6, "background": {"kind": "poisson", "mean": 2.0},
           "spots": {"count": 30, "intensity": {"kind": "wilson_acentric", "mean": 3000.0},
                     "sigma_px": [0.5, 1.2], "half_width": 2, "persist_frames": 2,
                     "margin": 8},
           "hit_rate": 1.0}
SEED = 2200000031


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracing.start(False)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """(stream directory, the reference's per-frame results and table)."""
    from ffsbench import reference
    from ffsbench import stream as fstream
    from ffsbench.frames import detector_mask, make_frames

    d = tmp_path_factory.mktemp("stream") / "stream"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FFS_TORCH_DEVICE", "cpu")  # the stream's frames are made on the CPU
        fstream.write(CONFIG, TRAFFIC, SEED, d, 2)
    for i in range(N_IMAGES):
        fstream.release(d, i, TRAFFIC["distinct_frames"])
    frames = make_frames(CONFIG, TRAFFIC, SEED, torch.device("cpu"))
    k = TRAFFIC["distinct_frames"]
    ref = reference.frames_spots(frames, detector_mask(CONFIG["detector"]), CONFIG, "f32",
                                 range(k))
    seq = [ref[n % k] for n in range(N_IMAGES)]
    assert sum(len(f.lin) for f in seq) > 0
    return d, seq, reference.rotation_table(seq, CONFIG)


def _run(d, tmp_path, monkeypatch, capsys, threads: int):
    """The CLI in this process; (its log, pipe lines, FrameResults by image,
    spans.json events)."""
    from ffs_tpu_torch import spotfind
    from ffs_tpu_torch.pipeline import spotfinder

    results = {}
    collect_batch = spotfind.SpotfindProcessor.collect_batch

    def keep(self, *a, **k):
        out = collect_batch(self, *a, **k)
        results.update((r.image_number, r) for r in out)
        return out

    monkeypatch.setattr(spotfind.SpotfindProcessor, "collect_batch", keep)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TORCH_KERNEL_PATH", "1")
    monkeypatch.chdir(tmp_path)
    geo, px = CONFIG["geometry"], CONFIG["detector"]["pixel_size_mm"]
    detector = {"distance": geo["distance_mm"], "beam_center_x": geo["beam_center_px"][0] * px,
                "beam_center_y": geo["beam_center_px"][1] * px, "pixel_size_x": px,
                "pixel_size_y": px}
    r, w = os.pipe()
    handler = signal.getsignal(signal.SIGINT)
    try:
        rc = spotfinder.run([str(d), "--images", str(N_IMAGES), "--threads", str(threads),
                             "--pipe_fd", str(w), "--detector", json.dumps(detector),
                             "--wavelength", str(geo["wavelength_A"]), "--save-h5",
                             "--precision", "f32", "--batch", str(BATCH),
                             "--decode-backend", "device", "--jax-profile", "trace"])
    finally:
        signal.signal(signal.SIGINT, handler)
    with os.fdopen(r) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    log = capsys.readouterr().out
    assert rc == 0, log
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())["traceEvents"]
    return log, lines, results, spans


@pytest.mark.parametrize("case", ["threads2", "inline", "fallback"])
def test_batched_f32_device_decode_matches_the_reference(case, stream, tmp_path, monkeypatch,
                                                          capsys):
    from ffs_tpu_torch.io import shm
    from ffsbench.compare import table_numbers
    from ffsbench.run import read_table

    d, want, table = stream
    if case == "fallback":  # one frame mid-stream comes without planes
        planes = shm.SHMRead.get_image_planes
        monkeypatch.setattr(shm.SHMRead, "get_image_planes",
                            lambda self, i: None if i == FALLEN else planes(self, i))
    log, lines, results, spans = _run(d, tmp_path, monkeypatch, capsys,
                                      1 if case == "inline" else 2)
    assert "unavailable" not in log

    assert [p["file-number"] for p in lines] == list(range(N_IMAGES))
    for p, ref in zip(lines, want):
        got = results[p["file-number"]]
        np.testing.assert_array_equal(got.pixels.linear_index, ref.lin)
        np.testing.assert_array_equal(got.pixels.intensity, ref.value)
        assert p["num_strong_pixels"] == got.n_strong_pixels == len(ref.lin)
        assert p["n_spots_total"] == got.n_spots == ref.n_spots
    assert table_numbers(read_table(tmp_path), table)["table_rows_diff"] == 0
    assert table_numbers(read_table(tmp_path), table)["table_dev"] <= 1e-9
    assert len(table["sigma_b_variance"]) > 0

    rep = json.loads(next(ln for ln in log.splitlines() if ln.startswith('{"ffs_trace"')))
    c = rep["ffs_trace"]["counters"]
    host = BATCH if case == "fallback" else 0  # the fallen frame's whole batch
    assert c["frames_in"] == N_IMAGES and c["batches"] == -(-N_IMAGES // BATCH)
    assert c["fallback_host_decode"] == host
    assert c["device_decode_frames"] == N_IMAGES - host

    fill = [e for e in spans if e.get("name") == "ffs.batch_fill"]
    assert sorted(e["args"]["frame"] for e in fill) == list(range(N_IMAGES))
    assert all(e["dur"] >= 0 and e["args"]["frames"] == 1 and e["tid"] == tracing.QUEUE
               for e in fill)
    assert rep["ffs_trace"]["spans"]["ffs.batch_fill"]["n"] == N_IMAGES


# ---------------------------------------------------------------------------
# the benchmark's readers and byte counts
# ---------------------------------------------------------------------------


EIGER = {"height": 4362, "width": 4148, "bit_depth": 16}


def test_the_kernels_byte_counts_match_perf_md():
    from ffsbench.rooflines import decode_bytes, threshold_bytes

    # PERF.md section 6: row 1, 59.0 MB for one frame; row 5, 289.5 MB a B = 4 launch
    assert round(threshold_bytes(1, 4362, 4148, 2) / 1e6, 1) == 59.0
    assert round(decode_bytes(4, 4362, 4148, 2) / 1e6, 1) == 289.5
    # the packed output: (B, H, 2 x 136) int32 at the dispersion window's halo
    assert threshold_bytes(8, 4362, 4148, 2) == 8 * 4362 * 4148 * 2 + 4362 * 4148 + 8 * 4362 * 272 * 4


def _record(counters=None, spans=None, device=None):
    from ffsbench import trace as ftrace
    from ffsbench.run import Run

    cfg = {"detector": EIGER, "spotfinder": {"cli_flags": ["--save-h5", "--precision", "f32",
                                                           "--batch", "8"]}}
    run = Run(workload={}, config=cfg, config_file=None, traffic={}, seconds=40.0, t_start=0.0)
    if counters is not None:
        report = {"counters": counters, "spans": spans or {}}
        run.cli_stdout = json.dumps({"ffs_trace": report}) + "\n"
    if device is not None:
        run.trace = ftrace.Trace(span_s=10.0, busy_s=1.0, device=device)
    return run


WALKER = "void ffs_kernels::(anonymous namespace)::dispersion_walker<unsigned short, true>(...)"
DECODE = "void ffs_kernels::(anonymous namespace)::bitshuffle_frames_kernel<2>(...)"


@pytest.mark.parametrize("metric,run,want", [
    ("device_decode_pct", dict(counters={"frames_in": 400, "device_decode_frames": 392}), 98.0),
    ("device_decode_pct", dict(counters={"frames_in": 400}), None),  # a program without it
    ("device_decode_pct", dict(counters={"frames_in": 0, "device_decode_frames": 0}), None),
    ("batch_fill_ms_per_frame.live",
     dict(counters={}, spans={"ffs.batch_fill": {"n": 80, "frames": 80, "total_ms": 6000.0,
                                                 "p50_ms": 0.0, "p95_ms": 0.0}}), 75.0),
    ("batch_fill_ms_per_frame.live", dict(counters={}), None),
    ("dispersion_threshold_roofline_pct",
     dict(device=[("kernel", WALKER, 1.0e-3), ("kernel", WALKER, 3.0e-3),
                  ("kernel", DECODE, 9.0)]),
     100.0 * (8 * 4362 * 4148 * 2 + 4362 * 4148 + 8 * 4362 * 272 * 4) / 3.35e12 / 2.0e-3),
    ("frame_decode_roofline_pct", dict(device=[("kernel", DECODE, 0.25e-3), ("kernel", WALKER, 9.0)]),
     100.0 * 2 * 8 * 4362 * 4148 * 2 / 3.35e12 / 0.25e-3),
    ("dispersion_threshold_roofline_pct", dict(device=[("kernel", "extended_walker", 1.0)]), None),
    ("frame_decode_roofline_pct", dict(), None),  # an untraced run
])
def test_benchmark_readers_of_the_f32b8_cell(metric, run, want):
    from ffsbench.run import read_metric

    got = read_metric(metric, _record(**run))
    assert got == (None if want is None else pytest.approx(want))
