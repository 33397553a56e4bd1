"""ffs_tpu_torch.tools.bench_collection on the CPU, at a small frame.

The collection's shape and mask are cut to 128 x 160 (a gap band and a gap
column); the CLI runs in subprocesses under ``FFS_TORCH_DEVICE=cpu``, the
f32 modes through its ``FFS_TORCH_KERNEL_PATH=1`` hook.  ``main`` must print
the three metric lines, agree between host and device decode, and print
the stage split with the f64 fused stage and the upload share; without the
hook the f32 modes fall back and ``main`` exits 1.  The ``--cli`` entry
writes the table to ``.npz`` where h5py is missing; the trace summary
merges overlapping device events.
"""

import json
import sys

import numpy as np
import pytest

from ffs_tpu_torch.models.reflection_table import ReflectionTable
from ffs_tpu_torch.tools import bench_collection as bc

FUSED = "kernel+compact+post (fused device step)"


def _small_mask():
    mask = np.ones(bc.SHAPE, np.uint8)
    mask[60:64, :] = 0
    mask[:, 80:83] = 0
    return mask


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(bc, "SHAPE", (128, 160))
    monkeypatch.setattr(bc, "collection_mask", _small_mask)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_COLL_FRAMES", "4")
    monkeypatch.delenv("FFS_COLL_MODES", raising=False)
    monkeypatch.delenv("FFS_COLL_BATCH", raising=False)


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_main_runs_every_mode(small, monkeypatch, capsys):
    monkeypatch.setenv("FFS_TORCH_KERNEL_PATH", "1")
    assert bc.main([]) == 0
    lines = _json_lines(capsys.readouterr().out)
    metrics = {x["metric"]: x for x in lines if "metric" in x}
    assert [x["metric"] for x in lines if "metric" in x][:3] == list(bc.METRICS.values())
    for mode, name in bc.METRICS.items():
        x = metrics[name]
        assert x["frames"] == 4 and x["value"] > 0 and x["wall_s"] > 0 and x["gbps"] >= 0
        assert x["device"] == "host CPU" and x["table"] == "hdf5"
        assert x["spots"] > 0 and x["strong_pixels"] > 0
        assert x["batch"] == (1 if mode == "f64" else 8)
        assert set(x["launches"]) == {"dispersion_packed", "dispersion_extended_packed",
                                      "dispersion_packed_f64", "window_gather_planes",
                                      "window_gather", "bitshuffle_frames"}
    assert {"check": "host_vs_device_decode", "ok": True,
            "spots": metrics[bc.METRICS["host"]]["spots"], "images": 4} in lines
    busy = metrics["collection_device_busy"]
    assert busy["mode"] == "device" and busy["span_ms"] > 0
    assert busy["busy_share"] is None and busy["device_busy_ms"] == 0  # no device events here
    split = metrics["collection_stage_split_ms_mean"]
    assert {"upload", FUSED, "collect", "total"} <= set(split["f64"])
    assert {"upload", "kernel", "compact", "post", "total"} <= set(split["f32"])
    assert split["decode_host_ms"] > 0 and split["decode_lz4_only_ms"] > 0
    assert split["frames"] == 3
    share = metrics["collection_upload_share"]
    for prec in ("f64", "f32"):
        assert 0 <= share[prec] <= 1
        assert share["upload_ms"][prec] == split[prec]["upload"]


def test_fallback_exits_1(small, monkeypatch, capsys):
    monkeypatch.delenv("FFS_TORCH_KERNEL_PATH", raising=False)
    assert bc.main([]) == 1
    out, err = capsys.readouterr()
    assert "fell back" in err and "Batched mode unavailable" in err
    names = [x["metric"] for x in _json_lines(out) if "metric" in x]
    assert names == [bc.METRICS["f64"]]  # the f64 line, then the failure


def test_tables_differ_finds_one_bit():
    a = {"xyzobs.px.value": np.arange(12, dtype=np.float64).reshape(4, 3),
         "id": np.zeros(4, np.int64)}
    assert bc.tables_differ(a, {k: v.copy() for k, v in a.items()}) == []
    b = {k: v.copy() for k, v in a.items()}
    b["xyzobs.px.value"][2, 1] = np.nextafter(b["xyzobs.px.value"][2, 1], 1e9)
    assert bc.tables_differ(a, b) == ["xyzobs.px.value"]
    assert bc.tables_differ(a, {"id": a["id"]})


def test_trace_summary_merges_overlapping_device_events(tmp_path):
    events = [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 5.0, "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "walker", "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "scan", "ts": 150.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400.0, "dur": 200.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = bc.trace_summary(path)
    assert got["span_ms"] == 1.0
    assert got["device_busy_ms"] == pytest.approx(0.35)  # 100-250 and 400-600 us
    assert got["busy_share"] == pytest.approx(0.35)
    assert got["device_ms"] == pytest.approx({"kernel": 0.2, "gpu_memcpy": 0.2})
    assert [t["name"] for t in got["top"]] == ["Memcpy HtoD", "walker", "scan"]


def test_unknown_mode_fails_before_the_build(small, monkeypatch):
    monkeypatch.setenv("FFS_COLL_MODES", "f64,f16")
    with pytest.raises(ValueError, match="unknown mode"):
        bc.main([])


def test_cli_entry_writes_npz_without_h5py(small, tmp_path, monkeypatch, capsys):
    src = tmp_path / "shm"
    src.mkdir()
    bc.build_collection(src, 2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ReflectionTable, "write", ReflectionTable.write)  # restored after
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    rc = bc.main(["--cli", str(src), "--wavelength", "0.976", "--min-spot-size", "1",
                  "--save-h5", "--images", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert bc.launches(out)["dispersion_packed"] == 0  # the CPU runs the plain versions
    assert not (tmp_path / bc.TABLE).exists()
    table, how = bc.read_table(tmp_path)
    assert how.startswith("npz")
    assert {"xyzobs.px.value", "sigma_b_variance", "sigma_m_variance", "spot_extent_z",
            "id"} <= set(table)
    assert len(table["id"]) > 0
    assert len(bc.image_counts(out)) == 2
