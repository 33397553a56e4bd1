"""BENCHMARK.json against the benchmark's contract, and every file it names."""

from __future__ import annotations

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "ffsbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_command_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["ffsbench"] and (ROOT / "ffsbench").is_dir()
    assert MANIFEST["command"] == ["python3", "-m", "ffsbench.run"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configuration_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    assert entry["file"].startswith("ffsbench/configs/")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) <= set(config) and set(entry["reduced"]) <= set(config["reduced"])
    for key in ("detector", "geometry", "spotfinder", "checks", "limits", "assumed",
                "guarantees", "control"):
        assert key in config
    sf = config["spotfinder"]
    flags = sf["cli_flags"]
    precision = flags[flags.index("--precision") + 1] if "--precision" in flags else "f64"
    assert precision == sf["precision"]  # the CLI's precision is the reference's
    for group, names in {"pipe": ("lines_missing", "strong_px_diff", "spots_2d_diff"),
                         "centers": ("centers_count_diff", "centers_dev"),
                         "table": ("table_rows_diff", "table_dev")}.items():
        if group in config["checks"]:
            assert all(n in config["limits"] for n in names)
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["arrival"] in ("catchup", "live")
    assert traffic["source"] and traffic["spots"]["intensity"]["kind"] == "wilson_acentric"
    assert traffic["ahead_frames"] > 0 and traffic["warmup_frames"] > 0
    if traffic["arrival"] == "live":
        assert isinstance(traffic["rate_hz"], float) and traffic["rate_hz"] > 0
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    per = [m for m in MANIFEST["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(MANIFEST["workloads"])


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    assert (HERE / "metrics" / f"{metric['name']}.py").exists()
    assert set(metric.get("workloads", [])) <= cells
    if metric["name"] in e2e:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert 1 <= len(metric["layer"]) <= 200
        moved = e2e[metric["moves"]]
        mine = set(metric.get("workloads", cells))
        assert mine <= set(moved.get("workloads", cells))  # every cell reports what it moves


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


def test_checks_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
