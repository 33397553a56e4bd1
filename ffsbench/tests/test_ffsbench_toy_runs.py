"""Whole harness runs on the CPU at toy sizes (``FFS_TORCH_DEVICE=cpu``),
in a copy of the checkout to which a configuration, two traffic mixes and a
per-layer metric are added as new files only, with their entries in the
copy's BENCHMARK.json: nothing of the harness is edited to run them.

They cover the SIGINT stop and the epilogue's table (catch-up), the open
loop (live), the batched stills path (the CLI's kernel-path hook runs the
kernels' plain versions on the CPU), the traced run (no device metric on the
CPU), and the comparison: each planted fault and each control comes out
not correct."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
TOY_METRIC = '''"""Lines the traced run read, a toy per-layer metric added as a file."""


def read(run):
    return float(run.frames)
'''


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", d)
    shutil.copytree(ROOT / "ffsbench", d / "ffsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (d / "ffs_tpu_torch").symlink_to(ROOT / "ffs_tpu_torch")
    cfg = json.loads((d / "ffsbench/configs/eiger16m-rotation-f64.json").read_text())
    cfg["detector"].update(height=300, width=280,
                           mask={"kind": "modules", "module": [140, 130], "gap": [20, 20],
                                 "grid": [2, 2]})
    cfg["geometry"]["beam_center_px"] = [140.0, 150.0]
    (d / "ffsbench/configs/toy-rotation.json").write_text(json.dumps(cfg))
    jf = json.loads((d / "ffsbench/configs/jungfrau1m-ssx-f32.json").read_text())
    jf["detector"].update(height=106, width=102)
    flags = jf["spotfinder"]["cli_flags"]
    flags[flags.index("--batch") + 1] = "4"
    (d / "ffsbench/configs/toy-stills.json").write_text(json.dumps(jf))
    rot = json.loads((d / "ffsbench/traffic/rotation300.catchup.json").read_text())
    rot.update(distinct_frames=6, warmup_frames=3, ahead_frames=40)
    rot["spots"]["count"] = 12
    (d / "ffsbench/traffic/toy-rot.json").write_text(json.dumps(rot))
    rot.update(arrival="live", rate_hz=6.0, ahead_frames=16)
    (d / "ffsbench/traffic/toy-live.json").write_text(json.dumps(rot))
    st = json.loads((d / "ffsbench/traffic/stills60.catchup.json").read_text())
    st.update(distinct_frames=8, warmup_frames=4, ahead_frames=40)
    st["spots"]["count"] = 40  # enough that bfloat16 moves some pixels
    (d / "ffsbench/traffic/toy-stills.json").write_text(json.dumps(st))
    (d / "ffsbench/metrics/toy_lines.py").write_text(TOY_METRIC)

    b = json.loads((d / "BENCHMARK.json").read_text())
    b["configs"] += [
        {"name": "toy-rotation", "source": "toy", "file": "ffsbench/configs/toy-rotation.json",
         "reduced": [], "why": "toy"},
        {"name": "toy-stills", "source": "toy", "file": "ffsbench/configs/toy-stills.json",
         "reduced": [], "why": "toy"}]
    b["workloads"] += [
        {"name": "toy.rot", "config": "toy-rotation", "traffic": "toy-rot", "chips": 1, "why": "t"},
        {"name": "toy.live", "config": "toy-rotation", "traffic": "toy-live", "chips": 1, "why": "t"},
        {"name": "toy.stills", "config": "toy-stills", "traffic": "toy-stills", "chips": 1,
         "why": "t"}]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    e2e["frames_per_s"]["workloads"] += ["toy.rot", "toy.stills"]
    e2e["frame_latency_p95_ms"]["workloads"] += ["toy.live"]
    b["per_layer"].append({"name": "toy_lines", "unit": "frames", "better": "higher",
                           "source": "host_clock", "layer": "pipe", "moves": "setup_s"})
    (d / "BENCHMARK.json").write_text(json.dumps(b))
    return d


def harness(d, cell, *extra, seconds="2", env=None):
    e = dict(os.environ, FFS_TORCH_DEVICE="cpu", **(env or {}))
    r = subprocess.run([sys.executable, "-m", "ffsbench.run", "--workload", cell, "--seed",
                        "2200000017", "--seconds", seconds, *extra], cwd=d, env=e,
                       capture_output=True, text=True, timeout=600)
    result = json.loads(r.stdout.strip().splitlines()[-1]) if r.returncode == 0 else None
    return r, result


def test_catchup_stops_on_sigint_and_checks_the_epilogue_table(checkout):
    r, res = harness(checkout, "toy.rot", seconds="4")
    assert r.returncode == 0, r.stderr[-3000:]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 3
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                             "memory_peak_bytes": 0}
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["checks"]["table_rows_diff"] == {"value": 0, "limit": 0}
    assert list(res)[-1] == "checks"
    assert "check table_dev:" in r.stderr.strip().splitlines()[-1]


def test_traced_run_on_the_cpu_writes_no_device_metric(checkout):
    r, res = harness(checkout, "toy.rot", "--trace", "1")
    assert r.returncode == 0, r.stderr[-3000:]
    assert set(res["metrics"]) == {"cli_imports_s", "toy_lines"}  # the added metric's file
    assert res["metrics"]["toy_lines"]["value"] >= res["attempted"]
    assert res["device"]["busy_s"] == 0 and res["breakdown"]["device_ops"] == []


def test_live_releases_on_schedule(checkout):
    r, res = harness(checkout, "toy.live", seconds="3")
    assert r.returncode == 0, r.stderr[-3000:]
    assert res["correct"] and set(res["metrics"]) == {"frame_latency_p95_ms", "setup_s"}
    assert "latency: 18 images" in r.stderr


def test_batched_stills_through_the_kernel_path(checkout):
    r, res = harness(checkout, "toy.stills", env={"FFS_TORCH_KERNEL_PATH": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert res["correct"] and res["checks"]["centers_dev"]["value"] == 0


@pytest.mark.parametrize("cell", ["toy.rot", "toy.stills"])
@pytest.mark.parametrize("fault", ["answer", "stale", "half_batch"])
def test_a_planted_fault_is_not_correct(checkout, cell, fault):
    r, res = harness(checkout, cell, env={"FFSBENCH_FAULT": fault, "FFS_TORCH_KERNEL_PATH": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert res["correct"] is False


def test_the_programs_f32_path_gives_the_f64_answer(checkout):
    r, res = harness(checkout, "toy.rot", "--control", "program")
    assert r.returncode == 0, r.stderr[-3000:]
    assert res["correct"] and all(v["value"] == 0 for v in res["checks"].values())


def test_a_configuration_without_a_program_control_refuses_one(checkout):
    r, res = harness(checkout, "toy.stills", "--control", "program")
    assert r.returncode != 0 and res is None
    assert "names no lower-precision path" in r.stderr


@pytest.mark.parametrize("cell", ["toy.rot", "toy.stills"])
def test_the_reference_one_step_below_is_not_correct(checkout, cell):
    r, res = harness(checkout, cell, "--control", "reference",
                     env={"FFS_TORCH_KERNEL_PATH": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert res["correct"] is False


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ffsbench", tmp_path / "ffsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_build", "_cache"))
    r, _ = harness(tmp_path, "eiger16m-rotation-f64.catchup")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_without_a_card_no_result():
    env = {k: v for k, v in os.environ.items() if k != "FFS_TORCH_DEVICE"}
    r = subprocess.run([sys.executable, "-c",
                        "import torch, sys; sys.exit(0 if torch.cuda.is_available() else 1)"],
                       env=env)
    if r.returncode == 0:
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "-m", "ffsbench.run", "--workload",
                        "eiger16m-rotation-f64.catchup", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
