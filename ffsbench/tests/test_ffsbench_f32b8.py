"""The cell ``eiger16m-rotation-f32b8.live``: the batched float32 path with
device decode, live.

On the CPU, a whole harness run of the cell at a toy size, in a copy of the
checkout whose configuration and traffic files are cut down in place (the
CLI's kernel-path hook runs the kernels' plain versions): correct, every
frame decoded from its bit planes, and each new per-layer metric read or
left out as the run allows.  On the card (marked ``gpu``), the control at
the cell's own size: the reference with a bfloat16 threshold in the
program's place comes out not correct on each control seed.

    python -m pytest ffsbench/tests/test_ffsbench_f32b8.py -m gpu -q -p no:cacheprovider -s
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from ffsbench.tests import test_ffsbench_reference as reference_tests

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "eiger16m-rotation-f32b8.live"
CONFIG = "ffsbench/configs/eiger16m-rotation-f32b8.json"
TRAFFIC = "ffsbench/traffic/rotation300.live-b8.json"
SEEDS = (2200000401, 2200000402, 2200000403)
NEW_METRICS = {"batch_fill_ms_per_frame.live", "device_decode_pct",
               "dispersion_threshold_roofline_pct", "frame_decode_roofline_pct"}


def test_the_control_lowers_the_threshold_one_step():
    reference_tests.test_each_control_lowers_one_stage_by_one_step("eiger16m-rotation-f32b8")


def test_the_cell_runs_the_batched_f32_path_with_device_decode():
    cfg = json.loads((ROOT / CONFIG).read_text())
    flags = cfg["spotfinder"]["cli_flags"]
    assert flags[flags.index("--batch") + 1] == "8"
    assert flags[flags.index("--decode-backend") + 1] == "device"
    det = cfg["detector"]
    assert (det["height"] * det["width"]) % 8 == 0  # whole bitshuffle groups: planes, no raw tail
    traffic = json.loads((ROOT / TRAFFIC).read_text())
    assert traffic["arrival"] == "live" and traffic["warmup_frames"] % 8 == 0


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", d)
    shutil.copytree(ROOT / "ffsbench", d / "ffsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (d / "ffs_tpu_torch").symlink_to(ROOT / "ffs_tpu_torch")
    cfg = json.loads((d / CONFIG).read_text())
    cfg["detector"].update(height=300, width=280,
                           mask={"kind": "modules", "module": [140, 130], "gap": [20, 20],
                                 "grid": [2, 2]})
    cfg["geometry"]["beam_center_px"] = [140.0, 150.0]
    (d / CONFIG).write_text(json.dumps(cfg))
    traffic = json.loads((d / TRAFFIC).read_text())
    traffic.update(distinct_frames=6, rate_hz=8.0)
    traffic["spots"]["count"] = 12
    (d / TRAFFIC).write_text(json.dumps(traffic))
    return d


def harness(d, *extra, seconds="3"):
    env = dict(os.environ, FFS_TORCH_DEVICE="cpu", FFS_TORCH_KERNEL_PATH="1")
    r = subprocess.run([sys.executable, "-m", "ffsbench.run", "--workload", CELL, "--seed",
                        "2200000023", "--seconds", seconds, *extra], cwd=d, env=env,
                       capture_output=True, text=True, timeout=600)
    result = json.loads(r.stdout.strip().splitlines()[-1]) if r.returncode == 0 else None
    return r, result


@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_toy_run_is_correct_and_decodes_every_frame_on_the_device(checkout, trace):
    r, res = harness(checkout, "--trace", trace)
    assert r.returncode == 0, r.stderr[-3000:]
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert "latency: 24 images" in r.stderr
    if trace == "0":
        assert set(res["metrics"]) == {"frame_latency_p95_ms", "setup_s"}
        return
    # the rooflines read the device trace, which a CPU run has not
    assert set(res["metrics"]) & NEW_METRICS == {"batch_fill_ms_per_frame.live",
                                                 "device_decode_pct"}
    assert res["metrics"]["device_decode_pct"]["value"] == 100.0
    assert res["metrics"]["batch_fill_ms_per_frame.live"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_with_a_bf16_threshold_fails(card, seed):
    r = subprocess.run([sys.executable, "-m", "ffsbench.run", "--workload", CELL, "--seed",
                        str(seed), "--seconds", "5", "--control", "reference"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    print(CELL, seed, {k: v["value"] for k, v in res["checks"].items()})
    assert res["correct"] is False
