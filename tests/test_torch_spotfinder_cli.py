"""The PyTorch spotfinder CLI against the JAX one on the same synthetic
NeXus files: identical pipe JSON lines, count log lines and results_ffs.h5;
the exit-32 protocol, --list-devices, the --batch notice, device selection,
and that the port runs with JAX blocked from import.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from .util import synthetic_rotation_stack, write_nexus

REPO = pathlib.Path(__file__).resolve().parent.parent
COUNT_LINE = re.compile(
    r"^(Thread .*finished image.*|Extracted \d+ spots|Removed \d+ spots.*|"
    r"Calculated \d+ spots|Filtered \d+ spots.*|Found \d+ spots|Estimated sigma.*|"
    r"Successfully wrote.*|Dataset type:.*|Image: .*)$"
)


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["FFS_TORCH_DEVICE"] = "cpu"
    return env


def _run(cmd, cwd, pipe=False):
    if not pipe:
        return subprocess.run(cmd, capture_output=True, cwd=cwd, env=_env(), timeout=600), None
    r, w = os.pipe()
    os.set_inheritable(w, True)
    proc = subprocess.run(
        cmd + ["--pipe_fd", str(w)], capture_output=True, cwd=cwd, env=_env(),
        pass_fds=(w,), timeout=600,
    )
    os.close(w)
    with os.fdopen(r) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    return proc, lines


def _cli(package, args, cwd, pipe=False):
    return _run([sys.executable, "-m", f"{package}.pipeline.spotfinder", *args], cwd, pipe)


def _h5(path):
    import h5py

    with h5py.File(path) as f:
        g = f["dials/processing/group_0"]
        return {k: g[k][()] for k in g}, list(g.attrs["experiment_ids"])


def _count_lines(log: str) -> list[str]:
    return [ln for ln in log.splitlines() if COUNT_LINE.match(ln)]


@pytest.fixture(scope="module")
def rotation_nexus(tmp_path_factory):
    d = tmp_path_factory.mktemp("nxs")
    stack, mask = synthetic_rotation_stack()
    path = d / "rot.nxs"
    write_nexus(path, stack, oscillation=(0.0, 0.1), mask=mask)
    return path


@pytest.mark.parametrize(
    "kind,args",
    [
        ("rotation-f64", ["--threads", "2", "--save-h5"]),
        ("rotation-f32", ["--precision", "f32", "--save-h5", "--algorithm", "dispersion_extended"]),
        ("still-f64", ["--save-h5", "--min-spot-size", "1", "--output-for-index"]),
    ],
)
def test_cli_matches_jax(rotation_nexus, tmp_path, kind, args):
    if kind.startswith("still"):
        stack, mask = synthetic_rotation_stack(nimg=3)
        path = tmp_path / "still.nxs"
        write_nexus(path, stack, oscillation=None, mask=mask)
    else:
        path = rotation_nexus
    out = {}
    for package in ("ffs_tpu", "ffs_tpu_torch"):
        cwd = tmp_path / package
        cwd.mkdir()
        proc, lines = _cli(package, [str(path), *args], cwd, pipe=True)
        log = proc.stdout.decode()
        assert proc.returncode == 0, log + proc.stderr.decode()
        out[package] = (lines, _count_lines(log), _h5(cwd / "results_ffs.h5"), log)
    j_lines, j_counts, (j_h5, j_ids), _ = out["ffs_tpu"]
    t_lines, t_counts, (t_h5, t_ids), t_log = out["ffs_tpu_torch"]
    assert "Device: cpu" in t_log
    assert t_lines == j_lines and len(j_lines) > 0
    assert t_counts == j_counts
    assert any("finished image" in ln for ln in j_counts)
    assert t_ids == j_ids and sorted(t_h5) == sorted(j_h5)
    for name, want in j_h5.items():
        np.testing.assert_array_equal(t_h5[name], want, err_msg=name)
    assert len(j_h5["xyzobs.px.value"]) > 0


def test_bit_depth_renegotiation(tmp_path):
    stack = np.zeros((2, 32, 48), dtype=np.uint32)
    path = tmp_path / "u32.nxs"
    write_nexus(path, stack)
    code = (
        "import sys; from ffs_tpu_torch.pipeline.spotfinder import {fn}; "
        "sys.argv = ['spotfinder', {path!r}]; {fn}()"
    )
    proc, _ = _run([sys.executable, "-c", code.format(fn="main", path=str(path))], tmp_path)
    assert proc.returncode == 32, proc.stdout.decode() + proc.stderr.decode()
    assert "only accepts 16 bit != 32" in proc.stdout.decode()
    proc, _ = _run([sys.executable, "-c", code.format(fn="main32", path=str(path))], tmp_path)
    assert proc.returncode == 0, proc.stdout.decode() + proc.stderr.decode()


def test_list_devices_and_batch_notice(rotation_nexus, tmp_path):
    proc, _ = _cli("ffs_tpu_torch", ["--list-devices"], tmp_path)
    assert proc.returncode == 0, proc.stdout.decode() + proc.stderr.decode()
    proc, lines = _cli(
        "ffs_tpu_torch", [str(rotation_nexus), "--batch", "2", "--decode-backend", "device"],
        tmp_path, pipe=True,
    )
    log = proc.stdout.decode()
    assert proc.returncode == 0, log + proc.stderr.decode()
    assert "Batched mode unavailable" in log and "falling back to per-frame" in log
    assert "Device decode unavailable" in log
    assert len(lines) == 6


def test_device_selection(monkeypatch):
    import torch

    from ffs_tpu_torch.utils import torchinit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    assert torchinit.select_device(0) == torch.device("cpu")
    monkeypatch.delenv("FFS_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cpu"):
        torchinit.select_device(0)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError):
        torchinit.select_device(0)
    assert torchinit.list_devices() == []


# the framework-free ffs_tpu modules the port imports instead of copying
SHARED = [
    "ffs_tpu", "ffs_tpu.constants", "ffs_tpu.io.cbf", "ffs_tpu.io.compression",
    "ffs_tpu.io.modules", "ffs_tpu.io.nexus", "ffs_tpu.io.sample_data", "ffs_tpu.io.shm",
    "ffs_tpu.models", "ffs_tpu.models.crystal", "ffs_tpu.models.experiment",
    "ffs_tpu.models.geometry", "ffs_tpu.models.reflection_table", "ffs_tpu.models.symmetry",
    "ffs_tpu.ops.cc3d", "ffs_tpu.ops.cc2d_host", "ffs_tpu.ops.compact_host",
    "ffs_tpu.ops.reference", "ffs_tpu.utils.native", "ffs_tpu.utils.cli",
    "ffs_tpu.utils.logging", "ffs_tpu.utils.writeout",
]


def test_port_runs_with_jax_blocked(rotation_nexus, tmp_path):
    """The port and the ffs_tpu modules it shares work without JAX."""
    code = (
        "import importlib, sys; sys.modules['jax'] = None\n"
        f"[importlib.import_module(m) for m in {SHARED!r}]\n"
        "import ffs_tpu_torch.spotfind, ffs_tpu_torch.utils.cuda_build\n"
        "from ffs_tpu_torch.pipeline.spotfinder import run\n"
        f"sys.exit(run([{str(rotation_nexus)!r}, '--images', '2']))\n"
    )
    proc, _ = _run([sys.executable, "-c", code], tmp_path)
    assert proc.returncode == 0, proc.stdout.decode() + proc.stderr.decode()
    assert proc.stdout.decode().count("finished image") == 2
    sources = list((REPO / "ffs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for src in sources:
        text = src.read_text()
        assert not re.search(r"^\s*(import jax|from jax)", text, re.M), src
