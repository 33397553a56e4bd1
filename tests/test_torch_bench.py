"""The port's bench (``python -m ffs_tpu_torch.bench``) against the repo's
``bench.py`` and ``ffs_tpu`` on the CPU, at the smoke's sizes.

(a) the frames are ``bench._make_frames``'s for the same generator state;
(b) the full batch step equals JAX's composition of the same ops
    (``bench.py``'s step: Pallas in interpret mode, ``peak_key_slots``, x64
    off) bit for bit: pixel lists, counts, every spot-table column, keep;
(c) the ingest step (planes -> ``frames_from_planes`` -> step) equals the
    resident step on the decoded frames, and the perturbed planes equal
    ``bench.py``'s ``iplanes ^ ppat * d`` byte for byte;
(d) the integrator tool's and the SSX tool's inputs equal the JAX tools';
(e) the bench in a subprocess: no card and no smoke flags exits non-zero;
    the smoke exits 0 with the six names, and a stage that raises gives
    exit 1 with the other lines printed;
and the one anchor comparator (``check_anchor``) on the cases of
``tests/test_bench_anchors.py``: the golden passes, planted faults fail.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.models import geometry as jgeo
from ffs_tpu.ops import connected_components as jcc
from ffs_tpu.ops.compact import compact_from_pcw_segmented as jsegmented
from ffs_tpu.ops.dispersion_extended_pallas import dispersion_extended_packed_raw as jext
from ffs_tpu.ops.dispersion_pallas import dispersion_packed_raw as jdisp
from ffs_tpu_torch import bench as tbench
from ffs_tpu_torch.ops.bitshuffle_device import frames_from_planes
from ffs_tpu_torch.tools import bench_integrator as tint
from ffs_tpu_torch.tools import bench_ssx as tssx

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402

sys.path.insert(0, str(REPO / "tools"))

import ssx_adversarial as jadv  # noqa: E402

SMOKE = 256  # bench.py's smoke frames are 256 x 256
METRICS = (
    "eiger16m_spotfind_fps",
    "eiger16m_ingest_spotfind_fps",
    "jungfrau1m_extended_spotfind_fps",
    "kabsch_integrate_refl_per_s",
    "kabsch_integrate_effective_slices_per_s",
    "ssx_index_images_per_s",
)


def _smoke_batches(make):
    """bench.py's smoke draws in its order: the Eiger batch (B = 2, 20
    spots, no mask), then the Jungfrau batch (B = 2, 60 spots, gap band)."""
    rng = np.random.default_rng(12)
    eiger = make(rng, SMOKE, SMOKE, 2, np.ones((SMOKE, SMOKE), np.uint8), n_spots=20)
    jmask = np.ones((SMOKE, SMOKE), np.uint8)
    jmask[SMOKE // 2 : SMOKE // 2 + 42] = 0
    jf = make(rng, SMOKE, SMOKE, 2, jmask, n_spots=60)
    return eiger, jf, jmask


@pytest.fixture(scope="module")
def smoke_batches():
    return _smoke_batches(tbench.make_frames)


def test_make_frames_equals_bench(smoke_batches):
    want = _smoke_batches(bench._make_frames)
    for got, ref in zip(smoke_batches, want):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tbench.jungfrau_mask(SMOKE, SMOKE), want[2])


def _jax_step(batch, mask, kf, s, extended):
    """bench.py:289-317 on the CPU: interpret mode, x64 off."""
    with jax.enable_x64(False):
        b, m = jnp.asarray(batch), jnp.asarray(mask)
        if extended:
            pcw = jext(b, m, 65535.0, mbox=None, strip=128, interpret=True, trim=False)
        else:
            pcw = jdisp(b, m, 65535.0, mbox=None, trim=False, strip=128, interpret=True)
        hp, w = pcw.shape[1], b.shape[-1]
        p, nbu, nbd, counts = jsegmented(b, pcw, max_pixels_per_frame=kf, with_neighbors=True)
        root = jcc.label_compact_pixels(p, width=w, neighbors=(nbu, nbd))
        t = jcc.spot_table_from_pixels(p, root, width=w, max_spots=s, dtype=jnp.float32,
                                       frame_rows=hp, peak_key_slots=kf)
        keep, _, _ = jcc.filter_spots(t, 3, 2.0)
        return jax.device_get((p, t, keep, counts)), hp


def _assert_steps_equal(got, want):
    (gp, gt, gkeep, _, gcounts), ((wp, wt, wkeep, wcounts), _) = got, want
    for name in ("linear_index", "intensity", "count"):
        np.testing.assert_array_equal(getattr(gp, name).numpy(), np.asarray(getattr(wp, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(gcounts.numpy(), np.asarray(wcounts))
    for name in jcc.SpotTable._fields:
        g, w = getattr(gt, name).numpy(), np.asarray(getattr(wt, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(gkeep.numpy(), np.asarray(wkeep))


@pytest.mark.parametrize("stage", ["eiger", "jungfrau"])
def test_full_step_equals_jax(stage, smoke_batches):
    """At 256 x 256 and B = 2 with the smoke's capacities: Eiger 1024 slots a
    frame (2048 / B), 1024 spots, dispersion; Jungfrau 640 and 8192,
    extended."""
    eiger, jf, jmask = smoke_batches
    if stage == "eiger":
        frames, mask, kf, s, extended = eiger, np.ones((SMOKE, SMOKE), np.uint8), 1024, 1024, False
    else:
        frames, mask, kf, s, extended = jf, jmask, 640, 8192, True
    want = _jax_step(frames, mask, kf, s, extended)
    got = tbench.full_step(torch.from_numpy(frames), torch.from_numpy(mask), kf, s, extended)
    assert got[3] == want[1] == SMOKE  # the same tall pitch
    assert int(got[0].count) > 0 and int(got[1].n_spots) > 0
    _assert_steps_equal(got, want)


def test_ingest_step_equals_resident(smoke_batches):
    eiger = smoke_batches[0]
    planes = tbench.to_planes(eiger)
    mask = torch.ones((SMOKE, SMOKE), dtype=torch.uint8)
    decoded = frames_from_planes(torch.from_numpy(planes), SMOKE, SMOKE, torch.uint16)
    np.testing.assert_array_equal(decoded.numpy(), eiger)
    got = tbench.full_step(decoded, mask, 1024, 1024)
    want = tbench.full_step(torch.from_numpy(eiger), mask, 1024, 1024)
    for g, w in zip((*got[0], *got[1], got[2], got[4]), (*want[0], *want[1], want[2], want[4])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # bench.py's perturbation on (B, n_blocks, block_bytes / 4) u32 words
    words = planes.reshape(len(planes), planes.shape[1], -1).view(np.uint32)
    ppat = np.zeros((1, 1, words.shape[-1]), np.uint32)
    ppat[..., : min(128, words.shape[-1])] = 1
    for d in range(4):
        want_bytes = (words ^ ppat * np.uint32(d)).view(np.uint8).reshape(planes.shape)
        np.testing.assert_array_equal(tbench.flip_planes(planes, d), want_bytes)
    # the flipped planes decode to frames that differ only in low bits
    flipped = frames_from_planes(torch.from_numpy(tbench.flip_planes(planes, 3)), SMOKE, SMOKE,
                                 torch.uint16).numpy()
    assert 0 < np.count_nonzero(flipped != eiger) and np.all((flipped ^ eiger) <= 3)


def test_integrator_setup_equals_jax_tool():
    """tools/bench_integrator.py:40-76 at A = 64: panel, s1, phi, bboxes and
    the block's frames from the same generator."""
    a, h, w = 64, 2164, 2068
    rng = np.random.default_rng(3)
    panel = jgeo.simple_panel(0.2 * 1000, (w / 2, h / 2), (0.075, 0.075), (w, h))
    beam = jgeo.MonochromaticBeam(wavelength=0.976)
    x, y = rng.uniform(50, w - 50, a), rng.uniform(50, h - 50, a)
    lab = panel.get_lab_coord(*panel.px_to_mm(x, y))
    s1 = lab / np.linalg.norm(lab, axis=1, keepdims=True) / beam.wavelength
    phi = np.deg2rad(rng.uniform(0, 1, a))
    bboxes = np.stack([np.clip(x - 10, 0, w - 1), np.clip(x + 10, 0, w - 1),
                       np.clip(y - 10, 0, h - 1), np.clip(y + 10, 0, h - 1),
                       np.zeros(a), np.full(a, 4)], axis=1).astype(np.int64)
    image = rng.poisson(4.0, size=(4, h, w)).astype(np.uint16)

    trng = np.random.default_rng(3)
    got = tint.setup(a, trng)
    for name in ("fast_axis", "slow_axis", "origin", "pixel_size", "image_size"):
        np.testing.assert_array_equal(getattr(got.panel, name), getattr(panel, name), err_msg=name)
    np.testing.assert_array_equal(got.beam.s0, beam.s0)
    np.testing.assert_array_equal(got.s1, s1)
    np.testing.assert_array_equal(got.phi, phi)
    np.testing.assert_array_equal(got.bboxes, bboxes)
    np.testing.assert_array_equal(tint.block_frames(trng), image)


def test_ssx_stills_equal_jax_tool():
    images, panel, wavelength = tssx.stills(4)
    for seed, got in enumerate(images):
        crystal, jpanel, jwl, s0, rng = jadv.make_experiment(seed + 1)
        want = np.concatenate([jadv.lattice_spots(crystal, jpanel, s0, rng),
                               jadv.noise_spots(rng, 10)])
        np.testing.assert_array_equal(got, want)
    assert wavelength == jwl
    np.testing.assert_array_equal(panel.origin, jpanel.origin)


# --- the bench in a subprocess ---------------------------------------------------


def _bench_env(**extra):
    # one OpenMP thread: the smoke's toy shapes gain nothing from more, and
    # with the suite's other workers on every core a team of threads waits
    # at each op's barrier (the smoke took ~25x its time alone)
    env = {k: v for k, v in os.environ.items() if not k.startswith("FFS_")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    return env


def _run(args, env):
    r = subprocess.run(args, capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    return r, lines


@pytest.mark.parametrize("extra", [{}, {"FFS_TORCH_DEVICE": "cpu"}, {"FFS_BENCH_SMOKE": "1"}])
def test_bench_without_a_card_exits_nonzero(extra):
    r, lines = _run([sys.executable, "-m", "ffs_tpu_torch.bench"], _bench_env(**extra))
    assert r.returncode != 0
    assert not any("metric" in x for x in lines)
    assert "no CUDA card" in r.stderr or "runs only the smoke" in r.stderr


SMOKE_ENV = {"FFS_BENCH_SMOKE": "1", "FFS_TORCH_DEVICE": "cpu"}


def test_bench_smoke_on_cpu():
    r, lines = _run([sys.executable, "-m", "ffs_tpu_torch.bench"], _bench_env(**SMOKE_ENV))
    assert r.returncode == 0, r.stderr
    metrics = [x for x in lines if "metric" in x]
    assert [x["metric"] for x in metrics] == [*METRICS, METRICS[0]]
    assert all(x["smoke"] is True and x["device"] == "cpu" for x in lines)
    assert all(x["value"] > 0 and x["vs_baseline"] > 0 for x in metrics)
    assert lines[-1] == metrics[0]  # the last line re-emits the Eiger metric
    assert "bench" in lines[0] and lines[0]["reps"]["FFS_BENCH_REPS"] == 2
    stages = [x["stage"] for x in lines if "launches" in x]
    assert stages == list(METRICS)  # a launch line before every metric
    fold = next(x["fold_s"] for x in lines if "fold_s" in x)
    assert fold["total"] == pytest.approx(sum(v for k, v in fold.items()
                                              if k not in ("total", "acquisition", "predict_api")))
    assert fold["predict"] > 0 and fold["predict_api"] > 0


# a stage's isolation, not the stages themselves: every other stage is a stub
# that prints its launches and metric lines as the real one does
STUB_STAGES = """
import sys
import ffs_tpu_torch.bench as b
from ffs_tpu_torch.tools import bench_integrator, bench_ssx

def stub(*metrics):
    def stage(run, *frames):
        for metric in metrics:
            fields = run.emit(metric, 1.0, "stub", 1.0, since=run.counts())
            if metric == "eiger16m_spotfind_fps":
                run.eiger_line = fields
    return stage

def boom(run, frames):
    raise RuntimeError("planted ingest failure")

b.stage_eiger = stub("eiger16m_spotfind_fps")
b.stage_ingest = boom
b.stage_jungfrau = stub("jungfrau1m_extended_spotfind_fps")
bench_integrator.run_stage = stub("kabsch_integrate_refl_per_s",
                                  "kabsch_integrate_effective_slices_per_s")
bench_ssx.run_stage = stub("ssx_index_images_per_s")
sys.exit(b.main())
"""


def test_bench_stage_that_raises_exits_1_and_the_rest_still_print():
    code = STUB_STAGES
    r, lines = _run([sys.executable, "-c", code], _bench_env(**SMOKE_ENV))
    assert r.returncode == 1
    assert "planted ingest failure" in r.stderr and "ingest stage FAILED" in r.stderr
    names = [x["metric"] for x in lines if "metric" in x]
    assert names == [m for m in (*METRICS, METRICS[0]) if m != "eiger16m_ingest_spotfind_fps"]
    assert lines[-1]["metric"] == METRICS[0]
    stages = [x["stage"] for x in lines if "launches" in x]
    assert stages == [m for m in METRICS if m != "eiger16m_ingest_spotfind_fps"]


# --- the anchor comparator ----------------------------------------------------------

W, PITCH = 4148, 4369


@pytest.fixture(scope="module")
def golden():
    return tbench.load_anchor_golden()


class _DeviceTable:
    """A multi-frame SpotTable stand-in: the golden's rows of one frame,
    then 64 invalid rows (tests/test_bench_anchors.py's)."""

    def __init__(self, golden, tag, frame):
        n = len(golden[f"{tag}_n_pixels"])
        slots = n + 64
        self.valid = np.zeros(slots, bool)
        self.valid[:n] = True
        self.z_min = np.full(slots, frame, np.int32)
        self.com_z = np.full(slots, frame + 0.5, np.float32)
        for col in ("n_pixels", "sum_intensity", "com_x", "com_y", "x_min", "x_max", "y_min",
                    "y_max", "peak_x", "peak_y"):
            g = golden[f"{tag}_{col}"]
            a = np.zeros(slots, g.dtype if g.dtype != np.float64 else np.float32)
            a[:n] = g.astype(a.dtype)
            setattr(self, col, a)


class _HostTable:
    """A ``cc2d`` table stand-in: one frame's rows, ``peak_intensity``."""

    def __init__(self, golden, tag):
        self.n_spots = len(golden[f"{tag}_n_pixels"])
        for col in ("n_pixels", "sum_intensity", "com_x", "com_y", "x_min", "x_max", "y_min",
                    "y_max", "peak_x", "peak_y", "peak_intensity"):
            setattr(self, col, golden[f"{tag}_{col}"].copy())


def _case(golden, tag, frame, kind):
    """(lin, inten, table, frame, pitch): tall indices for the device
    table, single-frame ones for the host table."""
    pitch = PITCH if kind == "device" else 0
    frame = frame if kind == "device" else 0
    y, x = golden[f"{tag}_y"].astype(np.int64), golden[f"{tag}_x"].astype(np.int64)
    lin = (y + frame * pitch) * W + x
    table = _DeviceTable(golden, tag, frame) if kind == "device" else _HostTable(golden, tag)
    return lin, golden[f"{tag}_intensity"].astype(np.int32), table, frame, pitch


@pytest.mark.parametrize("kind", ["device", "host"])
@pytest.mark.parametrize("tag,frame", [("img2", 0), ("img5", 1)])
def test_check_anchor_passes_on_golden(golden, tag, frame, kind):
    lin, inten, table, frame, pitch = _case(golden, tag, frame, kind)
    assert tbench.check_anchor(golden, tag, W, lin, inten, table, frame=frame, pitch=pitch) == []
    if kind == "device":  # bench.py's comparator agrees
        assert bench._check_anchor_bitparity(golden, tag, W, pitch, frame, lin, inten, table) == []


def _plant(fault, lin, inten, table):
    if fault == "pixel":
        inten = inten.copy()
        inten[1234 % len(inten)] ^= 1  # a one-bit intensity fault
    elif fault == "coordinate":
        lin = lin.copy()
        lin[77] += 1
    elif fault == "table":  # one dropped product in one spot's sum, counts right
        table.sum_intensity = table.sum_intensity.copy()
        table.sum_intensity[5] += 1.0
    elif fault == "count":
        lin, inten = lin[:-1], inten[:-1]
    elif fault == "peak":
        if hasattr(table, "peak_intensity"):
            table.peak_intensity = table.peak_intensity.copy()
            table.peak_intensity[3] += 1
        else:  # the device table reads the peak from the pixel list
            table.peak_x = table.peak_x.copy()
            table.peak_x[3] += 1
    return lin, inten, table


@pytest.mark.parametrize("kind", ["device", "host"])
@pytest.mark.parametrize("fault,tag,frame,message", [
    ("pixel", "img2", 0, "intensities differ"),
    ("coordinate", "img2", 0, "coordinate list differs"),
    ("table", "img5", 1, "sum_intensity differs"),
    ("count", "img2", 0, "pixel count"),
    ("peak", "img5", 1, "peak_intensity differs"),
])
def test_check_anchor_fails_on_planted_fault(golden, fault, tag, frame, message, kind):
    lin, inten, table, frame, pitch = _case(golden, tag, frame, kind)
    lin, inten, table = _plant(fault, lin, inten, table)
    errs = tbench.check_anchor(golden, tag, W, lin, inten, table, frame=frame, pitch=pitch)
    assert any(message in e for e in errs), errs
