"""The PyTorch integrator CLI against the JAX package's integrator steps.

The port's core (:func:`ffs_tpu_torch.pipeline.integrator.
integrate_experiment`) and the JAX functions called in the sequence of the
JAX CLI (``ffs_tpu/pipeline/integrator.py`` run()) integrate the same
synthetic collection (the ``integration_experiment`` of
tests/test_integration.py: a 240x260 panel, 12 images); every column of
``integrated.refl`` must agree, integers exactly and floats within 1e-12
relative.  ``--bg-device`` runs against the JAX CLI's device functions
(bounding boxes, background, finalisation) in the same sequence.  The CLI
wrapper and device selection are checked on top.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from ffs_tpu.integration import background as bg_mod
from ffs_tpu.integration import background_jax as bg_jax
from ffs_tpu.integration import extent as extent_mod
from ffs_tpu.integration import finalize as fin_mod
from ffs_tpu.integration import kabsch as kabsch_mod
from ffs_tpu.models.crystal import Crystal
from ffs_tpu.models.experiment import Experiment
from ffs_tpu.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel
from ffs_tpu.models.reflection_table import INTEGRATED_SUM, PREDICTED
from ffs_tpu.prediction.rotation import predict_rotation
from ffs_tpu_torch.models.experiment import experiment_from_state
from ffs_tpu_torch.pipeline import integrator as tint

from .test_integration import _SyntheticReader

SIGMA_B, SIGMA_M = np.deg2rad(0.08), np.deg2rad(0.4)


@pytest.fixture(scope="module")
def collection():
    expt = Experiment(
        beam=MonochromaticBeam(wavelength=1.0),
        panel=simple_panel(120.0, (120.0, 130.0), (0.3, 0.3), (240, 260)),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, 12), oscillation=(0.0, 1.0)),
        crystal=Crystal([40.0, 0, 0], [0, 50.0, 0], [0, 0, 60.0]),
    )
    pred = predict_rotation(expt, dmin=4.0)
    x, y, z = pred.xyzcal_px.T
    keep = (x > 20) & (x < 220) & (y > 20) & (y < 240) & (z > 1.5) & (z < 10.5)
    P = types.SimpleNamespace(
        hkl=pred.hkl[keep], s1=pred.s1[keep], xyzcal_px=pred.xyzcal_px[keep],
        xyzcal_mm=pred.xyzcal_mm[keep],
    )
    reader = _SyntheticReader(expt, P, seed=1)
    reader._mask[60:70, :] = 0  # a module gap across some shoeboxes
    table = {
        "miller_index": P.hkl.astype(np.int32),
        "s1": P.s1,
        "xyzcal.mm": P.xyzcal_mm,
        "flags": np.full(len(P.hkl), PREDICTED, dtype=np.uint64),
        "id": np.zeros(len(P.hkl), dtype=np.int64),
    }
    parts = ("beam", "panel", "goniometer", "scan", "crystal")
    texpt = experiment_from_state({k: dataclasses.asdict(getattr(expt, k)) for k in parts})
    return types.SimpleNamespace(expt=expt, texpt=texpt, reader=reader, table=table, P=P)


def jax_accumulate(expt, table, reader, algorithm, bg_device=False):
    """The JAX CLI's steps after loading, with its functions, in its order
    (``ffs_tpu/pipeline/integrator.py``: predict, bboxes, min_zeta, clip,
    KabschIntegrator), predicting with its default blocked search;
    ``bg_device`` takes the CLI's ``--bg-device`` bounding boxes."""
    flags = table.get("flags")
    if flags is not None and ((flags & PREDICTED) != 0).any():
        s1, xyzcal_mm, hkl = table["s1"], table["xyzcal.mm"], table["miller_index"]
        ids = table["id"]
    else:
        pred = predict_rotation(expt)
        s1, xyzcal_mm, hkl = pred.s1, pred.xyzcal_mm, pred.hkl
        ids = np.zeros(len(s1), np.int64)
    phi = xyzcal_mm[:, 2]
    n = len(s1)
    bbox_fn = (extent_mod.compute_kabsch_bounding_boxes_device if bg_device
               else extent_mod.compute_kabsch_bounding_boxes)
    bboxes = bbox_fn(
        expt.beam.s0, expt.goniometer.rotation_axis, s1, phi, SIGMA_B, SIGMA_M, expt.panel,
        expt.scan,
    )
    axis = expt.goniometer.rotation_axis
    cs = extent_mod.coordinate_systems(expt.beam.s0, axis / np.linalg.norm(axis), s1)
    sel = np.abs(cs.zeta) >= 0.05
    w, h = expt.panel.image_size
    for j, lim in ((0, w - 1), (1, w - 1), (2, h - 1), (3, h - 1)):
        bboxes[:, j] = np.clip(bboxes[:, j], 0, lim)
    delta_b = extent_mod.DEFAULT_N_SIGMA * SIGMA_B * extent_mod.DEFAULT_SIGMA_B_MULTIPLIER
    integ = kabsch_mod.KabschIntegrator(
        panel=expt.panel, beam=expt.beam, gonio=expt.goniometer, scan=expt.scan, s1=s1,
        phi=phi, bboxes=np.where(sel[:, None], bboxes, np.array([[0, -1, 0, -1, 0, -1]])),
        delta_b=delta_b, delta_m=extent_mod.DEFAULT_N_SIGMA * SIGMA_M, algorithm=algorithm,
        max_active=min(2048, max(128, (int(sel.sum()) + 127) // 128 * 128)),
    )
    acc = kabsch_mod.Accumulators.zeros(n)
    integ.integrate(reader, range(0, reader.get_number_of_images()), acc)
    return types.SimpleNamespace(expt=expt, s1=s1, xyzcal_mm=xyzcal_mm, hkl=hkl, ids=ids,
                                 phi=phi, bboxes=bboxes, zeta=cs.zeta, acc=acc)


def jax_finish(run, background, bg_device=False):
    """The JAX CLI's steps after the Kabsch step (background, finalize,
    columns) on a :func:`jax_accumulate` run."""
    expt, acc = run.expt, run.acc
    fin_mod.check_overflow(acc.bg_count, acc.bg_overflow)
    model = {"constant": "tukey", "glm": "glm", "dials": "dials"}[background]
    if bg_device and model != "dials":
        bg_mean, bg_wsum, bg_valid = (
            np.asarray(v) for v in bg_jax.estimate_background_device(
                acc.bg_hist, acc.bg_overflow, model))
    else:
        bg_mean, bg_wsum, bg_valid = bg_mod.estimate_background(
            acc.bg_hist, acc.bg_overflow, model)
    finalize = fin_mod.finalize_device if bg_device else fin_mod.finalize
    r = finalize(
        acc=acc, bg_mean=bg_mean, bg_wsum=bg_wsum, bg_valid=bg_valid, bboxes=run.bboxes,
        s1=run.s1, phi=run.phi, hkl=run.hkl, zeta=run.zeta, scan=expt.scan, beam=expt.beam,
        gonio=expt.goniometer, crystal=expt.crystal, sigma_m=SIGMA_M,
    )
    return {
        "intensity.sum.value": r.intensity,
        "intensity.sum.variance": np.where(r.variance < 0, 0.0, r.variance),
        "partiality": r.partiality,
        "miller_index": run.hkl.astype(np.int32),
        "lp": r.lp,
        "d": r.d,
        "xyzcal.mm": run.xyzcal_mm,
        "xyzobs.px.value": r.xyzobs_px,
        "s1": run.s1,
        "id": np.asarray(run.ids, np.int64),
        "num_pixels.background": acc.bg_count,
        "num_pixels.foreground": acc.fg_count,
        "background.sum.value": r.background_sum,
        "background.mean": r.background_mean,
        "flags": np.where(r.valid, np.uint64(INTEGRATED_SUM), np.uint64(0)).astype(np.uint64),
    }


def jax_columns(expt, table, reader, algorithm, background):
    """The JAX CLI's whole sequence after loading (host path)."""
    return jax_finish(jax_accumulate(expt, table, reader, algorithm), background)


def assert_columns_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for name, b in want.items():
        a = np.asarray(got[name])
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize(
    "algorithm,background,predicted",
    [("ellipsoid", "constant", True), ("dials", "glm", False)],
)
def test_core_matches_jax_sequence(collection, algorithm, background, predicted):
    c = collection
    table = c.table if predicted else {"id": c.table["id"]}
    want = jax_columns(c.expt, table, c.reader, algorithm, background)
    out = tint.integrate_experiment(
        c.texpt, table, c.reader, device=torch.device("cpu"), sigma_b=SIGMA_B,
        sigma_m=SIGMA_M, algorithm=algorithm, background=background,
    )
    assert_columns_equal(out.columns, want)
    valid = (out.columns["flags"] & np.uint64(INTEGRATED_SUM)) != 0
    assert valid.mean() > 0.9
    if predicted:
        ratio = out.columns["intensity.sum.value"][valid] / c.reader.injected[valid]
        assert np.median(ratio) > 0.7


def _write_cli_inputs(c):
    """The CLI's input files in the working directory (NeXus frames,
    ``indexed.expt``, ``predicted.refl``); returns a reader of the frames
    as written."""
    from ffs_tpu_torch.models.reflection_table import ReflectionTable

    from .util import write_nexus

    frames = c.reader.frames.astype(np.uint16)
    write_nexus("images.nxs", frames, wavelength=1.0, distance=0.12, pixel_size=0.3e-3,
                beam_center=(120.0, 130.0), oscillation=(0.0, 1.0), mask=c.reader._mask)
    c.expt.save("indexed.expt")
    table = ReflectionTable()
    for name, col in c.table.items():
        table[name] = col
    table.write("predicted.refl")

    class _Frames:
        def get_image(self, n):
            return frames[n]

        def get_mask(self):
            return c.reader._mask

        def get_number_of_images(self):
            return len(frames)

    return _Frames()


CLI_ARGS = ["-r", "predicted.refl", "-e", "indexed.expt", "-i", "images.nxs",
            "--sigma_b", repr(float(SIGMA_B)), "--sigma_m", repr(float(SIGMA_M)), "--profile"]


def test_cli_writes_the_core_columns(collection, tmp_path, monkeypatch, capsys):
    """``run()`` on NeXus frames: the JAX CLI's log lines and --profile
    stages, and an ``integrated.refl`` holding the core's columns."""
    from ffs_tpu_torch.models.reflection_table import ReflectionTable

    c = collection
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    frames = _write_cli_inputs(c)
    rc = tint.run(CLI_ARGS)
    log = capsys.readouterr().out
    assert rc == 0, log
    for line in ("Using sigma_b=", "Integrating ", "Summation integration complete",
                 "Shoebox fill over", "Saved integrated reflections to integrated.refl",
                 "Stage breakdown:"):
        assert line in log
    for stage in ("load", "sigma+predict", "bbox+setup", "kabsch", "background",
                  "finalize+write"):
        assert f"{stage:>14s}:" in log
    out = ReflectionTable.read("integrated.refl")
    want = tint.integrate_experiment(
        c.texpt, c.table, frames, device=torch.device("cpu"), sigma_b=SIGMA_B,
        sigma_m=SIGMA_M,
    ).columns
    assert_columns_equal({k: out[k] for k in want}, want)


def test_cli_bg_device_runs(collection, tmp_path, monkeypatch, capsys):
    """``--bg-device`` runs through ``run()`` (it exited 2 before the port
    had it): the same --profile stages, and the device path's columns."""
    from ffs_tpu_torch.models.reflection_table import ReflectionTable

    c = collection
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    frames = _write_cli_inputs(c)
    rc = tint.run(CLI_ARGS + ["--bg-device", "--background", "glm"])
    log = capsys.readouterr().out
    assert rc == 0, log
    for stage in ("sigma+predict", "bbox+setup", "kabsch", "background", "finalize+write"):
        assert f"{stage:>14s}:" in log
    out = ReflectionTable.read("integrated.refl")
    want = tint.integrate_experiment(
        c.texpt, c.table, frames, device=torch.device("cpu"), sigma_b=SIGMA_B,
        sigma_m=SIGMA_M, background="glm", bg_device=True,
    ).columns
    assert_columns_equal({k: out[k] for k in want}, want)


@pytest.fixture(scope="module")
def jax_bg_device_run(collection):
    c = collection
    return jax_accumulate(c.expt, c.table, c.reader, "ellipsoid", bg_device=True)


@pytest.mark.parametrize("background", ["constant", "glm", "dials"])
def test_bg_device_matches_jax_sequence(collection, jax_bg_device_run, background, capsys):
    """``--bg-device``: device bounding boxes, background and finalisation
    against the JAX CLI's device functions (one Kabsch run of theirs serves
    the three cases); ``dials`` keeps the host background with the JAX
    CLI's note."""
    c = collection
    want = jax_finish(jax_bg_device_run, background, bg_device=True)
    capsys.readouterr()
    out = tint.integrate_experiment(
        c.texpt, c.table, c.reader, device=torch.device("cpu"), sigma_b=SIGMA_B,
        sigma_m=SIGMA_M, background=background, bg_device=True,
    )
    log = capsys.readouterr().out
    assert ("note: --background dials runs on host" in log) == (background == "dials")
    assert_columns_equal(out.columns, want)
    valid = (out.columns["flags"] & np.uint64(INTEGRATED_SUM)) != 0
    assert valid.mean() > 0.9


def test_needs_a_device_or_the_cpu_flag(collection, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("FFS_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cpu"):
        tint.run(["-r", "x.refl", "-e", "x.expt", "--sample"])
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cpu"):
        tint.integrate_experiment(
            collection.texpt, collection.table, collection.reader, device=None,
            sigma_b=SIGMA_B, sigma_m=SIGMA_M,
        )
