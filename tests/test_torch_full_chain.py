"""The beamline chain on the port: frames -> spotfinder -> indexer ->
integrator through the three CLIs and their handoff files, against the
ground truth and against ``ffs_tpu``'s CLIs on the same files (CPU).

The fixture is tests/test_full_chain.py's: a 280 x 280 panel, 32 images of
1 degree, a 28 x 32 x 36 A crystal, seed 11, Poisson(5) frames with a
Gaussian spot at each prediction, written by ``tests.util.write_nexus``.
The port's CLIs run on the CPU (``FFS_TORCH_DEVICE=cpu``; the spotfinder
in a process of its own, the indexer and integrator in this one) through real
``results_ffs.h5``, ``indexed.expt`` / ``indexed.refl`` and
``integrated.refl`` files, under the JAX test's ground-truth gates: 90% of
the injected spots found, the cell edges within 7e-3 and the angles within
0.5 degree, 70% integrated, intensities correlated above 0.95 with a
median relative error below 0.2.

``ffs_tpu``'s CLIs run on the same files, in the same way:
  * its spotfinder on the same NeXus: the count log lines and every column
    of ``results_ffs.h5`` equal (tests/test_torch_spotfinder_cli.py's
    comparison);
  * its indexer on the port's ``results_ffs.h5``: the cell within 1e-6
    relative and the Miller indices equal (tests/test_torch_indexer_cli.py);
  * its integrator on the port's ``indexed.expt`` / ``indexed.refl``: every
    column of ``integrated.refl``, integers exactly and floats within 1e-12
    relative (tests/test_torch_integrator.py).

Both indexers run with ``--max-refine 12 --macro-cycles 2`` beside the JAX
test's ``--max-cell 45`` (as tests/test_torch_indexer_cli.py and the
robustness tool run them): at the defaults the JAX CLI spends over a
minute compiling the refinement for 50 candidates, for the same cell.
"""

import contextlib
import io
import os
import types

import numpy as np
import pytest

from .test_full_chain import DIST_MM, HW, N_IMG, PIX_MM, WL, _make_experiment, _render_frames
from .test_torch_integrator import assert_columns_equal
from .test_torch_spotfinder_cli import _cli, _count_lines, _h5
from .util import write_nexus

INDEX_ARGS = ["--max-cell", "45", "--max-refine", "12", "--macro-cycles", "2"]


def _in(path, fn, argv):
    """``fn(argv)`` with ``path`` as the working directory -> its stdout."""
    path.mkdir(exist_ok=True)
    cwd = os.getcwd()
    buf = io.StringIO()
    os.chdir(path)
    try:
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
    finally:
        os.chdir(cwd)
    log = buf.getvalue()
    assert rc == 0, log[-4000:]
    return log


def _table(path):
    from ffs_tpu_torch.models.reflection_table import ReflectionTable

    t = ReflectionTable.read(str(path))
    return {name: np.asarray(t[name]) for name in t.column_names()}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The fixture's files, then both packages' CLIs on them."""
    from ffs_tpu.pipeline import indexer as j_indexer
    from ffs_tpu.pipeline import integrator as j_integrator
    from ffs_tpu.prediction.rotation import predict_rotation
    from ffs_tpu_torch.pipeline import indexer as t_indexer
    from ffs_tpu_torch.pipeline import integrator as t_integrator

    d = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(11)
    truth = _make_experiment(with_crystal=True)
    pred = predict_rotation(truth, dmin=3.5, use_device=False)
    x, y, z = pred.xyzcal_px.T
    keep = (
        (x > 15) & (x < HW - 15) & (y > 15) & (y < HW - 15)
        & (z > 4.0) & (z < N_IMG - 5.0)
    )
    P = types.SimpleNamespace(xyzcal_px=pred.xyzcal_px[keep])
    assert len(P.xyzcal_px) > 100, "fixture must give a real spot list"
    frames, injected = _render_frames(P, rng)
    nxs = d / "images.nxs"
    write_nexus(nxs, frames, wavelength=WL, distance=DIST_MM / 1000.0,
                pixel_size=PIX_MM / 1000.0, beam_center=(HW / 2.0, HW / 2.0),
                oscillation=(0.0, 1.0))
    imported = d / "imported.expt"
    _make_experiment(with_crystal=False).save(str(imported))

    mp = pytest.MonkeyPatch()
    mp.setenv("FFS_TORCH_DEVICE", "cpu")
    try:
        t, j = d / "torch", d / "jax"
        logs = {}
        for key, package, cwd in (("t_spot", "ffs_tpu_torch", t), ("j_spot", "ffs_tpu", j)):
            # a process each: the CLI's reader threads share HDF5's state
            cwd.mkdir()
            proc, _ = _cli(package, [str(nxs), "--threads", "2", "--save-h5"], cwd)
            logs[key] = proc.stdout.decode()
            assert proc.returncode == 0, logs[key][-4000:] + proc.stderr.decode()[-4000:]
        strong = str(t / "results_ffs.h5")
        logs["t_index"] = _in(t, t_indexer.run, ["-e", str(imported), "-r", strong, *INDEX_ARGS])
        logs["j_index"] = _in(j, j_indexer.run, ["-e", str(imported), "-r", strong, *INDEX_ARGS])
        integ_args = ["-r", str(t / "indexed.refl"), "-e", str(t / "indexed.expt"),
                      "-i", str(nxs)]
        logs["t_integ"] = _in(t, t_integrator.run, integ_args)
        logs["j_integ"] = _in(j, j_integrator.run, integ_args)
    finally:
        mp.undo()
    return types.SimpleNamespace(dir=d, P=P, injected=injected, logs=logs)


def test_spotfinder_finds_the_injected_spots_as_ffs_tpu_does(chain):
    t, j = chain.dir / "torch", chain.dir / "jax"
    assert "Device: cpu" in chain.logs["t_spot"]
    assert "Successfully wrote 3D reflections to HDF5 file" in chain.logs["t_spot"]
    # the strong table under tests/test_torch_spotfinder_cli.py's comparison
    counts = _count_lines(chain.logs["t_spot"])
    assert counts == _count_lines(chain.logs["j_spot"])
    assert sum("finished image" in ln for ln in counts) == N_IMG
    (t_h5, t_ids), (j_h5, j_ids) = _h5(t / "results_ffs.h5"), _h5(j / "results_ffs.h5")
    assert t_ids == j_ids and sorted(t_h5) == sorted(j_h5)
    for name, want in j_h5.items():
        np.testing.assert_array_equal(t_h5[name], want, err_msg=name)

    obs = t_h5["xyzobs.px.value"]
    xyz = chain.P.xyzcal_px
    d = np.linalg.norm(obs[:, None, :2] - xyz[None, :, :2], axis=-1)
    dz = np.abs(obs[:, None, 2] - xyz[None, :, 2])
    matched = ((d < 1.5) & (dz < 1.0)).any(axis=0)
    assert matched.mean() > 0.9, f"only {matched.sum()}/{len(matched)} injected spots found"


def test_indexer_recovers_the_cell_as_ffs_tpu_does(chain):
    from ffs_tpu.models.experiment import Experiment as JExperiment
    from ffs_tpu_torch.models.experiment import Experiment

    t, j = chain.dir / "torch", chain.dir / "jax"
    for log in (chain.logs["t_index"], chain.logs["j_index"]):
        assert "Saved experiment list to indexed.expt" in log
    got = np.array(Experiment.load(str(t / "indexed.expt")).crystal.unit_cell)
    np.testing.assert_allclose(np.sort(got[:3]), (28.0, 32.0, 36.0), rtol=7e-3)
    np.testing.assert_allclose(got[3:], 90.0, atol=0.5)
    want = np.array(JExperiment.load(str(j / "indexed.expt")).crystal.unit_cell)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    t_refl, j_refl = _table(t / "indexed.refl"), _table(j / "indexed.refl")
    assert sorted(t_refl) == sorted(j_refl)
    np.testing.assert_array_equal(t_refl["miller_index"], j_refl["miller_index"])
    np.testing.assert_array_equal(t_refl["flags"], j_refl["flags"])


def test_integrator_recovers_the_intensities_as_ffs_tpu_does(chain):
    from ffs_tpu_torch.models.reflection_table import INTEGRATED_SUM

    t, j = chain.dir / "torch", chain.dir / "jax"
    assert "Saved integrated reflections to integrated.refl" in chain.logs["t_integ"]
    out, want = _table(t / "integrated.refl"), _table(j / "integrated.refl")
    assert_columns_equal(out, want)

    valid = (out["flags"] & np.uint64(INTEGRATED_SUM)) != 0
    inten = out["intensity.sum.value"]
    xyz = out["xyzobs.px.value"]
    P = chain.P
    # match by the observed centroid the integrator measured (the JAX test's gates)
    dxy = np.linalg.norm(xyz[:, None, :2] - P.xyzcal_px[None, :, :2], axis=-1)
    dzz = np.abs(xyz[:, None, 2] - P.xyzcal_px[None, :, 2])
    cand = (dxy < 2.0) & (dzz < 1.5) & valid[:, None]
    rows = cand.any(axis=0)
    pick = np.where(cand, dxy, np.inf).argmin(axis=0)
    got_i = inten[pick[rows]]
    want_i = chain.injected[rows]
    assert rows.mean() > 0.7, f"only {rows.sum()}/{len(rows)} integrated"
    r = np.corrcoef(got_i, want_i)[0, 1]
    assert r > 0.95, f"intensity correlation {r}"
    rel = np.abs(got_i - want_i) / want_i
    assert np.median(rel) < 0.2, f"median rel err {np.median(rel)}"
