"""The port's rotation-indexing modules against ffs_tpu on the CPU.

* The DIALS goldens of tests/test_indexer_dials_golden.py and
  tests/test_refine_dials_golden.py, rerun on the port's functions: each
  golden test of those files is called with the names it uses bound to the
  port's counterparts (the compose functions, ``torch.func.jacfwd`` for
  ``jax.jacfwd``, float64 tensors for ``jnp.asarray``), so the same numbers
  are asserted at the same tolerances (1e-12; 1e-10 where the JAX test has
  it).  A call counter proves the port's functions ran.
* ``fft3d`` against ffs_tpu's: rtol 1e-12, with an absolute floor of 1e-12
  of the grid's peak for the entries that cancel to ~0 (they have no
  relative precision in either package).
* ``refine_candidate`` against ffs_tpu's on a noisy self-consistent
  geometry: the refined cell and rmsds within 1e-9 relative (float64 LM
  on both sides; only the order of operations differs).
* The framework-free modules are copies of ffs_tpu's, line for line.
"""

import functools
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ffs_tpu_torch.indexing.assign as t_assign
import ffs_tpu_torch.indexing.combinations as t_comb
import ffs_tpu_torch.indexing.fft3d as t_fft
import ffs_tpu_torch.indexing.flood_fill as t_ff
import ffs_tpu_torch.indexing.gradients_oracle as t_oracle
import ffs_tpu_torch.indexing.peaks as t_peaks
import ffs_tpu_torch.indexing.predict as t_predict
import ffs_tpu_torch.indexing.refine as t_refine
import ffs_tpu_torch.indexing.rlp as t_rlp
import ffs_tpu_torch.models.crystal as t_crystal
import ffs_tpu_torch.models.geometry as t_geometry

from . import test_indexer_dials_golden as golden_idx
from . import test_refine_dials_golden as golden_ref

REPO = pathlib.Path(__file__).resolve().parent.parent


class _Calls:
    """Counts calls of the port functions bound into a golden test."""

    def __init__(self):
        self.n = 0

    def wrap(self, fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            self.n += 1
            return fn(*a, **k)

        return inner


INDEXER_GOLDENS = [
    "test_xyz_to_rlp_dials_values",
    "test_map_centroids_to_grid_dials_values",
    "test_flood_fill_dials_values",
    "test_flood_fill_filter_dials_values",
    "test_peaks_to_rlvs_dials_values",
    "test_assign_indices_dials_values",
    "test_combinations_dials_values",
]


@pytest.mark.parametrize("name", INDEXER_GOLDENS)
def test_port_indexer_dials_golden(name, monkeypatch):
    calls = _Calls()
    port = {
        "assign_indices_global": t_assign.assign_indices_global,
        "candidate_orientation_matrices": t_comb.candidate_orientation_matrices,
        "map_centroids_to_grid": t_fft.map_centroids_to_grid,
        "flood_fill": t_ff.flood_fill,
        "flood_fill_filter": t_ff.flood_fill_filter,
        "peaks_to_rlvs": t_peaks.peaks_to_rlvs,
        "xyz_to_rlp": t_rlp.xyz_to_rlp,
    }
    for attr, fn in port.items():
        monkeypatch.setattr(golden_idx, attr, calls.wrap(fn))
    for attr in ("Goniometer", "MonochromaticBeam", "Panel", "Scan"):
        monkeypatch.setattr(golden_idx, attr, getattr(t_geometry, attr))
    getattr(golden_idx, name)()
    assert calls.n > 0


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


# jax / jax.numpy as the refine goldens use them, on PyTorch
TORCH_JNP = SimpleNamespace(asarray=_f64, stack=lambda xs, axis=0: torch.stack(xs, dim=axis))
TORCH_JAX = SimpleNamespace(jacfwd=torch.func.jacfwd)

REFINE_GOLDENS = [
    "test_beam_parameterisation_golden",
    "test_orientation_parameterisation_golden",
    "test_cell_parameterisation_golden",
    "test_detector_parameterisation_golden",
    "test_gradients_calculator_golden",
    "test_autodiff_jacobian_matches_dials_gradients",
]


@pytest.mark.parametrize("name", REFINE_GOLDENS)
def test_port_refine_dials_golden(name, monkeypatch):
    """Two goldens import from ffs_tpu inside the function (make_setup,
    _residual_fn, the predictor, the gradients oracle, the geometry
    models); those module attributes are bound to the port's for the
    test's duration too."""
    import ffs_tpu.indexing.gradients_oracle
    import ffs_tpu.indexing.predict
    import ffs_tpu.indexing.refine
    import ffs_tpu.models.geometry

    calls = _Calls()
    monkeypatch.setattr(golden_ref, "jax", TORCH_JAX)
    monkeypatch.setattr(golden_ref, "jnp", TORCH_JNP)
    monkeypatch.setattr(golden_ref, "Crystal", t_crystal.Crystal)
    for attr in ("compose_beam", "compose_orientation", "compose_detector",
                 "b_matrix_from_metric", "metric_from_b"):
        monkeypatch.setattr(golden_ref, attr, calls.wrap(getattr(t_refine, attr)))
    for attr in ("make_setup", "_residual_fn"):
        monkeypatch.setattr(ffs_tpu.indexing.refine, attr, calls.wrap(getattr(t_refine, attr)))
    monkeypatch.setattr(ffs_tpu.indexing.predict, "predict_scan_static",
                        t_predict.predict_scan_static)
    monkeypatch.setattr(ffs_tpu.indexing.gradients_oracle, "scan_static_gradients",
                        t_oracle.scan_static_gradients)
    for attr in ("Goniometer", "MonochromaticBeam", "Panel", "simple_panel"):
        monkeypatch.setattr(ffs_tpu.models.geometry, attr, getattr(t_geometry, attr))
    getattr(golden_ref, name)()
    assert calls.n > 0


@pytest.mark.parametrize("n", [32, 64])
def test_fft3d_matches_jax(n):
    from ffs_tpu.indexing import fft3d as j_fft

    rng = np.random.default_rng(n)
    rlp = rng.normal(0.0, 0.15, size=(2000, 3))
    b_iso = t_fft.b_iso_from_d_min(2.0)
    want, used_j = j_fft.fft3d(rlp, 2.0, b_iso, n)
    got, used_t = t_fft.fft3d(rlp, 2.0, b_iso, n, device="cpu")
    np.testing.assert_array_equal(used_t, used_j)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * want.max())
    host, _ = t_fft.fft3d(rlp, 2.0, b_iso, n, use_device=False)
    np.testing.assert_allclose(host, want, rtol=1e-12, atol=1e-12 * want.max())


def test_fft3d_device_failure_raises(monkeypatch):
    """No NumPy fallback behind the device transform."""

    def broken(grid):
        raise RuntimeError("device transform failed")

    monkeypatch.setattr(t_fft, "fft_power", broken)
    rlp = np.random.default_rng(0).normal(0.0, 0.15, size=(100, 3))
    with pytest.raises(RuntimeError, match="device transform failed"):
        t_fft.fft3d(rlp, 2.0, 0.0, 16, device="cpu")


def _noisy_rotation_case():
    """The autodiff golden's geometry with 0.05 mm/rad observation noise."""
    from ffs_tpu.indexing.predict import predict_scan_static
    from ffs_tpu.models.crystal import Crystal
    from ffs_tpu.models.geometry import Goniometer, MonochromaticBeam, simple_panel

    crystal = Crystal(np.array([20.0, 1.0, 0.0]), np.array([-1.0, 28.0, 0.5]),
                      np.array([0.2, -0.3, 35.0]))
    beam = MonochromaticBeam(wavelength=1.0)
    gonio = Goniometer(fixed_rotation=golden_ref.F_GRADIENTS_GOLDEN)
    panel = simple_panel(distance_mm=80.0, beam_center_px=(200.0, 220.0),
                         pixel_size_mm=(0.25, 0.25), image_size=(400, 440))
    rng = np.random.default_rng(3)
    hkl = rng.integers(-12, 13, size=(200, 3))
    hkl = hkl[~(hkl == 0).all(axis=1)]
    d_matrix = np.stack([panel.fast_axis, panel.slow_axis, panel.origin], axis=1)
    phi0 = rng.uniform(0.05, 1.0, size=len(hkl))
    kw = dict(s0=beam.s0, fixed_rotation=gonio.fixed_rotation,
              setting_rotation=gonio.setting_rotation, rotation_axis=gonio.rotation_axis,
              ub=crystal.a_matrix, d_matrix=d_matrix)
    pred = predict_scan_static(hkl, np.zeros(len(hkl), dtype=bool), phi0, **kw)
    s0_m2 = np.cross(beam.s0, gonio.setting_rotation @ gonio.rotation_axis)
    entering = pred["s1"] @ (s0_m2 / np.linalg.norm(s0_m2)) < 0
    pred = predict_scan_static(hkl, entering, phi0, **kw)
    ok = pred["valid"]
    xyz = pred["xyzcal_mm"] + rng.normal(0.0, 0.05, pred["xyzcal_mm"].shape)
    return crystal, beam, panel, gonio, hkl[ok], entering[ok], xyz[ok]


def test_refine_candidate_matches_jax():
    from ffs_tpu.indexing.refine import refine_candidate as j_refine

    case = _noisy_rotation_case()
    c_j, s0_j, frame_j, rmsd_j = j_refine(*case)
    c_t, s0_t, frame_t, rmsd_t = t_refine.refine_candidate(*case)
    np.testing.assert_allclose(c_t.unit_cell, c_j.unit_cell, rtol=1e-9)
    np.testing.assert_allclose(rmsd_t, rmsd_j, rtol=1e-9)
    np.testing.assert_allclose(s0_t, s0_j, rtol=1e-9)
    for a, b in zip(frame_t, frame_j):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_refine_runs_jacobians_from_threads():
    """The indexer scores candidates on a thread pool: concurrent
    refinements (forward-mode AD in each) give the serial result."""
    from concurrent.futures import ThreadPoolExecutor

    case = _noisy_rotation_case()
    serial = t_refine.refine_candidate(*case)[3]
    with ThreadPoolExecutor(4) as ex:
        results = list(ex.map(lambda _: t_refine.refine_candidate(*case)[3], range(4)))
    for r in results:
        np.testing.assert_array_equal(r, serial)


COPIES = [
    "utils/mt19937.py", "prediction/stills.py", "indexing/assign.py", "indexing/rlp.py",
    "indexing/predict.py", "indexing/combinations.py", "indexing/flood_fill.py",
    "indexing/peaks.py", "indexing/filter.py", "indexing/lm.py", "indexing/non_primitive.py",
    "indexing/score.py", "indexing/gradients_oracle.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_framework_free_copy_matches_ffs_tpu(rel):
    """Relative imports make each copy resolve to the port's modules
    (score.py's ``.refine`` is the port's torch refinement)."""
    ours = (REPO / "ffs_tpu_torch" / rel).read_text()
    theirs = (REPO / "ffs_tpu" / rel).read_text()
    assert ours == theirs
