"""ffs_tpu_torch.prediction.rotation against ffs_tpu's pure-float64 host
predictor (``use_device=False``): the same hkl set in the same order, with
s1 and the calculated positions within 1e-12 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ffs_tpu.models.crystal import Crystal
from ffs_tpu.models.experiment import Experiment
from ffs_tpu.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel
from ffs_tpu.prediction import rotation as jrot
from ffs_tpu_torch.models.experiment import experiment_from_state
from ffs_tpu_torch.prediction import rotation as trot

CPU = torch.device("cpu")


def _experiments(**crystal_kw):
    expt = Experiment(
        beam=MonochromaticBeam(wavelength=1.0),
        panel=simple_panel(120.0, (120.0, 130.0), (0.3, 0.3), (240, 260)),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, 12), oscillation=(0.0, 1.0)),
        crystal=Crystal([40.0, 0, 0], [0, 50.0, 0], [0, 0, 60.0], **crystal_kw),
    )
    parts = ("beam", "panel", "goniometer", "scan", "crystal")
    texpt = experiment_from_state({k: dataclasses.asdict(getattr(expt, k)) for k in parts})
    return expt, texpt


def _assert_same(got, want):
    assert len(want.hkl) > 10
    np.testing.assert_array_equal(got.hkl, want.hkl)
    for name in ("panel", "entering", "flags"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("s1", "xyzcal_px", "xyzcal_mm"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-12,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("dmin", [4.0, None])
def test_predict_rotation_matches_jax(dmin):
    expt, texpt = _experiments()
    want = jrot.predict_rotation(expt, dmin=dmin, use_device=False)
    # a small hkl chunk: the chunked search must give the same rows in order
    got = trot.predict_rotation(texpt, dmin=dmin, device=CPU, chunk=1000)
    _assert_same(got, want)


def test_scan_varying_prediction_matches_jax():
    """Per-image setting matrices and beams from the expt JSON's scan
    points, and a space group with systematic absences."""
    expt, texpt = _experiments(space_group=" P 2ac 2ab")
    n = 12
    rng = np.random.default_rng(11)
    a = expt.crystal.a_matrix
    a_sp = np.stack([a @ (np.eye(3) + 1e-3 * rng.normal(size=(3, 3))) for _ in range(n + 1)])
    s0_sp = np.stack([expt.beam.s0 + 1e-4 * rng.normal(size=3) for _ in range(n + 1)])
    elist = {
        "crystal": [{"A_at_scan_points": a_sp.reshape(n + 1, 9).tolist()}],
        "beam": [{"s0_at_scan_points": s0_sp.tolist()}],
    }
    sv_j = jrot.parse_scan_varying(elist, n)
    sv_t = trot.parse_scan_varying(elist, n)
    assert sv_t and np.array_equal(sv_t.a_at_scan_points, sv_j.a_at_scan_points)
    want = jrot.predict_rotation(expt, sv_j, dmin=4.0, use_device=False)
    got = trot.predict_rotation(texpt, sv_t, dmin=4.0, device=CPU)
    _assert_same(got, want)


def test_hkl_grid_matches_jax():
    expt, _ = _experiments()
    from ffs_tpu.models.symmetry import group_ops_from_symbol as jops
    from ffs_tpu_torch.models.symmetry import group_ops_from_symbol as tops

    a = expt.crystal.a_matrix
    for symbol in ("P 1", " P 2ac 2ab", " C 2c 2"):
        np.testing.assert_array_equal(
            trot.hkl_grid(a, 3.0, tops(symbol)), jrot.hkl_grid(a, 3.0, jops(symbol))
        )
