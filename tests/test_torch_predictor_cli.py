"""The port's predictor CLI (``baseline_predictor_torch``) on the DIALS
thaumatin golden of tests/test_predict_dials_golden.py, against the JAX
package's CLI column for column, and on the JAX CLI's three error exits."""

import copy
import json

import h5py
import numpy as np
import pytest

from ffs_tpu.pipeline import predictor as jpredictor
from ffs_tpu_torch.pipeline import predictor as tpredictor

from .test_predict_dials_golden import (
    _A_AT_SCAN_POINTS,
    _EXPECTED_HKL,
    _EXPECTED_STATIC,
    _EXPECTED_SV,
    _thaumatin_expt,
)

GROUP = "/dials/processing/group_0"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _write(tmp_path, expt_obj, name="test.expt"):
    path = tmp_path / name
    path.write_text(json.dumps(expt_obj))
    return str(path)


def _read(path):
    with h5py.File(path, "r") as f:
        g = f[GROUP]
        return {k: g[k][()] for k in g}, dict(g.attrs)


def _scan_varying():
    expt = _thaumatin_expt()
    expt["crystal"][0]["A_at_scan_points"] = _A_AT_SCAN_POINTS
    return expt


@pytest.mark.parametrize("scan_varying,count,expected", [
    (False, 464, _EXPECTED_STATIC), (True, 451, _EXPECTED_SV)])
def test_thaumatin_golden(tmp_path, capsys, scan_varying, count, expected):
    expt = _scan_varying() if scan_varying else _thaumatin_expt()
    out = str(tmp_path / "predicted.refl")
    assert tpredictor.run(["-e", _write(tmp_path, expt), "--output", out]) == 0
    log = capsys.readouterr().out
    assert f"Predicted {count} reflections" in log and f"Saved predicted reflections to {out}" in log
    cols, _ = _read(out)
    hkl, xyz = cols["miller_index"].reshape(-1, 3), cols["xyzcal.px"].reshape(-1, 3)
    assert len(hkl) == count
    for want_hkl, want_xyz in zip(_EXPECTED_HKL, expected):
        sel = np.all(hkl == want_hkl, axis=1)
        assert sel.sum() == 1
        assert xyz[sel].flatten() == pytest.approx(want_xyz, abs=1e-2)


# alpha, where in its image a ray crosses, is a root of a quadratic that
# amplifies the ulps of its coefficients (3-term products reduced in
# another order) to ~1e-11 of an image: an absolute floor on the frame
# coordinate (frames) and on the angle (that times 0.1 degree in radians)
ANGLE_ATOL = {"xyzcal.px": 1e-11, "xyzcal.mm": 1e-14}
# the JAX package's device-against-host tolerances (tests/test_prediction.py::
# test_device_block_prediction_matches_host), absolute
BLOCKED_ATOL = {"s1": 1e-12, "xyzcal.px": 1e-9, "xyzcal.mm": 1e-9}


def _assert_columns(got, want, tol):
    """Every column, in order: floats within ``tol(name)`` (rtol, atol),
    the rest equal."""
    assert list(got) == list(want)
    assert len(want["miller_index"]) > 50
    for name, b in want.items():
        a = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if np.issubdtype(b.dtype, np.floating):
            rtol, atol = tol(name)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("argv", [[], ["--force_static", "-b", "2", "--dmin", "2.5"]])
@pytest.mark.parametrize("scan_varying", [False, True])
def test_predicted_refl_matches_the_jax_cli(tmp_path, monkeypatch, argv, scan_varying):
    """Column for column, row for row, against the JAX CLI's default run
    (both on the blocked search: the same rows in the same order, within
    the JAX package's own device-against-host tolerances), and against its
    pure-float64 search with the port's (``use_device=False`` on both
    sides: floats within 1e-12 relative, angles above ANGLE_ATOL)."""
    import functools

    from ffs_tpu.prediction import rotation as jrot
    from ffs_tpu_torch.prediction import rotation as trot

    if scan_varying and "-b" in argv:
        argv = ["--force_static", "--dmin", "2.5"]
    expt = _write(tmp_path, _scan_varying() if scan_varying else _thaumatin_expt())
    paths = {k: str(tmp_path / f"{k}.refl") for k in ("port", "jax", "port_f64", "jax_f64")}
    assert tpredictor.run(["-e", expt, "--output", paths["port"], *argv]) == 0
    assert jpredictor.run(["-e", expt, "--output", paths["jax"], *argv]) == 0
    for rot, cli, name in ((jrot, jpredictor, "jax_f64"), (trot, tpredictor, "port_f64")):
        monkeypatch.setattr(rot, "predict_rotation",
                            functools.partial(rot.predict_rotation, use_device=False))
        assert cli.run(["-e", expt, "--output", paths[name], *argv]) == 0
    (got, got_attrs), (want, want_attrs) = _read(paths["port"]), _read(paths["jax"])
    _assert_columns(got, want, lambda name: (0.0, BLOCKED_ATOL[name]))
    _assert_columns(_read(paths["port_f64"])[0], _read(paths["jax_f64"])[0],
                    lambda name: (1e-12, ANGLE_ATOL.get(name, 0.0)))
    for attrs in (want_attrs, _read(paths["jax_f64"])[1]):
        assert list(got_attrs["identifiers"]) == list(attrs["identifiers"])
        np.testing.assert_array_equal(got_attrs["experiment_ids"], attrs["experiment_ids"])


def _no_crystal():
    expt = copy.deepcopy(_thaumatin_expt())
    expt["crystal"] = []
    return expt


@pytest.mark.parametrize("expt_fn,argv,message", [
    (_thaumatin_expt, ["-b", "-1"], "Error: buffer_size must be >= 0"),
    (_no_crystal, [], "Error: experiment has no crystal model"),
    (_scan_varying, ["-b", "1"],
     "Error: Can't call predict function with scan varying data and an image buffer."),
])
def test_error_exits_match_the_jax_cli(tmp_path, capsys, expt_fn, argv, message):
    expt = _write(tmp_path, expt_fn())
    out = str(tmp_path / "never.refl")
    for cli in (jpredictor, tpredictor):
        assert cli.run(["-e", expt, "--output", out, *argv]) == 1
        assert capsys.readouterr().out.strip() == message
    assert not (tmp_path / "never.refl").exists()
