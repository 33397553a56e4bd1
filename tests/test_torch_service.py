"""The port's service layer on the CPU: the PIA service (ffs_tpu_torch.
service.pia), its per-line indexing hook (service.pipe_index) and the
ssx_index_torch CLI, against ffs_tpu's where both run.

The PIA service finds its spotfinder through FFS_TORCH_SPOTFINDER /
FFS_TORCH_SPOTFINDER_32BIT.  The end-to-end test points them at wrapper
scripts that run the port's spotfinder in-process on the CPU over the
sample frames (the request's file name stands in for ``--sample``); the
hook tests use a stand-in spotfinder that writes given pipe lines, so that
ffs_tpu's own service and the port's index the same spot centres.

Tolerances: lattices within 1e-4 relative (cells) and 1e-3 (rmsds), with
equal indexed and unindexed counts, as in tests/test_torch_ssx.py.
"""

import json
import os
import sys
import textwrap

import numpy as np
import pytest

from ffs_tpu_torch.models.crystal import Crystal
from ffs_tpu_torch.models.geometry import simple_panel
from ffs_tpu_torch.prediction.stills import predict_stills
from ffs_tpu_torch.service import pia as tpia
from ffs_tpu_torch.service.pipe_index import index_pipe_payload

from .test_service import FakeRecipeWrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = (40.0, 50.0, 60.0, 90.0, 90.0, 90.0)
WAVELENGTH = 0.976
DISTANCE = 150.0
BEAM_PX = (2074.0, 2181.0)  # Eiger 16M centre


def pia_still(seed: int, tol: float = 2.5e-3) -> np.ndarray:
    """A seeded still of CELL at the PIA request's Eiger 16M geometry
    (~150-200 spots, 0.3 px centroid noise)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    vecs = np.diag(CELL[:3]) @ q.T
    crystal = Crystal(vecs[0], vecs[1], vecs[2])
    panel = simple_panel(DISTANCE, BEAM_PX, (0.075, 0.075), (4148, 4362))
    s0 = np.array([0.0, 0.0, -1.0 / WAVELENGTH])
    hkl = rng.integers(-25, 26, size=(40000, 3))
    hkl = np.unique(hkl[~(hkl == 0).all(axis=1)], axis=0)
    qv = hkl @ crystal.a_matrix.T
    near = np.abs(np.linalg.norm(qv + s0, axis=1) - np.linalg.norm(s0)) < tol
    pred = predict_stills(hkl[near], s0, crystal.a_matrix, panel)
    x, y = pred["xyzcal_px"][:, 0], pred["xyzcal_px"][:, 1]
    ok = (x > 5) & (x < 4143) & (y > 5) & (y < 4357)
    obs = np.stack([x[ok], y[ok], np.zeros(ok.sum())], axis=1)
    obs[:, :2] += rng.normal(0, 0.3, size=(len(obs), 2))
    return obs


def _request(**extra):
    params = {
        "dcid": 100, "dcgid": 7, "filename": "sample", "message_index": 0,
        "number_of_frames": 3, "start_frame_index": 0,
        "xBeam": BEAM_PX[0] * 0.075, "yBeam": BEAM_PX[1] * 0.075,
        "detector_distance": DISTANCE, "wavelength": WAVELENGTH,
    }
    params.update(extra)
    return params


def _script(path, body: str) -> str:
    path.write_text(f"#!{sys.executable}\n" + textwrap.dedent(body))
    path.chmod(0o755)
    return str(path)


@pytest.fixture()
def port_spotfinder_env(tmp_path, monkeypatch):
    """spotfinder_torch / spotfinder32_torch stand-ins: the port's CLI on the
    CPU over the sample frames."""
    body = """
        import os, sys
        os.environ["FFS_TORCH_DEVICE"] = "cpu"
        sys.path.insert(0, {repo!r})
        from ffs_tpu_torch.pipeline.spotfinder import run
        args = sys.argv[1:]
        if args and not args[0].startswith("-"):  # the request's file: the sample frames
            args = ["--sample", *args[1:]]
        sys.exit(run(args, default_pixel_depth={depth}))
    """
    bindir = tmp_path / "bin"
    bindir.mkdir()
    sf = _script(bindir / "spotfinder_torch", body.format(repo=REPO, depth=16))
    sf32 = _script(bindir / "spotfinder32_torch", body.format(repo=REPO, depth=32))
    monkeypatch.setenv("FFS_TORCH_SPOTFINDER", sf)
    monkeypatch.setenv("FFS_TORCH_SPOTFINDER_32BIT", sf32)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    return sf, sf32


def _fake_spotfinders(tmp_path, monkeypatch, lines, exit16=0):
    """Stand-in spotfinders that write ``lines`` to --pipe_fd (the 16-bit
    one exits ``exit16`` first, writing nothing when that is 32), for both
    packages' services."""
    data = tmp_path / "lines.json"
    data.write_text(json.dumps(lines))
    body = """
        import json, os, sys
        argv = sys.argv[1:]
        if "--list-devices" in argv:
            print("0: stand-in")
            sys.exit(0)
        if {exit16} == 32 and not {is32}:
            sys.exit(32)
        fd = int(argv[argv.index("--pipe_fd") + 1])
        with os.fdopen(fd, "w") as pipe:
            for line in json.load(open({data!r})):
                line["argv"] = argv
                line["bits"] = 32 if {is32} else 16
                pipe.write(json.dumps(line) + "\\n")
    """
    bindir = tmp_path / "fake"
    bindir.mkdir()
    sf = _script(bindir / "sf", body.format(exit16=exit16, is32=False, data=str(data)))
    sf32 = _script(bindir / "sf32", body.format(exit16=exit16, is32=True, data=str(data)))
    for env, path in (("FFS_TORCH_SPOTFINDER", sf), ("FFS_TORCH_SPOTFINDER_32BIT", sf32),
                      ("SPOTFINDER", sf), ("SPOTFINDER_32BIT", sf32)):
        monkeypatch.setenv(env, path)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")


def _still_lines():
    lines = []
    for k, seed in enumerate((1, 2)):
        obs = pia_still(seed)
        lines.append({"file-number": k, "num_strong_pixels": 5 * len(obs),
                      "spot_centers": [float(v) for v in obs.reshape(-1)]})
    lines.append({"file-number": 2, "num_strong_pixels": 3, "spot_centers": [1.0, 2.0, 0.0]})
    lines.append({"file-number": 3, "num_strong_pixels": 0})
    return lines


def _assert_lattices_match(got: dict, want: dict):
    assert got.keys() == want.keys()
    if "lattices" not in want:  # a line without centres passes unchanged
        assert got == want
        return
    assert got["n_unindexed"] == want["n_unindexed"]
    assert len(got["lattices"]) == len(want["lattices"])
    for lt, lj in zip(got["lattices"], want["lattices"]):
        assert lt["space_group"] == lj["space_group"] == "P1"
        assert lt["n_indexed"] == lj["n_indexed"]
        np.testing.assert_allclose(lt["unit_cell"], lj["unit_cell"], rtol=1e-4)
        np.testing.assert_allclose(lt["rmsds"], lj["rmsds"], rtol=1e-3)


def test_port_pia_service_end_to_end_on_sample_frames(tmp_path, monkeypatch,
                                                      port_spotfinder_env):
    """The port's service launches spotfinder_torch on three sample frames
    with the indexer armed: every line comes back 1-based, with the strong
    pixel count and the indexer's keys."""
    monkeypatch.chdir(tmp_path)
    service = tpia.PiaService(threads=2)
    rw = FakeRecipeWrapper(_request(unit_cell="40 50 60 90 90 90"))
    service.handle(rw, {}, {}, base_path=str(tmp_path / "absent"))
    assert rw.transport.acked
    assert [ch for ch, _ in rw.sent] == ["result"] * 3
    sent = sorted((d for _, d in rw.sent), key=lambda d: d["file-number"])
    assert [d["file-number"] for d in sent] == [1, 2, 3]  # 1-based for XRC
    assert [d["num_strong_pixels"] for d in sent] == [0, 0, 9506]
    for d in sent:
        assert "spot_centers" not in d
        assert d["lattices"] == [] and isinstance(d["n_unindexed"], int)


def test_port_pia_stale_message_with_timezone_aware_start_time(tmp_path, port_spotfinder_env):
    """Counterpart of test_service.py's stale-message test, with the service
    built inside the spotfinder fixture: an aware, ancient startTime is
    acked and dropped, with no TypeError."""
    service = tpia.PiaService(threads=1, with_indexer=False)
    rw = FakeRecipeWrapper({
        "dcid": 9, "dcgid": 3, "filename": "missing.nxs",
        "message_index": 0, "number_of_frames": 1, "start_frame_index": 0,
        "xBeam": 1.0, "yBeam": 1.0, "detector_distance": 100.0,
        "startTime": "2020-01-01T00:00:00Z",
    })
    service.handle(rw, {}, {"m": 1}, base_path=str(tmp_path))
    assert rw.transport.acked and not rw.sent


def test_port_pia_rejects_bad_request_and_requeues(tmp_path, monkeypatch):
    _fake_spotfinders(tmp_path, monkeypatch, [])
    service = tpia.PiaService(threads=1, with_indexer=False)
    bad = FakeRecipeWrapper({"dcid": 5})
    service.handle(bad, {}, {})
    assert bad.transport.nacked and not bad.sent
    late = FakeRecipeWrapper(_request(message_index=5))
    service.handle(late, {}, {"m": 1}, base_path="/nonexistent")
    assert late.transport.acked and late.checkpoints and not late.sent


def test_port_pia_relaunches_32bit_on_exit_32(tmp_path, monkeypatch):
    _fake_spotfinders(tmp_path, monkeypatch, [{"file-number": 0, "num_strong_pixels": 1}],
                      exit16=32)
    service = tpia.PiaService(threads=1, with_indexer=False)
    rw = FakeRecipeWrapper(_request(number_of_frames=1))
    service.handle(rw, {}, {}, base_path="/nonexistent")
    assert len(rw.sent) == 1
    sent = rw.sent[0][1]
    assert sent["bits"] == 32 and sent["file-number"] == 1
    assert "--output-for-index" not in sent["argv"]  # no unit cell: indexer not armed


def test_hook_matches_jax_service(tmp_path, monkeypatch):
    """ffs_tpu's service and the port's index the same pipe lines (two
    seeded stills, a line with too few spots, a line without centres) and
    send the same lattices; index_pipe_payload alone gives the same."""
    from ffs_tpu.service import pia as jpia

    lines = _still_lines()
    _fake_spotfinders(tmp_path, monkeypatch, lines)
    request = _request(number_of_frames=len(lines), unit_cell=list(CELL))
    out = {}
    for name, service in (("jax", jpia.PiaService(threads=1)),
                          ("torch", tpia.PiaService(threads=1))):
        rw = FakeRecipeWrapper(dict(request))
        service.handle(rw, {}, {}, base_path="/nonexistent")
        assert "--output-for-index" in rw.sent[0][1]["argv"]
        out[name] = sorted((d for _, d in rw.sent), key=lambda d: d["file-number"])
        indexer = service.indexer
    assert len(out["jax"]) == len(out["torch"]) == len(lines)
    for dt, dj in zip(out["torch"], out["jax"]):
        dt.pop("file-seen-at"), dj.pop("file-seen-at")
        _assert_lattices_match(dt, dj)
    assert [len(d["lattices"]) for d in out["torch"][:2]] == [1, 1]
    assert out["torch"][2]["lattices"] == [] and out["torch"][2]["n_unindexed"] == 1
    assert "lattices" not in out["torch"][3]

    # the hook alone, on the service's armed indexer
    for line, dj in zip(lines, out["jax"]):
        got = index_pipe_payload(indexer, dict(line))
        want = {k: v for k, v in dj.items() if k not in ("argv", "bits")}
        got["file-number"] += 1
        _assert_lattices_match(got, want)


def test_hook_failure_raises():
    class Broken:
        def index(self, xyz):
            raise RuntimeError("device score failed")

    with pytest.raises(RuntimeError, match="device score failed"):
        index_pipe_payload(Broken(), {"spot_centers": [1.0, 2.0, 0.0] * 20})
    line = {"file-number": 0}
    assert index_pipe_payload(Broken(), line) is line


def test_find_spotfinder_needs_the_ports_scripts(monkeypatch, tmp_path):
    monkeypatch.delenv("FFS_TORCH_SPOTFINDER", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="FFS_TORCH_SPOTFINDER"):
        tpia.find_spotfinder()


def test_zocalo_entry_point_attribute_is_lazy():
    try:
        import workflows  # noqa: F401

        assert tpia.TorchPerImageAnalysis.__name__ == "TorchPerImageAnalysis"
    except ImportError:
        with pytest.raises(ImportError):
            tpia.TorchPerImageAnalysis
    with pytest.raises(AttributeError):
        tpia.NoSuchService


def test_detectors_is_a_copy():
    with open(os.path.join(REPO, "ffs_tpu", "service", "detectors.py")) as f:
        theirs = f.read()
    with open(os.path.join(REPO, "ffs_tpu_torch", "service", "detectors.py")) as f:
        assert f.read() == theirs


def _ssx_cli_inputs(root):
    """tests/test_ssx_cli.py's inputs: two stills, strong.refl, imported.expt."""
    import h5py

    from .test_ssx import _still_experiment, _synthetic_still_spots

    root.mkdir()
    all_xyz, all_ids, identifiers = [], [], []
    for img, seed in enumerate((5, 12)):
        crystal, panel, wavelength, s0, rng = _still_experiment(seed=seed)
        obs, _ = _synthetic_still_spots(crystal, panel, wavelength, s0, rng)
        all_xyz.append(obs)
        all_ids.append(np.full(len(obs), img, dtype=np.int64))
        identifiers.append(f"uuid-{img}")
    with h5py.File(root / "strong.refl", "w") as f:
        g = f.create_group("dials/processing/group_0")
        g["xyzobs.px.value"] = np.concatenate(all_xyz)
        g["id"] = np.concatenate(all_ids)
        g.attrs["experiment_ids"] = np.arange(2, dtype=np.uint64)
        g.attrs["identifiers"] = identifiers
    expt = {
        "beam": [{"wavelength": 1.1, "direction": [0, 0, 1]}],
        "detector": [{
            "hierarchy": {"origin": [0.0, 0.0, 0.0]},
            "panels": [{
                "origin": [-50.0, 52.0, -100.0], "pixel_size": [0.2, 0.2],
                "image_size": [500, 520], "thickness": 0.45, "mu": 0.0,
                "fast_axis": [1, 0, 0], "slow_axis": [0, -1, 0],
            }],
        }],
        "experiment": [{"identifier": "uuid-0"}, {"identifier": "uuid-1"}],
    }
    (root / "imported.expt").write_text(json.dumps(expt))


def _run_ssx_cli(run, root, capsys):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run(["-r", "strong.refl", "-e", "imported.expt", "-c", "30", "40", "50", "90", "90", "90"])
    finally:
        os.chdir(cwd)
    log = capsys.readouterr().out.splitlines()
    return [line for line in log if not line.startswith(("Indexed 2/2", "Setup time"))], log


def test_ssx_index_cli_matches_jax(tmp_path, monkeypatch, capsys):
    import h5py

    from ffs_tpu.service import ssx_index as jcli
    from ffs_tpu_torch.service import ssx_index as tcli

    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    for name in ("jax", "torch"):
        _ssx_cli_inputs(tmp_path / name)
    log_j, _ = _run_ssx_cli(jcli.run, tmp_path / "jax", capsys)
    log_t, full_t = _run_ssx_cli(tcli.run, tmp_path / "torch", capsys)
    assert any(line.startswith("Indexed 2/2 non-empty images") for line in full_t)
    assert log_t == log_j  # per-image lines: counts, cells to 1e-3, rmsds

    out = {}
    for name in ("jax", "torch"):
        with h5py.File(tmp_path / name / "indexed.refl") as f:
            g = f["dials/processing/group_0"]
            out[name] = ({k: g[k][()] for k in g}, dict(g.attrs))
        out[name] += (json.loads((tmp_path / name / "indexed.expt").read_text()),)
    (cols_j, attrs_j, expt_j), (cols_t, attrs_t, expt_t) = out["jax"], out["torch"]
    assert cols_t.keys() == cols_j.keys()
    for key in ("id", "image", "miller_index", "panel"):
        np.testing.assert_array_equal(cols_t[key], cols_j[key])
    for key in ("xyzobs.px.value", "xyzcal.px", "s1", "delpsical.rad"):
        np.testing.assert_allclose(cols_t[key], cols_j[key], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(attrs_t["experiment_ids"], attrs_j["experiment_ids"])
    assert list(attrs_t["identifiers"]) == list(attrs_j["identifiers"])
    assert len(expt_t["crystal"]) == len(expt_j["crystal"]) == 2
    for ct, cj in zip(expt_t["crystal"], expt_j["crystal"]):
        for axis in ("real_space_a", "real_space_b", "real_space_c"):
            np.testing.assert_allclose(ct[axis], cj[axis], rtol=1e-4, atol=1e-4)
    assert [e.get("crystal") for e in expt_t["experiment"]] == [0, 1]


def test_ssx_index_core_needs_no_h5py(monkeypatch, capsys):
    """The per-image loop takes arrays and an armed indexer."""
    from ffs_tpu_torch.indexing.ssx import SSXIndexer
    from ffs_tpu_torch.service.ssx_index import IndexedCollection, index_strong_spots

    from .test_ssx import _still_experiment, _synthetic_still_spots

    monkeypatch.setitem(sys.modules, "h5py", None)
    crystal, panel, wavelength, s0, rng = _still_experiment(seed=5)
    obs, _ = _synthetic_still_spots(crystal, panel, wavelength, s0, rng)
    xyzs = np.concatenate([obs, obs[:4], np.zeros((3, 3))])
    ids = np.concatenate([np.zeros(len(obs), int), np.ones(4, int), np.full(3, 2)])
    indexer = SSXIndexer(device="cpu")
    indexer.panel, indexer.cell, indexer.wavelength = panel, (30.0, 40.0, 50.0, 90, 90, 90), wavelength
    collection = IndexedCollection({0: "a", 1: "b", 2: "c"})
    counts = index_strong_spots(indexer, xyzs, ids, 10, collection)
    assert counts == (1, 1, 2)  # image 2 is empty, image 1 has too few spots
    assert collection.crystal_image_numbers == [0]
    assert "Indexed" in capsys.readouterr().out
