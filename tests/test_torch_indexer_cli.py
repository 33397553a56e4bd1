"""baseline_indexer_torch against baseline_indexer on the synthetic rotation
experiment of tests/test_indexer_cli.py (a 60 x 70 x 80 A orthorhombic
crystal over 50 degrees), both in-process on the CPU.

Tolerances: the candidate vectors within 1e-9 (absolute, in A; both FFTs
run in float64 and the flood fill and peak search are the same NumPy
code), the indexed cell within 1e-6 relative (the float64 refinements
differ only in the order of their floating-point operations).
"""

import json
import os

import numpy as np
import pytest

from ffs_tpu.models.crystal import Crystal
from ffs_tpu.models.reflection_table import ReflectionTable

from .test_indexer_cli import synthetic_experiment  # noqa: F401  (fixture)

ARGS = ["--max-cell", "100", "--max-refine", "12", "--macro-cycles", "2", "--test"]


def _run_in(path, run, argv):
    path.mkdir()
    cwd = os.getcwd()
    os.chdir(path)
    try:
        rc = run(argv)
        with open("candidate_vectors.json") as f:
            vectors = json.load(f)
        with open("indexed.expt") as f:
            cell = Crystal.from_json(json.load(f)["crystal"][0]).unit_cell
        table = ReflectionTable.read("indexed.refl")
    finally:
        os.chdir(cwd)
    return rc, vectors, np.asarray(cell), table


def test_indexer_cli_matches_jax(synthetic_experiment, tmp_path, monkeypatch, capsys):  # noqa: F811
    from ffs_tpu.pipeline import indexer as jax_indexer
    from ffs_tpu_torch.pipeline import indexer as torch_indexer

    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    expt_path, refl_path, truth, n_obs = synthetic_experiment
    argv = ["-e", str(expt_path), "-r", str(refl_path), *ARGS]

    rc_j, vec_j, cell_j, table_j = _run_in(tmp_path / "jax", jax_indexer.run, argv)
    log_j = capsys.readouterr().out
    rc_t, vec_t, cell_t, table_t = _run_in(tmp_path / "torch", torch_indexer.run, argv)
    log_t = capsys.readouterr().out

    assert rc_j == rc_t == 0
    assert sorted(vec_t) == sorted(vec_j)
    for key in vec_j:
        np.testing.assert_allclose(vec_t[key], vec_j[key], rtol=0, atol=1e-9)
    np.testing.assert_allclose(cell_t, cell_j, rtol=1e-6)
    assert sorted(cell_t[:3]) == pytest.approx(sorted(truth.unit_cell[:3]), rel=0.01)

    # same prints (numbers formatted to the CLI's own precision)
    assert log_t.splitlines() == log_j.splitlines()
    # same indexed.refl columns
    assert table_t.column_names() == table_j.column_names()
    np.testing.assert_array_equal(table_t["miller_index"], table_j["miller_index"])
    np.testing.assert_array_equal(table_t["flags"], table_j["flags"])
    np.testing.assert_allclose(table_t["xyzcal.mm"], table_j["xyzcal.mm"], rtol=1e-6, atol=1e-9)


def test_indexer_core_needs_no_files(synthetic_experiment, tmp_path, monkeypatch):  # noqa: F811
    """The core takes the experiment and the spot centres, writes nothing
    without --test and returns the refined models and the output columns."""
    from ffs_tpu_torch.models.experiment import Experiment
    from ffs_tpu_torch.pipeline.indexer import IndexOptions, index_experiment, indexed_reflections

    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    expt_path, refl_path, truth, n_obs = synthetic_experiment
    expt = Experiment.load(str(expt_path))
    xyz = ReflectionTable.read(str(refl_path))["xyzobs.px.value"]
    work = tmp_path / "core"
    work.mkdir()
    monkeypatch.chdir(work)
    outcome = index_experiment(expt, xyz, IndexOptions(max_cell=100.0, max_refine=12,
                                                       macro_cycles=2))
    assert outcome is not None and os.listdir(work) == []
    cell = outcome.expt.crystal.unit_cell
    assert sorted(cell[:3]) == pytest.approx(sorted(truth.unit_cell[:3]), rel=0.01)
    cols = indexed_reflections(outcome.expt, xyz)
    assert cols["n_indexed"] > 0.8 * n_obs
    assert cols["miller_index"].shape == (n_obs, 3)
