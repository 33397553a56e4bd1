"""The port's rotation-indexer robustness campaign
(``python -m ffs_tpu_torch.tools.indexer_robustness``) against the repo's
``tools/indexer_robustness.py`` on the CPU.

(a) every case at seed 7: the observations the port's tool hands its
    indexer equal the JAX tool's bit for bit (both tools predict with the
    same NumPy ``predict_scan_static``, so any difference is a fault of the
    draw order), and so does the imported experiment;
(b) ``clean_ortho`` and ``second_lattice`` at seed 7 (outside the
    campaign's seeds 0-4, as tests/test_indexer_robust.py takes them) index
    through the port to the tool's 1% gate;
(c) ``main()``'s floors and exit code, with ``run_case`` stubbed.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from ffs_tpu_torch.tools import indexer_robustness as tool

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import indexer_robustness as jax_tool  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def jax_observations(name, seed, monkeypatch):
    """What the JAX tool writes for its indexer (``strong.refl``'s
    observations and ``imported.expt``), caught in place of the indexer."""
    from ffs_tpu.models.reflection_table import ReflectionTable
    from ffs_tpu.pipeline import indexer

    caught = {}

    def catch(argv):
        caught["obs"] = np.asarray(ReflectionTable.read("strong.refl")["xyzobs.px.value"])
        with open("imported.expt") as f:
            caught["expt"] = json.load(f)
        return 1  # the tool counts the seed as a miss and goes on

    monkeypatch.setattr(indexer, "run", catch)
    assert jax_tool.run_case(name, seed) is False
    return caught["obs"], caught["expt"]


@pytest.mark.parametrize("case", list(jax_tool.CASES))
def test_observations_equal_the_jax_tool(case, monkeypatch, tmp_path):
    assert tool.CASES[case] == jax_tool.CASES[case]
    want_obs, want_expt = jax_observations(case, 7, monkeypatch)
    expt, obs, cell = tool.case_observations(case, 7)
    assert obs.dtype == want_obs.dtype and obs.shape == want_obs.shape
    assert obs.tobytes() == want_obs.tobytes()
    assert cell == jax_tool.CASES[case].get("cell", tool.DEFAULT_CELL)
    expt.save(str(tmp_path / "imported.expt"))
    got_expt = json.loads((tmp_path / "imported.expt").read_text())
    for doc in (got_expt, want_expt):  # a fresh uuid each save
        for e in doc["experiment"]:
            e.pop("identifier", None)
    assert got_expt == want_expt


@pytest.mark.parametrize(
    "case,files", [("clean_ortho", True), ("second_lattice", False)], ids=["files", "in-memory"]
)
def test_case_indexes_through_the_port(case, files, monkeypatch, capsys):
    """clean_ortho through the CLI on files (h5py is installed here),
    second_lattice through the cores in memory, the route of a machine
    without h5py."""
    if not files:
        monkeypatch.setattr(tool, "has_h5py", lambda: False)
    assert tool.route().startswith("files" if files else "in memory")
    ok = tool.run_case(case, 7, verbose=True)
    log = capsys.readouterr().out
    assert ok, log
    assert ("Saved experiment list to indexed.expt" in log) == files
    assert "Indexed " in log and "using the refined models" in log


@pytest.mark.parametrize(
    "misses,rc",
    [
        ({}, 0),
        ({"outliers_40pct": {3}, "second_lattice": {0}}, 0),  # one miss each: at the floor
        ({"second_lattice": {0, 1}}, 1),  # two misses: below
        ({"clean_ortho": {4}}, 1),  # no slack
        ({"triclinic": {2}}, 1),
    ],
)
def test_main_floors(misses, rc, monkeypatch, capsys):
    calls = []

    def stub(name, seed, verbose=False):
        calls.append((name, seed))
        return seed not in misses.get(name, ())

    monkeypatch.setattr(tool, "run_case", stub)
    assert tool.main(["--seeds", "5", "--markdown"]) == rc
    out = capsys.readouterr().out
    assert calls == [(name, s) for name in tool.CASES for s in range(5)]
    for name in tool.CASES:
        wins = 5 - len(misses.get(name, ()))
        assert f"{name}: {wins}/5 (" in out and f"| {name} | {wins}/5 |" in out
    assert out.count("FAIL:") == (0 if rc == 0 else len(misses))
    assert out.splitlines()[0].startswith("route: ")


def test_main_rejects_an_unknown_case(capsys):
    with pytest.raises(SystemExit):
        tool.main(["--cases", "no_such_case"])
    assert "unknown cases ['no_such_case']" in capsys.readouterr().err
