"""Rotation-indexer robustness campaign on PyTorch.

    python -m ffs_tpu_torch.tools.indexer_robustness [--seeds N] [--cases ...] [--markdown]

Counterpart of the repo's ``tools/indexer_robustness.py`` with the same
``CASES``, knobs, draws and floors.  Each case builds a synthetic rotation
experiment from a known crystal (symmetry, orientation), predicts the
observed spot centroids over the scan (:func:`..indexing.predict.
predict_scan_static`), and corrupts them as the case says: centroid noise,
uniform outlier spots, a second interleaved lattice, a truncated spot list.
The whole rotation indexer (FFT on the device, flood fill, candidate basis
search, scoring with refinement, macro cycles) must recover the true cell
edges within 1%.  The draws from ``np.random.default_rng(seed)`` come in the
JAX tool's order, so a seed gives the same observations bit for bit.

Where h5py is installed the indexer runs as its CLI does
(:func:`..pipeline.indexer.run` on ``strong.refl`` and ``imported.expt`` in
a temporary directory, ``indexed.expt`` read back); without h5py (the
card's machine) the CLI's own cores (:func:`..pipeline.indexer.
index_experiment`, then :func:`..pipeline.indexer.indexed_reflections`) take
the table in memory.  The first line says which route ran.  The FFT runs on
``torchinit.select_device()`` (``FFS_TORCH_DEVICE=cpu`` for the CPU).

Prints ``case: wins/seeds`` and the case's seconds, with ``--markdown`` a
table.  Exit code 0 = every case at or above its floor: every seed indexes,
except in ``outliers_40pct`` and ``second_lattice``, which may miss one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

CASES = {
    # name: corruption knobs (every case shares the base experiment)
    "clean_ortho": dict(),
    "noisy_centroids": dict(noise_px=0.6),
    "outliers_20pct": dict(outlier_frac=0.20),
    "outliers_40pct": dict(outlier_frac=0.40),
    "second_lattice": dict(second_lattice_frac=0.5),
    "truncated_25pct": dict(keep_frac=0.25),
    "monoclinic_beta": dict(cell=(55.0, 65.0, 75.0, 90.0, 103.0, 90.0)),
    "triclinic": dict(cell=(52.0, 61.0, 73.0, 84.0, 97.0, 92.0)),
}
DEFAULT_CELL = (60.0, 70.0, 80.0, 90.0, 90.0, 90.0)
SECOND_CELL = (48.0, 59.0, 67.0, 90.0, 90.0, 90.0)
# the two hardest cases may miss one seed (as the SSX suite's floors do)
SLACK = frozenset({"outliers_40pct", "second_lattice"})
# the JAX tool's indexer flags, as the CLI's arguments and as its options
INDEX_OPTIONS = {"max_cell": 100.0, "max_refine": 12, "macro_cycles": 2}
INDEX_ARGS = [x for k, v in INDEX_OPTIONS.items() for x in (f"--{k.replace('_', '-')}", str(v))]
CELL_RTOL = 0.01


def _cell_matrix(cell):
    """Real-space cell vectors (rows) from parameters (a, b, c, al, be, ga)."""
    a, b, c, al, be, ga = cell
    al, be, ga = np.deg2rad([al, be, ga])
    va = np.array([a, 0.0, 0.0])
    vb = np.array([b * np.cos(ga), b * np.sin(ga), 0.0])
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    return np.stack([va, vb, np.array([cx, cy, cz])])


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _predict_observed(crystal, beam, gonio, panel, rng, n_hkl=12000):
    """Centroids (mm, mm, rad) of random hkl over the first 50 degrees."""
    from ..indexing.predict import predict_scan_static

    hkl = rng.integers(-25, 26, size=(n_hkl, 3))
    hkl = np.unique(hkl[~(hkl == 0).all(axis=1)], axis=0)
    d_matrix = np.stack([panel.fast_axis, panel.slow_axis, panel.origin], axis=1)
    kw = dict(
        s0=beam.s0,
        fixed_rotation=gonio.fixed_rotation,
        setting_rotation=gonio.setting_rotation,
        rotation_axis=gonio.rotation_axis,
        ub=crystal.a_matrix,
        d_matrix=d_matrix,
    )
    phi_seed = rng.uniform(0.0, np.deg2rad(50.0), size=len(hkl))
    pred = predict_scan_static(hkl, np.zeros(len(hkl), bool), phi_seed, **kw)
    s0_m2 = np.cross(beam.s0, gonio.setting_rotation @ gonio.rotation_axis)
    s0_m2 /= np.linalg.norm(s0_m2)
    entering = (pred["s1"] @ s0_m2) < 0
    pred = predict_scan_static(hkl, entering, phi_seed, **kw)
    xyz = pred["xyzcal_mm"]
    ok = pred["valid"]
    ok &= (xyz[:, 0] > 2) & (xyz[:, 0] < 98) & (xyz[:, 1] > 2) & (xyz[:, 1] < 102)
    phi_deg = np.degrees(xyz[:, 2])
    ok &= (phi_deg >= 0.0) & (phi_deg < 50.0)
    return xyz[ok]


def case_observations(name: str, seed: int):
    """The case's imported experiment (no crystal), its strong spots'
    ``xyzobs.px.value`` and the true cell."""
    from ..models.crystal import Crystal
    from ..models.experiment import Experiment
    from ..models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    knobs = CASES[name]
    rng = np.random.default_rng(seed)
    cell = knobs.get("cell", DEFAULT_CELL)
    vecs = _cell_matrix(cell) @ _random_rotation(rng).T
    crystal = Crystal(vecs[0], vecs[1], vecs[2])
    beam = MonochromaticBeam(wavelength=1.0)
    gonio = Goniometer()
    scan = Scan(image_range=(1, 100), oscillation=(0.0, 0.5))
    panel = simple_panel(
        distance_mm=150.0,
        beam_center_px=(500.0, 520.0),
        pixel_size_mm=(0.1, 0.1),
        image_size=(1000, 1040),
    )
    expt = Experiment(beam, panel, gonio, scan)

    xyz = _predict_observed(crystal, beam, gonio, panel, rng)
    if "second_lattice_frac" in knobs:
        vecs2 = _cell_matrix(SECOND_CELL) @ _random_rotation(rng).T
        xyz2 = _predict_observed(Crystal(vecs2[0], vecs2[1], vecs2[2]), beam, gonio, panel, rng)
        n2 = int(len(xyz) * knobs["second_lattice_frac"])
        xyz = np.concatenate([xyz, xyz2[rng.permutation(len(xyz2))[:n2]]])
    if "keep_frac" in knobs:
        xyz = xyz[rng.random(len(xyz)) < knobs["keep_frac"]]

    obs = np.stack([xyz[:, 0] / 0.1, xyz[:, 1] / 0.1, np.degrees(xyz[:, 2]) / 0.5], axis=1)
    obs[:, :2] += rng.normal(0, knobs.get("noise_px", 0.1), (len(obs), 2))

    if "outlier_frac" in knobs:
        n_out = int(len(obs) * knobs["outlier_frac"])
        junk = np.stack(
            [rng.uniform(20, 980, n_out), rng.uniform(20, 1020, n_out), rng.uniform(0, 99, n_out)],
            axis=1,
        )
        obs = np.concatenate([obs, junk])
    return expt, obs, cell


def has_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def route() -> str:
    if has_h5py():
        return "files: pipeline.indexer.run on strong.refl and imported.expt"
    return "in memory (no h5py): pipeline.indexer.index_experiment and indexed_reflections"


def _index_with_files(expt, obs) -> tuple | None:
    """The CLI on files in a temporary directory -> the indexed cell."""
    from ..models.crystal import Crystal
    from ..models.reflection_table import STRONG, ReflectionTable
    from ..pipeline import indexer

    with tempfile.TemporaryDirectory() as d:
        table = ReflectionTable()
        table["xyzobs.px.value"] = obs
        table["flags"] = np.full(len(obs), STRONG, dtype=np.uint64)
        table.write(os.path.join(d, "strong.refl"))
        expt.save(os.path.join(d, "imported.expt"))
        cwd = os.getcwd()
        try:
            os.chdir(d)
            rc = indexer.run(["-e", "imported.expt", "-r", "strong.refl", *INDEX_ARGS])
            if rc != 0 or not os.path.exists("indexed.expt"):
                return None
            with open("indexed.expt") as f:
                out = json.load(f)
        finally:
            os.chdir(cwd)
    return Crystal.from_json(out["crystal"][0]).unit_cell


def _index_in_memory(expt, obs) -> tuple | None:
    """The CLI's cores on the table in memory -> the indexed cell."""
    from ..models.reflection_table import STRONG
    from ..pipeline.indexer import IndexOptions, index_experiment, indexed_reflections

    outcome = index_experiment(expt, obs, IndexOptions(**INDEX_OPTIONS))
    if outcome is None:
        return None
    indexed_reflections(outcome.expt, obs, np.full(len(obs), STRONG, dtype=np.uint64))
    return outcome.expt.crystal.unit_cell


def index_cell(expt, obs) -> tuple | None:
    """The indexed unit cell, or None where the indexer found no crystal."""
    return (_index_with_files if has_h5py() else _index_in_memory)(expt, obs)


def cell_ok(got, want) -> bool:
    """The cell edges, sorted, each within 1% of the truth's."""
    return all(abs(g - w) / w < CELL_RTOL for g, w in zip(sorted(got[:3]), sorted(want[:3])))


def run_case(name: str, seed: int, verbose: bool = False) -> bool:
    expt, obs, cell = case_observations(name, seed)
    got = index_cell(expt, obs)
    if got is None:
        if verbose:
            print(f"  {name}/{seed}: no crystal")
        return False
    ok = cell_ok(got, cell)
    if verbose and not ok:
        print(f"  {name}/{seed}: got {sorted(got[:3])} want {sorted(cell[:3])}")
    return ok


def floor(name: str, seeds: int) -> int:
    return seeds - 1 if name in SLACK else seeds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    unknown = [c for c in args.cases if c not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}; known: {list(CASES)}")

    print(f"route: {route()}", flush=True)
    rows = []
    for name in args.cases:
        t0 = time.perf_counter()
        wins = sum(run_case(name, seed, verbose=True) for seed in range(args.seeds))
        seconds = time.perf_counter() - t0
        rows.append((name, wins, args.seeds, seconds))
        print(f"{name}: {wins}/{args.seeds} ({seconds:.1f} s)", flush=True)
    if args.markdown:
        print("\n| case | indexed | seconds |")
        print("|---|---|---|")
        for name, wins, n, seconds in rows:
            print(f"| {name} | {wins}/{n} | {seconds:.1f} |")
    short = 0
    for name, wins, n, _ in rows:
        if wins < floor(name, n):
            print(f"FAIL: {name} below floor {floor(name, n)}/{n}")
            short += 1
    return 1 if short else 0


if __name__ == "__main__":
    sys.exit(main())
