"""SSX indexer adversarial suite on PyTorch: success-rate table over hard
cases.

Counterpart of the repo's ``tools/ssx_adversarial.py`` with the same
synthetic stills (``make_experiment``, ``lattice_spots``, ``noise_spots``,
``CELL``), cases and success floors, run through the port's SSX indexer
(:mod:`ffs_tpu_torch.indexing.ssx`).  The envelope is the one implied by the
reference's tuned ffbidx parameters (reference: src/ffs/ssx_index.py:100-113
— dist1=0.3, dist3=0.15, 32768 half-sphere points, max_spots=300): noise
spots, weak (few-spot) lattices, two interleaved lattices, positional
jitter, and partial (single-quadrant) spot lists.

Run:  python -m ffs_tpu_torch.tools.ssx_adversarial [--seeds N]
Prints one row per case: success rate, mean indexed fraction, mean rmsd.
The search runs on ``torchinit.select_device()`` (``FFS_TORCH_DEVICE=cpu``
for the CPU).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

from ..indexing.ssx import SSXIndexer
from ..models.crystal import Crystal
from ..models.geometry import simple_panel
from ..prediction.stills import predict_stills

CELL = (30.0, 40.0, 50.0, 90.0, 90.0, 90.0)
PANEL_PX = (500, 520)


def make_experiment(seed: int, cell=CELL):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    base = np.diag(cell[:3])
    vecs = base @ q.T
    crystal = Crystal(vecs[0], vecs[1], vecs[2])
    panel = simple_panel(100.0, (250.0, 260.0), (0.2, 0.2), PANEL_PX)
    wavelength = 1.1
    s0 = np.array([0.0, 0.0, -1.0 / wavelength])
    return crystal, panel, wavelength, s0, rng


def lattice_spots(crystal, panel, s0, rng, *, tol=4e-3, jitter=0.2):
    hkl = rng.integers(-15, 16, size=(20000, 3))
    hkl = np.unique(hkl[~(hkl == 0).all(axis=1)], axis=0)
    A = crystal.a_matrix
    q = hkl @ A.T
    d_es = np.abs(np.linalg.norm(q + s0, axis=1) - np.linalg.norm(s0))
    hkl = hkl[d_es < tol]
    pred = predict_stills(hkl, s0, A, panel)
    x, y = pred["xyzcal_px"][:, 0], pred["xyzcal_px"][:, 1]
    ok = (x > 5) & (x < PANEL_PX[0] - 5) & (y > 5) & (y < PANEL_PX[1] - 5)
    obs = np.stack([x[ok], y[ok], np.zeros(ok.sum())], axis=1)
    obs[:, :2] += rng.normal(0, jitter, size=(len(obs), 2))
    return obs


def noise_spots(rng, n):
    return np.stack(
        [
            rng.uniform(5, PANEL_PX[0] - 5, n),
            rng.uniform(5, PANEL_PX[1] - 5, n),
            np.zeros(n),
        ],
        axis=1,
    )


@dataclass
class CaseResult:
    success: bool
    frac_indexed: float
    rmsd_xy: float


def run_case(case: str, seed: int) -> CaseResult:
    """One case at one seed through the port's indexer (the device search)."""
    crystal, panel, wavelength, s0, rng = make_experiment(seed)
    obs = lattice_spots(crystal, panel, s0, rng)
    n_lattice = len(obs)
    if n_lattice < 12:
        return CaseResult(True, 1.0, 0.0)  # degenerate geometry; skip

    if case == "clean":
        pass
    elif case == "noise30":
        obs = np.concatenate([obs, noise_spots(rng, int(0.3 * n_lattice))])
    elif case == "noise60":
        obs = np.concatenate([obs, noise_spots(rng, int(0.6 * n_lattice))])
    elif case == "weak12":
        obs = obs[rng.permutation(n_lattice)[:12]]
        n_lattice = 12
    elif case == "jitter":
        obs[:, :2] += rng.normal(0, 0.5, size=(len(obs), 2))
    elif case == "quadrant":
        sel = (obs[:, 0] < PANEL_PX[0] / 2) & (obs[:, 1] < PANEL_PX[1] / 2)
        if sel.sum() < 10:
            return CaseResult(True, 1.0, 0.0)
        obs = obs[sel]
        n_lattice = len(obs)
    elif case == "two_lattice":
        crystal2, _, _, _, _ = make_experiment(seed + 1000)
        obs2 = lattice_spots(crystal2, panel, s0, rng)
        obs = np.concatenate([obs, obs2])
        rng.shuffle(obs, axis=0)
        n_lattice = max(n_lattice, len(obs2))
    else:
        raise ValueError(case)

    indexer = SSXIndexer(min_spots=10)
    indexer.panel = panel
    indexer.cell = CELL
    indexer.wavelength = wavelength
    result, _ = indexer.index(obs)
    if result is None:
        return CaseResult(False, 0.0, np.inf)

    got = sorted(result.cell_parameters[:3])
    cell_ok = all(
        abs(g - w) / w < 0.03 for g, w in zip(got, sorted(CELL[:3]))
    )
    n_indexed = len(result.delpsi)
    rmsd = float(np.hypot(result.rmsds[0], result.rmsds[1])) if result.rmsds else np.inf
    floor = {
        "clean": 0.7,
        "noise30": 0.6,
        "noise60": 0.5,
        "weak12": 0.5,
        "jitter": 0.5,
        "quadrant": 0.5,
        "two_lattice": 0.4,
    }[case]
    success = bool(
        cell_ok and n_indexed >= floor * n_lattice and rmsd < 1.5
    )
    return CaseResult(success, n_indexed / max(n_lattice, 1), rmsd)


CASES = [
    "clean",
    "noise30",
    "noise60",
    "weak12",
    "jitter",
    "quadrant",
    "two_lattice",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--cases", nargs="*", default=CASES)
    args = ap.parse_args()

    print(f"{'case':<12} {'success':>8} {'frac_idx':>9} {'rmsd_xy':>8}")
    for case in args.cases:
        results = [run_case(case, 5 + s) for s in range(args.seeds)]
        rate = np.mean([r.success for r in results])
        frac = np.mean([r.frac_indexed for r in results])
        rmsds = [r.rmsd_xy for r in results if np.isfinite(r.rmsd_xy)]
        rmsd = np.mean(rmsds) if rmsds else np.inf
        print(f"{case:<12} {rate:>8.2f} {frac:>9.2f} {rmsd:>8.3f}")


if __name__ == "__main__":
    main()
