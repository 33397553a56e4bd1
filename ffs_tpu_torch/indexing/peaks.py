"""FFT peaks -> candidate reciprocal-lattice (real-space basis) vectors.

Equivalent of the reference peaks_to_rlvs (reference:
baseline/indexer/peaks_to_rlvs.cc:64-186): fractional COMs > 0.5 wrap
negative, scale by n * d_min / 2 to Cartesian, filter by length, group by
length (10%) and angle (5 deg) merging inverse pairs, reject approximate
integer multiples of larger-volume vectors, sort by peak volume.
"""

from __future__ import annotations

import numpy as np


def _angle_deg(v1, v2):
    c = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def is_approximate_integer_multiple(
    v1, v2, relative_length_tolerance=0.2, angular_tolerance=5.0
):
    angle = _angle_deg(v1, v2)
    if angle < angular_tolerance or abs(180 - angle) < angular_tolerance:
        l1, l2 = np.linalg.norm(v1), np.linalg.norm(v2)
        if l1 > l2:
            l1, l2 = l2, l1
        n = l2 / l1
        if abs(round(n) - n) < relative_length_tolerance:
            return True
    return False


def peaks_to_rlvs(
    centres_of_mass_frac: np.ndarray,
    grid_points_per_void: np.ndarray,
    d_min: float,
    min_cell: float = 3.0,
    max_cell: float = 92.3,
    n_points: int = 256,
) -> list[np.ndarray]:
    """Returns unique candidate basis vectors, sorted by peak volume desc."""
    fft_cell_length = n_points * d_min / 2.0
    coms = np.asarray(centres_of_mass_frac, dtype=np.float64).copy()
    coms = np.where(coms > 0.5, coms - 1.0, coms) * fft_cell_length

    lengths = np.linalg.norm(coms, axis=1) if len(coms) else np.zeros(0)
    keep = (lengths > min_cell) & (lengths < 2 * max_cell)
    sites = coms[keep]
    vols = np.asarray(grid_points_per_void)[keep]

    # group by length/angle, merging inverse pairs
    groups: list[dict] = []  # {'vectors': [...], 'weights': [...]}
    for site, vol in zip(sites, vols):
        length = np.linalg.norm(site)
        matched = False
        for g in groups:
            mean_v = np.mean(g["vectors"], axis=0)
            mean_len = np.linalg.norm(mean_v)
            if abs(mean_len - length) / max(mean_len, length) < 0.1:
                angle = _angle_deg(mean_v, site)
                if angle < 5.0:
                    g["vectors"].append(site)
                    g["weights"].append(vol)
                    matched = True
                    break
                elif abs(180 - angle) < 5.0:
                    g["vectors"].append(-site)
                    g["weights"].append(vol)
                    matched = True
                    break
        if not matched:
            groups.append({"vectors": [site], "weights": [vol]})

    grouped = []
    for g in groups:
        v = np.mean(g["vectors"], axis=0)
        grouped.append((v, np.linalg.norm(v), int(max(g["weights"]))))

    # stable sort: by volume desc then by length asc (primary)
    grouped.sort(key=lambda t: -t[2])
    grouped.sort(key=lambda t: t[1])

    unique: list[tuple] = []
    for v, length, vol in grouped:
        ok = True
        for uv, ul, uvol in unique:
            if uvol <= vol:
                continue
            if is_approximate_integer_multiple(uv, v):
                ok = False
                break
        if ok:
            unique.append((v, length, vol))

    unique.sort(key=lambda t: -t[2])
    return [u[0] for u in unique]
